"""Checkpoint: a directory-of-files abstraction (port of
``ray_tpu/train/_checkpoint.py``).

Parity: ``python/ray/train/_checkpoint.py`` — ``Checkpoint.from_directory``
/ ``to_directory`` / ``as_directory``; storage via filesystem paths
(``_internal/storage.py``). Model state (a ``build_lm_train_step`` state, a
pytree of tensors) goes into the directory through
``ray_tpu_torch.train.torch_utils.save_pytree`` / ``load_pytree``.

``to_uri``/``from_uri`` speak the checkpoint plane's commit protocol
(``ray_tpu_torch._private.external_storage``): uploads end with a manifest plus an
atomic ``COMMIT`` marker, and restores of committed prefixes are
digest-verified and cached by manifest digest, so repeated restores of
one committed checkpoint share one local copy.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import tempfile
import uuid
from typing import Optional

_CACHE_DIRNAME = "ray_tpu_torch_ckpt_cache"
_CACHE_DONE = ".complete"


def _cache_root() -> str:
    return os.path.join(tempfile.gettempdir(), _CACHE_DIRNAME)


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_uri(cls, uri: str, *, allow_uncommitted: bool = False) -> "Checkpoint":
        """Materialize a checkpoint from external storage (parity:
        ``Checkpoint.from_uri``).

        Committed prefixes (manifest + COMMIT marker) restore through the
        verified path — every file checked against its manifest size and
        sha256 — into a cache slot keyed by the manifest digest, so
        repeated restores of one committed checkpoint share a single local
        copy (the markers are re-written into the slot, so the cached copy
        is itself a committed, verifiable directory). Because the slot is
        SHARED, treat the returned directory as read-only; call
        ``to_directory()`` for a private mutable copy. An uncommitted
        prefix — a crashed or in-flight upload — raises
        ``FileNotFoundError`` instead of silently restoring half a model;
        ``allow_uncommitted=True`` opts back into the bare-mirror restore
        for pre-protocol prefixes, via a per-URI slot that is
        re-materialized each call (bounded disk: no fresh directory per
        call).
        """
        from ray_tpu_torch._private import external_storage as storage

        manifest = storage.read_committed_manifest(uri)
        if manifest is not None:
            digest = storage.manifest_digest(manifest)
            dest = os.path.join(_cache_root(), f"c-{digest[:16]}")
            if os.path.exists(os.path.join(dest, _CACHE_DONE)):
                return cls(dest)
            tmp = f"{dest}.tmp.{os.getpid()}.{uuid.uuid4().hex[:6]}"
            try:
                storage.restore_committed_uri_to_dir(uri, tmp, manifest)
            except BaseException:
                # a failed verified restore must not strand its partial
                # download in the cache root
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            storage.write_commit_markers(tmp, manifest)
            open(os.path.join(tmp, _CACHE_DONE), "w").close()
            try:
                os.rename(tmp, dest)
            except OSError:
                # lost the create race (or a stale incomplete slot): the
                # winner's copy is digest-identical, use it
                if os.path.exists(os.path.join(dest, _CACHE_DONE)):
                    shutil.rmtree(tmp, ignore_errors=True)
                else:
                    shutil.rmtree(dest, ignore_errors=True)
                    os.rename(tmp, dest)
            return cls(dest)

        if not allow_uncommitted:
            raise FileNotFoundError(
                f"no COMMITTED checkpoint under {uri} — either a partial/"
                f"crashed upload (never restorable) or a pre-protocol bare "
                f"mirror (pass allow_uncommitted=True to restore it unverified)"
            )
        # legacy (pre-protocol) prefix: no manifest to verify or key by.
        # Each call materializes a fresh GENERATION under the per-URI slot
        # and prunes all but the two newest — re-download semantics with
        # bounded disk (no directory leaked per call), while the previous
        # generation survives one refresh for readers still holding it.
        import glob as _glob
        import time as _time

        key = hashlib.sha256(uri.encode()).hexdigest()[:16]
        slot = os.path.join(_cache_root(), f"u-{key}")
        dest = os.path.join(slot, f"g{_time.time_ns():020d}_{uuid.uuid4().hex[:6]}")
        tmp = f"{dest}.tmp"
        try:
            files = storage.sync_uri_to_dir(uri, tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)  # no strand on mid-sync error
            raise
        if not files:
            shutil.rmtree(tmp, ignore_errors=True)
            raise FileNotFoundError(f"no checkpoint files under {uri}")
        os.rename(tmp, dest)
        gens = sorted(
            d for d in _glob.glob(os.path.join(slot, "g*")) if not d.endswith(".tmp")
        )
        for old in gens[:-2]:
            shutil.rmtree(old, ignore_errors=True)
        return cls(dest)

    def to_uri(self, uri: str, *, commit: bool = True) -> str:
        """Upload this checkpoint's directory to external storage. With
        ``commit`` (default) the upload ends with the manifest + atomic
        COMMIT marker so readers can trust it; ``commit=False`` reproduces
        the bare mirror for raw-prefix consumers."""
        from ray_tpu_torch._private import external_storage as storage

        if commit:
            storage.commit_dir_to_uri(self.path, uri)
        else:
            storage.sync_dir_to_uri(self.path, uri)
        return uri

    def to_directory(self, path: Optional[str] = None) -> str:
        dest = path or os.path.join(tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:8]}")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextlib.contextmanager
    def as_directory(self):
        yield self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))
