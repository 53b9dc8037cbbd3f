"""Pluggable external storage behind a ``scheme://`` URI API.

Parity: ``python/ray/_private/external_storage.py`` (spill targets) +
``pyarrow.fs``-style URI resolution used by Data IO and Train checkpoints.
One registry serves all three consumers:

* object-store spill (``NativeStoreClient`` with a scheme'd spill target);
* Data read/write (``ray_tpu_torch.data`` paths like ``file:///...``);
* Train checkpoint upload/restore (``RunConfig(storage_path=...)``,
  ``Checkpoint.from_uri``).

Built-in backends: ``file://`` (local filesystem) and ``memory://`` (an
in-process fake for unit tests — NOT shared across workers). Third-party
backends (an S3/GCS client, say) register with :func:`register_backend`;
nothing else in the framework knows more than the URI.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

_LOCK = threading.Lock()
_BACKENDS: Dict[str, "StorageBackend"] = {}
_FACTORIES: Dict[str, Callable[[], "StorageBackend"]] = {}

# streaming read unit for read_into (one readinto syscall per chunk)
_READ_CHUNK = 8 * 1024 * 1024


class StorageBackend:
    """Byte-level storage behind one URI scheme.

    ``write_stream`` / ``read_into`` are the large-object streaming surface
    (spill writes sealed store buffers chunk-by-chunk; restore reads
    straight into a store allocation). The base-class implementations fall
    back to the whole-blob methods so third-party backends that only
    implement ``write_bytes``/``read_bytes`` keep working.
    """

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> Optional[bytes]:
        raise NotImplementedError

    def write_stream(self, path: str, chunks) -> None:
        """Write an iterable of bytes-like chunks as one object."""
        # join accepts memoryviews directly: one flattening copy, not two
        self.write_bytes(path, b"".join(chunks))

    def read_into(self, path: str, make_dest) -> Optional[int]:
        """Read an object into a caller-provided buffer.

        ``make_dest(size) -> Optional[memoryview]`` allocates the
        destination; a None return means the caller declined (e.g. lost a
        create race) — the backend then skips the copy but still returns
        the size. Returns the object size, or None when the object does not
        exist. Callers must treat a None return after ``make_dest`` ran as
        "destination possibly part-filled" and discard it.
        """
        data = self.read_bytes(path)
        if data is None:
            return None
        dest = make_dest(len(data))
        if dest is not None:
            from ray_tpu_torch._private import fastcopy

            fastcopy.copy_into(dest, data)
        return len(data)

    def read_range(
        self, path: str, offset: int, length: int, make_dest
    ) -> Optional[int]:
        """Read ``length`` bytes starting at ``offset`` into a
        caller-provided buffer (``make_dest(length) -> memoryview`` or
        None to decline). The elastic re-shard path reads only the byte
        ranges a new rank owns out of old shards, so backends should
        override this with a true ranged read where the protocol has one
        (HTTP Range, pread); the base implementation falls back to a
        whole-object ``read_bytes`` and slices. Returns the number of
        bytes read (short when the object ends inside the range), or
        None when the object does not exist.
        """
        data = self.read_bytes(path)
        if data is None:
            return None
        piece = data[offset : offset + length]
        dest = make_dest(len(piece))
        if dest is not None and len(piece):
            from ray_tpu_torch._private import fastcopy

            fastcopy.copy_into(dest, piece)
        return len(piece)

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def delete(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError


class FileBackend(StorageBackend):
    """``file://`` — the local filesystem (atomic writes via tmp+rename)."""

    def write_bytes(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)

    def read_bytes(self, path: str) -> Optional[bytes]:
        try:
            with open(path, "rb") as fh:
                return fh.read()
        except OSError:
            return None

    def write_stream(self, path: str, chunks) -> None:
        # chunked writes straight from the caller's views (no join copy),
        # same tmp+rename atomicity as write_bytes
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            for c in chunks:
                fh.write(c)
        os.replace(tmp, path)

    def read_into(self, path: str, make_dest) -> Optional[int]:
        try:
            fh = open(path, "rb")
        except OSError:
            return None
        with fh:
            try:
                size = os.fstat(fh.fileno()).st_size
                dest = make_dest(size)
                if dest is None:
                    return size
                off = 0
                while off < size:
                    n = fh.readinto(dest[off : min(off + _READ_CHUNK, size)])
                    if not n:
                        return None  # truncated under us: discard the fill
                    off += n
                return size
            except OSError:
                return None

    def read_range(
        self, path: str, offset: int, length: int, make_dest
    ) -> Optional[int]:
        # true ranged read: seek + bounded readinto, no whole-file staging
        try:
            fh = open(path, "rb")
        except OSError:
            return None
        with fh:
            try:
                size = os.fstat(fh.fileno()).st_size
                want = max(0, min(length, size - offset))
                dest = make_dest(want)
                if dest is None or want == 0:
                    return want
                fh.seek(offset)
                off = 0
                while off < want:
                    n = fh.readinto(dest[off : min(off + _READ_CHUNK, want)])
                    if not n:
                        return None  # truncated under us: discard the fill
                    off += n
                return want
            except OSError:
                return None

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def delete(self, path: str) -> bool:
        try:
            os.unlink(path)
            return True
        except OSError:
            return False

    def list(self, prefix: str) -> List[str]:
        # directory (or explicit dir prefix): recursive file walk, matching
        # the flat-key semantics of object stores
        if os.path.isdir(prefix) or prefix.endswith("/"):
            root = prefix.rstrip("/")
            out: List[str] = []
            for r, _dirs, files in os.walk(root):
                out.extend(os.path.join(r, n) for n in files)
            return sorted(out)
        d, base = os.path.dirname(prefix), os.path.basename(prefix)
        try:
            return sorted(
                os.path.join(d, n) for n in os.listdir(d) if n.startswith(base)
            )
        except OSError:
            return []


class MemoryBackend(StorageBackend):
    """``memory://`` — an in-process dict; the unit-test fake (the
    reference's unstable mock storage plays the same role). Contents are
    NOT visible to other worker processes."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def write_bytes(self, path: str, data: bytes) -> None:
        with self._lock:
            self._data[path] = bytes(data)

    def read_bytes(self, path: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(path)

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._data

    def delete(self, path: str) -> bool:
        with self._lock:
            return self._data.pop(path, None) is not None

    def list(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))


def register_backend(scheme: str, factory: Callable[[], StorageBackend]) -> None:
    """Register (or replace) the backend for a URI scheme."""
    with _LOCK:
        _FACTORIES[scheme] = factory
        _BACKENDS.pop(scheme, None)


register_backend("file", FileBackend)
register_backend("memory", MemoryBackend)


def has_scheme(uri: str) -> bool:
    return "://" in (uri or "")


def resolve(uri: str) -> Tuple[StorageBackend, str]:
    """``scheme://path`` -> (backend instance, backend-local path).

    Plain paths resolve to the file backend, so every call site can take
    either a path or a URI.
    """
    if not has_scheme(uri):
        scheme, path = "file", uri
    else:
        # file:///abs/path partitions to /abs/path; file://rel stays relative
        scheme, _, path = uri.partition("://")
    with _LOCK:
        backend = _BACKENDS.get(scheme)
        if backend is None:
            factory = _FACTORIES.get(scheme)
            if factory is None:
                raise ValueError(
                    f"no storage backend registered for scheme '{scheme}'"
                )
            backend = _BACKENDS[scheme] = factory()
    return backend, path


def join(uri: str, *parts: str) -> str:
    out = uri.rstrip("/")
    for p in parts:
        out += "/" + p.strip("/")
    return out


def write_bytes(uri: str, data: bytes) -> None:
    backend, path = resolve(uri)
    backend.write_bytes(path, data)


def read_bytes(uri: str) -> Optional[bytes]:
    backend, path = resolve(uri)
    return backend.read_bytes(path)


def write_stream(uri: str, chunks) -> None:
    """Write an iterable of bytes-like chunks as one object (spill path:
    streams sealed store buffers without staging a full copy)."""
    backend, path = resolve(uri)
    backend.write_stream(path, chunks)


def read_into(uri: str, make_dest) -> Optional[int]:
    """Read an object straight into ``make_dest(size)``'s buffer (restore
    path); see :meth:`StorageBackend.read_into` for the contract."""
    backend, path = resolve(uri)
    return backend.read_into(path, make_dest)


def read_range(uri: str, offset: int, length: int, make_dest) -> Optional[int]:
    """Read one byte range of an object into ``make_dest(n)``'s buffer
    (elastic re-shard restore); see :meth:`StorageBackend.read_range`."""
    backend, path = resolve(uri)
    return backend.read_range(path, offset, length, make_dest)


def exists(uri: str) -> bool:
    backend, path = resolve(uri)
    return backend.exists(path)


def delete(uri: str) -> bool:
    backend, path = resolve(uri)
    return backend.delete(path)


def list_uri(uri: str) -> List[str]:
    backend, path = resolve(uri)
    scheme = uri.partition("://")[0] if has_scheme(uri) else "file"
    return [f"{scheme}://{p}" if has_scheme(uri) else p for p in backend.list(path)]


# --------------------------------------------------------------------------
# checkpoint commit protocol (manifest + atomic COMMIT marker)
# --------------------------------------------------------------------------
#
# A committed directory-object (a train checkpoint) is three things under one
# prefix:
#
#   <prefix>/<payload files...>        uploaded first, any order
#   <prefix>/MANIFEST.json             per-file sizes + sha256 digests
#   <prefix>/COMMIT                    written LAST; content = manifest digest
#
# Readers treat COMMIT as the linearization point: a prefix without a valid
# COMMIT (missing, or whose content does not match the manifest's digest) is
# garbage from a crashed writer and must never be restored. Each individual
# write is atomic per backend (FileBackend tmp+rename), so a crash at ANY
# point leaves either no COMMIT or a fully consistent triple.

MANIFEST_FILE = "MANIFEST.json"
COMMIT_FILE = "COMMIT"
_DIGEST_CHUNK = 8 * 1024 * 1024


class IntegrityError(RuntimeError):
    """A committed object failed verification (size or digest mismatch)."""


def file_digest(path: str) -> str:
    """sha256 of one local file, streamed."""
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_DIGEST_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def build_manifest(local_dir: str, **meta) -> dict:
    """Walk ``local_dir`` into a manifest: relpath -> {size, digest}. The
    protocol's own marker files are excluded (a manifest never describes
    itself). ``meta`` (step, world_size, ...) rides along for readers."""
    files: Dict[str, dict] = {}
    for root, _dirs, names in os.walk(local_dir):
        for name in sorted(names):
            p = os.path.join(root, name)
            rel = os.path.relpath(p, local_dir)
            if rel in (MANIFEST_FILE, COMMIT_FILE):
                continue
            files[rel] = {
                "size": os.path.getsize(p),
                "digest": file_digest(p),
            }
    manifest = {"files": files}
    manifest.update(meta)
    return manifest


def manifest_digest(manifest: dict) -> str:
    """Digest of the canonical manifest encoding — the COMMIT marker's
    content, binding the marker to exactly one manifest."""
    import hashlib
    import json

    blob = json.dumps(manifest, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def write_commit_markers(prefix: str, manifest: dict) -> str:
    """Write MANIFEST.json then COMMIT (order is the protocol) under a
    path-or-URI prefix. Returns the manifest digest."""
    import json

    blob = json.dumps(manifest, sort_keys=True, indent=1).encode()
    write_bytes(join(prefix, MANIFEST_FILE), blob)
    digest = manifest_digest(manifest)
    write_bytes(join(prefix, COMMIT_FILE), digest.encode())
    return digest


def read_committed_manifest(prefix: str) -> Optional[dict]:
    """The manifest of a committed prefix, or None when the prefix is
    uncommitted (no/invalid COMMIT, or COMMIT does not match the manifest —
    a torn write from a crashed committer)."""
    import json

    marker = read_bytes(join(prefix, COMMIT_FILE))
    if marker is None:
        return None
    blob = read_bytes(join(prefix, MANIFEST_FILE))
    if blob is None:
        return None
    try:
        manifest = json.loads(blob)
    except ValueError:
        return None
    if manifest_digest(manifest) != marker.decode(errors="replace").strip():
        return None
    return manifest


def is_committed(prefix: str) -> bool:
    return read_committed_manifest(prefix) is not None


def commit_dir_to_uri(local_dir: str, uri: str, manifest: Optional[dict] = None) -> dict:
    """Upload a local directory as ONE committed object: payload files
    first, then manifest + COMMIT. A crash mid-upload leaves an uncommitted
    prefix that readers ignore and GC reclaims. Files upload through
    ``write_stream`` so a multi-GB shard is never staged whole in memory."""
    if manifest is None:
        manifest = build_manifest(local_dir)

    def _chunks(path):
        with open(path, "rb") as fh:
            while True:
                block = fh.read(_DIGEST_CHUNK)
                if not block:
                    break
                yield block

    for rel in manifest["files"]:
        p = os.path.join(local_dir, rel)
        write_stream(join(uri, rel.replace(os.sep, "/")), _chunks(p))
    write_commit_markers(uri, manifest)
    return manifest


def verify_file(prefix: str, rel: str, entry: dict, dest_path: Optional[str] = None) -> None:
    """Fetch ONE committed file, verifying size + sha256 against its
    manifest entry; with ``dest_path`` the bytes stream through
    ``read_into`` straight into an mmap-backed file (no whole-file
    staging), without it the file is hashed in place (verify-only).
    Raises :class:`IntegrityError` on any mismatch; a failed dest is
    unlinked, never left half-written."""
    import hashlib
    import mmap

    key = join(prefix, rel.replace(os.sep, "/"))
    expected = int(entry["size"])
    h = hashlib.sha256()
    if dest_path is None:
        backend, path = resolve(key)
        if isinstance(backend, FileBackend):
            # local object: constant-memory streaming hash, no staging
            if not os.path.isfile(path):
                raise IntegrityError(f"{prefix}: committed file {rel!r} missing")
            if os.path.getsize(path) != expected:
                raise IntegrityError(
                    f"{prefix}: {rel!r} size {os.path.getsize(path)} != "
                    f"manifest {expected}"
                )
            if file_digest(path) != entry["digest"]:
                raise IntegrityError(f"{prefix}: {rel!r} digest mismatch")
            return
        if expected == 0:
            if not exists(key):
                raise IntegrityError(f"{prefix}: committed file {rel!r} missing")
        else:
            buf = bytearray(expected)

            def make_dest(size):
                return memoryview(buf) if size == expected else None

            n = read_into(key, make_dest)
            if n is None:
                raise IntegrityError(f"{prefix}: committed file {rel!r} missing")
            if n != expected:
                raise IntegrityError(
                    f"{prefix}: {rel!r} size {n} != manifest {expected}"
                )
            for off in range(0, expected, _DIGEST_CHUNK):
                h.update(buf[off : off + _DIGEST_CHUNK])
        if h.hexdigest() != entry["digest"]:
            raise IntegrityError(f"{prefix}: {rel!r} digest mismatch")
        return

    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    try:
        with open(dest_path, "wb+") as fh:
            if expected:
                fh.truncate(expected)
                mm = mmap.mmap(fh.fileno(), expected)
                try:
                    def make_dest(size):
                        return memoryview(mm) if size == expected else None

                    n = read_into(key, make_dest)
                    if n is None:
                        raise IntegrityError(
                            f"{prefix}: committed file {rel!r} missing"
                        )
                    if n != expected:
                        raise IntegrityError(
                            f"{prefix}: {rel!r} size {n} != manifest {expected}"
                        )
                    for off in range(0, expected, _DIGEST_CHUNK):
                        h.update(mm[off : off + _DIGEST_CHUNK])
                finally:
                    mm.close()
            elif not exists(key):
                raise IntegrityError(f"{prefix}: committed file {rel!r} missing")
        if h.hexdigest() != entry["digest"]:
            raise IntegrityError(f"{prefix}: {rel!r} digest mismatch")
    except IntegrityError:
        try:
            os.unlink(dest_path)
        except OSError:
            pass
        raise


def restore_committed_uri_to_dir(uri: str, local_dir: str, manifest: Optional[dict] = None) -> List[str]:
    """Materialize a committed prefix locally, verifying every file's size
    and digest against the manifest. Raises :class:`IntegrityError` on any
    mismatch (and on an uncommitted prefix), so a reader can never act on a
    torn or corrupted checkpoint."""
    if manifest is None:
        manifest = read_committed_manifest(uri)
    if manifest is None:
        raise IntegrityError(f"no committed manifest under {uri}")
    out = []
    for rel, entry in manifest["files"].items():
        dest = os.path.join(local_dir, rel)
        verify_file(uri, rel, entry, dest_path=dest)
        out.append(dest)
    return out


def delete_prefix(prefix: str) -> int:
    """Delete every object under a prefix — COMMIT first, so an interrupted
    delete demotes the object to uncommitted garbage instead of leaving a
    committed-looking partial. Returns the number of objects removed."""
    n = 0
    commit_key = join(prefix, COMMIT_FILE)
    if exists(commit_key):
        n += int(delete(commit_key))
    for key in list_uri(prefix.rstrip("/") + "/"):
        n += int(delete(key))
    # local backends leave empty directory skeletons behind
    backend, path = resolve(prefix)
    if isinstance(backend, FileBackend) and os.path.isdir(path):
        import shutil

        shutil.rmtree(path, ignore_errors=True)
    return n


def sync_dir_to_uri(local_dir: str, uri: str) -> List[str]:
    """Mirror a local directory tree into external storage (checkpoint
    upload; parity: the trainable's storage sync)."""
    out = []
    for root, _dirs, files in os.walk(local_dir):
        for name in files:
            p = os.path.join(root, name)
            rel = os.path.relpath(p, local_dir)
            dest = join(uri, rel)
            with open(p, "rb") as fh:
                write_bytes(dest, fh.read())
            out.append(dest)
    return out


def sync_uri_to_dir(uri: str, local_dir: str) -> List[str]:
    """Materialize an external-storage prefix into a local directory
    (checkpoint download; ``Checkpoint.from_uri``)."""
    backend, prefix = resolve(uri)
    out = []
    for path in backend.list(prefix.rstrip("/") + "/"):
        rel = path[len(prefix.rstrip("/")) + 1 :]
        dest = os.path.join(local_dir, rel)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        data = backend.read_bytes(path)
        if data is not None:
            with open(dest, "wb") as fh:
                fh.write(data)
            out.append(dest)
    return out
