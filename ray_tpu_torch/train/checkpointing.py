"""Checkpoint plane: async sharded save/restore with atomic commit.

Parity targets: the reference's ``CheckpointManager``
(``python/ray/train/_internal/checkpoint_manager.py``) and storage context
upload, re-architected around two properties (motivated by
Gemini SOSP'23 / Check-N-Run NSDI'22 — checkpoint frequency is bounded by
how well save overlaps training and how cheaply restores can be trusted):

* **save overlaps training** — ``train.report(checkpoint=)`` returns after a
  local snapshot (O(local-copy)); upload + commit run in a bounded-queue
  background thread on the driver;
* **restores are trusted** — per-rank shards (``shard-{rank}-of-{world}``)
  barrier at the head, which assembles a manifest (per-file sizes + sha256
  digests) and writes an atomic ``COMMIT`` marker *last*
  (``ray_tpu_torch._private.external_storage`` commit protocol). Readers —
  :func:`latest_checkpoint`, ``Checkpoint.from_uri`` — only ever observe
  committed, digest-verified checkpoints; a crash at any point of
  save leaves an uncommitted prefix that GC reclaims. (The reference also
  mirrors each commit to external storage; the port does not yet.)

The plane rides the telemetry/forensics infrastructure: ``checkpoint_save``
/ ``checkpoint_commit`` profile spans in the timeline,
``ray_tpu_torch_checkpoint_{save_seconds,bytes,last_committed_step,uploads_inflight}``
metrics, ``CHECKPOINT_COMMITTED`` / ``CHECKPOINT_FAILED`` cluster events,
and a KV run registry (:func:`registered_runs`; the reference's
``state.list_checkpoints()`` and ``ckpt`` CLI, which read it, come with the
port's cluster tooling).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import external_storage as _storage

CHECKPOINT_PREFIX = "checkpoint_"
_KV_NS = "ckpt"


class CheckpointDrainError(RuntimeError):
    """fit() gave up waiting for in-flight checkpoint commits. The listed
    steps were fully reported by the workers but their background
    upload/commit had not finished when the drain timeout expired — they
    may still commit later, or never."""

    def __init__(self, undrained_steps, timeout_s: float):
        self.undrained_steps = sorted(undrained_steps)
        self.timeout_s = timeout_s
        super().__init__(
            f"checkpoint commit drain timed out after {timeout_s:.0f}s; "
            f"steps {self.undrained_steps} were reported but not committed"
        )


def step_dir_name(step: int) -> str:
    return f"{CHECKPOINT_PREFIX}{step:06d}"


def shard_dir_name(rank: int, world_size: int) -> str:
    """Per-rank shard directory. A world of one collapses the shard into the
    step directory itself, so single-worker checkpoints keep the flat
    dir-of-files layout every existing consumer expects."""
    if world_size <= 1:
        return ""
    return f"shard-{rank:05d}-of-{world_size:05d}"


def parse_step(name: str) -> Optional[int]:
    if not name.startswith(CHECKPOINT_PREFIX):
        return None
    digits = name[len(CHECKPOINT_PREFIX) :].split("_")[0].split("/")[0]
    try:
        return int(digits)
    except ValueError:
        return None


def _join(base: str, name: str) -> str:
    if _storage.has_scheme(base):
        return _storage.join(base, name)
    return os.path.join(base, name)


def resolve_trial_dir(storage_path: str, name: str) -> str:
    """One run's local directory under ``storage_path`` (a path or a
    ``file://`` URI). The reference also trains into a local staging dir
    and mirrors each checkpoint to external (``scheme://``) storage; the
    port does not have that mirror yet, so such a path raises."""
    if storage_path.startswith("file://"):
        return os.path.join(storage_path[len("file://") :], name)
    if _storage.has_scheme(storage_path):
        raise NotImplementedError(
            f"RunConfig(storage_path={storage_path!r}): mirroring checkpoints to "
            "external storage is not in the port yet; give a local path"
        )
    return os.path.join(storage_path, name)


def discover_steps(base: str) -> Dict[int, str]:
    """Scan a base path-or-URI for checkpoint step prefixes: step ->
    prefix. Flat-key backends (memory://, object stores) are walked through
    ``list``; local paths through ``listdir``."""
    base = (base or "").rstrip("/")
    if not base:
        return {}
    names: set = set()
    if _storage.has_scheme(base) and not base.startswith("file://"):
        try:
            keys = _storage.list_uri(base + "/")
        except ValueError:
            return {}
        for key in keys:
            rest = key[len(base) + 1 :]
            first = rest.split("/", 1)[0]
            if first.startswith(CHECKPOINT_PREFIX):
                names.add(first)
    else:
        root = base[len("file://") :] if base.startswith("file://") else base
        if not os.path.isdir(root):
            return {}
        for name in os.listdir(root):
            if name.startswith(CHECKPOINT_PREFIX) and os.path.isdir(
                os.path.join(root, name)
            ):
                names.add(name)
    out: Dict[int, str] = {}
    for name in names:
        step = parse_step(name)
        if step is not None:
            # later duplicate names for one step (legacy uuid suffixes) keep
            # the lexicographically greatest — deterministic either way
            cur = out.get(step)
            cand = _join(base, name)
            if cur is None or cand > cur:
                out[step] = cand
    return out


def list_checkpoints(base: str) -> List[dict]:
    """Every checkpoint prefix under a base, committed or not, newest
    first. Committed rows carry the manifest's metadata (size, file count,
    world size, creation time)."""
    rows: List[dict] = []
    for step, prefix in sorted(discover_steps(base).items(), reverse=True):
        manifest = _storage.read_committed_manifest(prefix)
        row = {
            "step": step,
            "path": prefix,
            "committed": manifest is not None,
        }
        if manifest is not None:
            files = manifest.get("files", {})
            row.update(
                size_bytes=sum(e.get("size", 0) for e in files.values()),
                num_files=len(files),
                world_size=manifest.get("world_size"),
                created=manifest.get("created"),
                run=manifest.get("run"),
            )
        rows.append(row)
    return rows


def latest_step(base: str) -> Optional[int]:
    """The newest *committed* step under a base, or None. Uncommitted
    prefixes (in-flight or crashed saves) are never considered."""
    for step, prefix in sorted(discover_steps(base).items(), reverse=True):
        if _storage.is_committed(prefix):
            return step
    return None


def latest_checkpoint(base: str):
    """``Checkpoint`` for the newest committed step under a base (local
    path: points at the directory; URI: verified download), or None."""
    steps = discover_steps(base)
    for step in sorted(steps, reverse=True):
        prefix = steps[step]
        if not _storage.is_committed(prefix):
            continue
        return load_checkpoint(prefix)
    return None


def load_checkpoint(path_or_uri: str):
    """Materialize one checkpoint reference. URIs restore through the
    digest-verified path (``Checkpoint.from_uri``); local paths are used in
    place. This is the one funnel every resume path routes through, so a
    trial restarted on another node restores from the URI instead of a
    dead node's local directory."""
    from ray_tpu_torch.train._checkpoint import Checkpoint

    if _storage.has_scheme(path_or_uri) and not path_or_uri.startswith("file://"):
        return Checkpoint.from_uri(path_or_uri)
    path = path_or_uri[len("file://") :] if path_or_uri.startswith("file://") else path_or_uri
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint directory {path} does not exist")
    return Checkpoint(path)


def _classify_steps(base: str):
    """(step -> prefix, sorted committed steps) for one base — shared by
    scoring and GC so a retention pass lists/reads each prefix once."""
    steps = discover_steps(base)
    committed = [s for s in sorted(steps) if _storage.is_committed(steps[s])]
    return steps, committed


def gc_checkpoints(
    base: str,
    *,
    keep: Optional[int] = None,
    protect: Optional[set] = None,
    doomed_steps: Optional[set] = None,
    classified=None,
) -> List[int]:
    """Retention GC over one base: keep the newest ``keep`` committed
    checkpoints (or an explicit ``doomed_steps`` set chosen by score), and
    reclaim uncommitted garbage older than the newest committed step
    (crashed/partial saves).
    The newest committed checkpoint is never deleted — a run must always
    keep its resume point. Returns the deleted steps. ``classified`` is an
    optional precomputed :func:`_classify_steps` result (spares a second
    remote scan when the caller already classified the base)."""
    steps, committed = classified if classified is not None else _classify_steps(base)
    if not steps:
        return []
    protect = protect or set()
    doomed: set = set()
    if committed:
        newest = committed[-1]
        if doomed_steps is not None:
            doomed |= {s for s in doomed_steps if s in steps}
        elif keep is not None and keep > 0 and len(committed) > keep:
            doomed |= set(committed[:-keep])
        # uncommitted prefixes older than the newest committed step are
        # crashed saves (anything newer may be an in-flight upload)
        doomed |= {s for s in steps if s not in committed and s < newest}
        doomed.discard(newest)
    doomed -= protect
    deleted = []
    for s in sorted(doomed):
        try:
            _storage.delete_prefix(steps[s])
            deleted.append(s)
        except Exception:
            pass  # a half-deleted prefix is uncommitted: the next GC retries
    return deleted


# --------------------------------------------------------------------------
# telemetry surface
# --------------------------------------------------------------------------

_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def _get_metrics() -> Dict[str, Any]:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

            _metrics = {
                "save_seconds": Histogram(
                    "ray_tpu_torch_checkpoint_save_seconds",
                    "in-loop checkpoint snapshot latency (what train.report blocks on)",
                    boundaries=[0.001, 0.01, 0.05, 0.1, 0.5, 1, 5, 30],
                ),
                "commit_seconds": Histogram(
                    "ray_tpu_torch_checkpoint_commit_seconds",
                    "background upload+commit latency per checkpoint",
                    boundaries=[0.01, 0.1, 0.5, 1, 5, 30, 120],
                ),
                "bytes": Counter(
                    "ray_tpu_torch_checkpoint_bytes",
                    "total bytes committed by the checkpoint plane",
                ),
                "last_committed_step": Gauge(
                    "ray_tpu_torch_checkpoint_last_committed_step",
                    "newest committed checkpoint step",
                    tag_keys=("run",),
                ),
                "uploads_inflight": Gauge(
                    "ray_tpu_torch_checkpoint_uploads_inflight",
                    "checkpoint commits queued or running in the background uploader",
                    tag_keys=("run",),
                ),
                "failed_total": Counter(
                    "ray_tpu_torch_checkpoint_failed_total",
                    "checkpoint commits that failed (no COMMIT written)",
                    tag_keys=("run",),
                ),
            }
    return _metrics


def observe_save_seconds(seconds: float) -> None:
    """Record one in-loop snapshot latency (called by the train session)."""
    try:
        _get_metrics()["save_seconds"].observe(seconds)
    except Exception:
        pass  # telemetry must never take a save down


# --------------------------------------------------------------------------
# preemption hooks (SIGTERM drain integration)
# --------------------------------------------------------------------------

_preemption_hooks: List[Callable[[], None]] = []
_live_managers: List["CheckpointManager"] = []
_hooks_lock = threading.Lock()


def register_preemption_hook(fn: Callable[[], None]) -> Callable[[], None]:
    """Register a callable to run when this process is being preempted
    (SIGTERM drain). Typical use from a train loop: snapshot model state
    and ``train.report(checkpoint=...)`` one last time. Best-effort — the
    drain window is bounded. Returns ``fn`` so it can be used as a
    decorator."""
    with _hooks_lock:
        _preemption_hooks.append(fn)
    return fn


def unregister_preemption_hook(fn: Callable[[], None]) -> None:
    with _hooks_lock:
        try:
            _preemption_hooks.remove(fn)
        except ValueError:
            pass


def run_preemption_hooks(timeout_s: float = 5.0) -> None:
    """Best-effort final snapshot on preemption: run user hooks (each may
    report a final checkpoint), then drain every live manager so barriered
    saves reach COMMIT before the process dies. Called from the worker's
    SIGTERM drain thread; the caller's hard-exit backstop bounds us."""
    deadline = time.monotonic() + timeout_s
    with _hooks_lock:
        hooks = list(_preemption_hooks)
        managers = list(_live_managers)
    for fn in hooks:
        if time.monotonic() >= deadline:
            break
        try:
            fn()
        except Exception:
            pass
    for mgr in managers:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            mgr.wait(timeout=remaining)
        except Exception:
            pass


# --------------------------------------------------------------------------
# CheckpointManager
# --------------------------------------------------------------------------


class CheckpointManager:
    """Head-side coordinator: shard barrier -> async commit -> retention.

    Workers snapshot shards locally and report; the manager (running where
    reports arrive — the trainer driver or a tune trial actor) completes
    the barrier when all ``world_size`` ranks have reported a step, then
    hands the step to a bounded-queue background thread that writes the
    manifest, commits, updates the KV run registry, and enforces
    retention."""

    def __init__(
        self,
        local_base: str,
        *,
        world_size: int = 1,
        keep: Optional[int] = None,
        max_inflight: int = 2,
        run_name: Optional[str] = None,
        score_attribute: Optional[str] = None,
        score_order: str = "max",
    ):
        self.local_base = os.path.abspath(local_base)
        self.world_size = max(1, int(world_size))
        self.keep = keep
        self.run_name = run_name or os.path.basename(self.local_base)
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: Dict[int, set] = {}  # step -> ranks with a shard in
        self._reported: Dict[int, set] = {}  # step -> ranks reported at all
        self._step_dirs: Dict[int, str] = {}
        self._step_metrics: Dict[int, dict] = {}
        self._committed: Dict[int, dict] = {}  # step -> manifest
        self._failed: Dict[int, str] = {}
        self._outstanding = 0  # queued + running commits
        self._inflight_steps: set = set()  # the steps behind _outstanding
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, max_inflight))
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        with _hooks_lock:
            _live_managers.append(self)
        self._update_registry()

    # -- save path ---------------------------------------------------------

    def note_report(
        self,
        rank: int,
        step: int,
        shard_path: Optional[str] = None,
        metrics: Optional[dict] = None,
    ) -> bool:
        """One rank reported a step — with a local shard (``shard_path``)
        or metrics-only. The barrier completes when every rank's shard is
        in, OR when every rank has reported the step and at least one
        brought a shard: rank-0-only checkpointing (the reference's
        default gather pattern, ``if rank == 0: report(ckpt)``) commits a
        single-shard checkpoint instead of stalling forever. Returns True
        when this call scheduled the commit."""
        with self._lock:
            if self._closed or step in self._committed:
                return False
            reported = self._reported.setdefault(step, set())
            reported.add(rank)
            shards = self._pending.setdefault(step, set())
            if shard_path is not None:
                # a re-reported step clears its earlier failure: the
                # retried attempt re-saves it and the commit (a full
                # overwrite) runs again
                self._failed.pop(step, None)
                shards.add(rank)
                step_dir = os.path.abspath(shard_path)
                if self.world_size > 1 and os.path.basename(step_dir).startswith(
                    "shard-"
                ):
                    step_dir = os.path.dirname(step_dir)
                self._step_dirs[step] = step_dir
            if metrics is not None and (rank == 0 or step not in self._step_metrics):
                self._step_metrics[step] = dict(metrics)
            complete = bool(shards) and (
                len(shards) >= self.world_size
                or len(reported) >= self.world_size
            )
            if complete:
                del self._pending[step]
                self._reported.pop(step, None)
                self._outstanding += 1
                self._inflight_steps.add(step)
            elif len(reported) >= self.world_size and not shards:
                # metrics-only step: every rank is in, nobody checkpointed
                self._pending.pop(step, None)
                self._reported.pop(step, None)
        if complete:
            self._set_inflight_gauge()
            self._ensure_thread()
            self._queue.put(step)  # bounded: blocks = backpressure
        return complete

    def reset_barrier(self) -> None:
        """Forget partially-reported steps. Called between retry attempts:
        a dead attempt's half-complete barrier must not count toward the
        retried attempt's reports — stale ranks could otherwise complete
        the barrier while the retry is still rewriting the step dir,
        committing a torn mix of the two attempts' bytes."""
        with self._lock:
            self._pending.clear()
            self._reported.clear()

    def pending_steps(self) -> List[int]:
        """Steps whose background upload/commit is queued or running —
        what a drain timeout leaves behind."""
        with self._lock:
            return sorted(self._inflight_steps)

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        t = threading.Thread(
            target=self._uploader_loop, name="ray_tpu_torch-ckpt-uploader", daemon=True
        )
        self._thread = t
        t.start()

    def _uploader_loop(self) -> None:
        while True:
            step = self._queue.get()
            if step is None:
                return
            try:
                self._commit_one(step)
            except Exception:
                pass  # accounted inside _commit_one

    def _commit_one(self, step: int) -> None:
        from ray_tpu_torch._private import telemetry
        from ray_tpu_torch._private.profiling import profile

        step_dir = self._step_dirs.get(step)
        t0 = time.monotonic()
        try:
            with profile(
                "checkpoint_commit", {"step": step, "run": self.run_name}
            ):
                manifest = _storage.build_manifest(
                    step_dir,
                    step=step,
                    world_size=self.world_size,
                    run=self.run_name,
                    created=time.time(),
                )
                if not manifest["files"]:
                    # the step dir vanished under us (concurrent GC / CLI):
                    # committing would mint a "valid" EMPTY checkpoint that
                    # latest() prefers and resume restores nothing from
                    raise _storage.IntegrityError(
                        f"step dir {step_dir} is empty or missing at commit time"
                    )
                _storage.write_commit_markers(step_dir, manifest)
        except Exception as e:  # noqa: BLE001
            with self._cv:
                self._failed[step] = repr(e)
                self._outstanding -= 1
                self._inflight_steps.discard(step)
                self._cv.notify_all()
            self._set_inflight_gauge()
            try:
                _get_metrics()["failed_total"].inc(tags={"run": self.run_name})
                telemetry.record_cluster_event(
                    "CHECKPOINT_FAILED",
                    f"checkpoint step {step} of run {self.run_name} failed to "
                    f"commit: {e!r}",
                    severity="ERROR",
                    source="TRAIN",
                    step=step,
                    run=self.run_name,
                )
            except Exception:
                pass
            return
        size = sum(e.get("size", 0) for e in manifest["files"].values())
        with self._cv:
            self._committed[step] = manifest
        if self.world_size > 1:
            shards = {
                rel.split("/", 1)[0].split(os.sep, 1)[0]
                for rel in manifest["files"]
                if rel.startswith("shard-")
            }
            if 0 < len(shards) < self.world_size:
                # legitimate for the rank-0-gather pattern, but loud: a
                # rank whose reports drifted out of step would silently
                # lose its shard otherwise
                try:
                    telemetry.record_cluster_event(
                        "CHECKPOINT_COMMITTED",
                        f"checkpoint step {step} of run {self.run_name} "
                        f"committed with {len(shards)}/{self.world_size} "
                        f"shards (rank-0-gather pattern, or rank report skew)",
                        severity="WARNING",
                        source="TRAIN",
                        step=step,
                        run=self.run_name,
                    )
                except Exception:
                    pass
        try:
            m = _get_metrics()
            m["commit_seconds"].observe(time.monotonic() - t0)
            m["bytes"].inc(size)
            m["last_committed_step"].set(step, tags={"run": self.run_name})
            telemetry.record_cluster_event(
                "CHECKPOINT_COMMITTED",
                f"checkpoint step {step} of run {self.run_name} committed "
                f"({len(manifest['files'])} files, {size} bytes)",
                source="TRAIN",
                step=step,
                run=self.run_name,
            )
        except Exception:
            pass
        try:
            self.gc()
        except Exception:
            pass
        self._update_registry()
        # the decrement comes LAST: wait() returning means commit AND
        # retention have fully settled, so a resume or shutdown never races
        # a half-finished GC
        with self._cv:
            self._outstanding -= 1
            self._inflight_steps.discard(step)
            self._cv.notify_all()
        self._set_inflight_gauge()

    # -- read path ---------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued/running commit finishes. True when the
        plane is drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._outstanding > 0:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is not None else 1.0)
        return True

    def latest_step(self) -> Optional[int]:
        """Newest committed step (disk truth, not just this manager's
        in-memory view — a restarted driver sees prior commits)."""
        return latest_step(self.local_base)

    def latest_checkpoint(self):
        """``Checkpoint`` for the newest committed step, or None."""
        return latest_checkpoint(self.local_base)

    def list(self) -> List[dict]:
        return list_checkpoints(self.local_base)

    def failures(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._failed)

    # -- retention ---------------------------------------------------------

    def _score_doomed(self, committed: List[int]) -> Optional[set]:
        """Score-based retention (CheckpointConfig.checkpoint_score_attribute):
        doom all but the best ``keep`` of the given committed steps by the
        recorded metric. None = use recency. Committed steps found on
        disk but not scored by THIS incarnation (a restarted driver)
        default to score 0.0, so prior runs' checkpoints still participate
        in retention instead of accumulating forever."""
        if not self.score_attribute or self.keep is None:
            return None
        with self._lock:
            scores = {
                s: (self._step_metrics.get(s) or {}).get(self.score_attribute, 0.0)
                for s in committed
            }
        if len(committed) <= self.keep:
            return set()
        reverse = self.score_order == "max"
        ranked = sorted(committed, key=lambda s: scores[s], reverse=reverse)
        return set(ranked[self.keep :])

    def gc(self) -> List[int]:
        """Enforce retention on the run's base. In-flight and
        barrier-pending steps are protected. With no retention policy
        configured this is a no-op — the per-commit scan of every prior
        step would otherwise grow O(steps) for nothing."""
        if self.keep is None and not self.score_attribute:
            return []
        with self._lock:
            protect = set(self._pending) | {
                s
                for s in self._step_dirs
                if s not in self._committed and s not in self._failed
            }
        classified = _classify_steps(self.local_base)
        deleted = gc_checkpoints(
            self.local_base,
            keep=self.keep,
            protect=protect,
            doomed_steps=self._score_doomed(classified[1]),
            classified=classified,
        )
        if deleted:
            with self._lock:
                for s in deleted:
                    self._committed.pop(s, None)
                    self._step_dirs.pop(s, None)
                    self._step_metrics.pop(s, None)
        return deleted

    # -- registry / lifecycle ---------------------------------------------

    def _set_inflight_gauge(self) -> None:
        try:
            with self._lock:
                n = self._outstanding
            _get_metrics()["uploads_inflight"].set(n, tags={"run": self.run_name})
        except Exception:
            pass

    def _update_registry(self) -> None:
        """Advertise this run in the GCS KV so ``state.list_checkpoints()``
        and the CLI can find it without being handed a path."""
        rt = _runtime()
        if rt is None:
            return
        with self._lock:
            last = max(self._committed) if self._committed else None
        entry = {
            "run": self.run_name,
            "local_base": self.local_base,
            "world_size": self.world_size,
            "last_committed_step": last,
            "updated": time.time(),
        }
        try:
            blob = json.dumps(entry).encode()
            key = self.run_name.encode()
            if hasattr(rt, "scheduler_rpc"):
                rt.scheduler_rpc("kv_put", (_KV_NS, key, blob, True))
            else:
                rt.rpc("kv_put", _KV_NS, key, blob, True)
        except Exception:
            pass

    def shutdown(self, wait: bool = True, timeout: Optional[float] = 60.0) -> None:
        if wait:
            self.wait(timeout=timeout)
        with self._lock:
            self._closed = True
        if self._thread is not None and self._thread.is_alive():
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass
        with _hooks_lock:
            try:
                _live_managers.remove(self)
            except ValueError:
                pass


def _runtime():
    from ray_tpu_torch._private import worker as worker_mod

    rt = worker_mod._worker_runtime
    if rt is not None:
        return rt
    return worker_mod._driver


def registered_runs() -> List[dict]:
    """Every run advertised in the KV checkpoint registry."""
    rt = _runtime()
    if rt is None:
        return []
    try:
        if hasattr(rt, "scheduler_rpc"):
            keys = rt.scheduler_rpc("kv_keys", (_KV_NS, b""))
            get = lambda k: rt.scheduler_rpc("kv_get", (_KV_NS, k))  # noqa: E731
        else:
            keys = rt.rpc("kv_keys", _KV_NS, b"")
            get = lambda k: rt.rpc("kv_get", _KV_NS, k)  # noqa: E731
    except Exception:
        return []
    out = []
    for key in sorted(keys or ()):
        try:
            blob = get(key)
            if blob:
                out.append(json.loads(blob))
        except Exception:
            continue
    return out
