"""GIL-releasing parallel memcpy + large-object put/get stage timing.

The large-object data path (put → serialize → create → copy → seal) was
bounded by single-threaded ``memoryview`` slice assignment, which holds the
GIL for the whole copy. Two facts unlock a faster pipeline with zero new
dependencies:

* ``ctypes`` foreign calls release the GIL, so ``ctypes.memmove`` chunks
  fanned across a small persistent thread pool scale with real cores
  (measured on a 2-core host: 6.3 GiB/s single memmove → 11.9 GiB/s with 2
  threads — slice assignment managed only 4.6);
* exactly ``nthreads`` contiguous chunks beats fine-grained chunking: the
  copy is memory-bandwidth bound, so extra chunks only add submit/wake
  overhead (2 threads × 4 chunks measured *slower* than 1 thread).

Parity: plasma clients copy into the create()d buffer with
``arrow::internal::parallel_memcopy`` (``plasma/client.cc``); this module is
that, in pure Python over libc.

The same module hosts the put/get **stage-timing registry**: per-stage
(serialize / alloc / copy / seal / spill / restore) counts, seconds, and
bytes, merged into the scheduler's ``event_stats`` RPC so a bandwidth gap is
attributable to a stage instead of guessed at. Timings are process-local;
the ``event_stats`` RPC reports the head process's view (worker puts time
their own stages but only the head's are exported today — see
DESIGN_MAP.md "Large-object data path").
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Dict, Optional, Tuple

# Below this, plain slice assignment wins (no address extraction, no FFI).
_SLICE_MAX = 256 * 1024
# At or above this, the copy fans out across the pool.
_PARALLEL_MIN = int(
    os.environ.get("RAY_TPU_TORCH_PARALLEL_COPY_MIN", 4 * 1024 * 1024)
)
# Chunks streamed by spill/restore paths (one syscall's worth each).
CHUNK_BYTES = 8 * 1024 * 1024
# Public alias: "large object" everywhere in the data path means this.
LARGE_OBJECT_MIN = _PARALLEL_MIN


def _copy_threads() -> int:
    env = os.environ.get("RAY_TPU_TORCH_COPY_THREADS")
    if env:
        try:
            return max(1, min(int(env), 16))
        except ValueError:
            pass
    return max(1, min(os.cpu_count() or 1, 4))


_NTHREADS = _copy_threads()
_pool = None
_pool_lock = threading.Lock()


def set_worker_mode() -> None:
    """Called once at worker-process start: sibling workers copy
    concurrently, so cross-process puts are ALREADY parallel — a full-size
    per-process pool just oversubscribes the cores (measured on a 2-core
    host: two concurrent 128 MiB putters aggregate 1.1 GiB/s with 2 copy
    threads each vs 5.0 GiB/s with 1). Sized for ~8 concurrent copiers;
    ``RAY_TPU_TORCH_COPY_THREADS`` still overrides."""
    global _NTHREADS
    if os.environ.get("RAY_TPU_TORCH_COPY_THREADS"):
        return
    with _pool_lock:
        if _pool is None:  # only before the pool exists
            _NTHREADS = max(1, min(4, (os.cpu_count() or 1) // 8))


class _CopyPool:
    """Persistent DAEMON worker threads (ThreadPoolExecutor's are
    non-daemon and would pin interpreter shutdown on the copy queue). One
    job per worker is the whole design — see module docstring."""

    def __init__(self, n: int):
        import queue

        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        for i in range(n):
            threading.Thread(
                target=self._worker, daemon=True, name=f"rt-copy-{i}"
            ).start()

    def _worker(self):
        while True:
            fn, args, box, done = self._q.get()
            try:
                fn(*args)
            except BaseException as e:  # noqa: BLE001 - reraised by run_all
                box.append(e)
            finally:
                done.set()

    def run_all(self, jobs) -> None:
        """Run [(fn, args), ...] across the workers; wait for all; reraise
        the first failure."""
        box: list = []
        events = []
        for fn, args in jobs:
            ev = threading.Event()
            events.append(ev)
            self._q.put((fn, args, box, ev))
        for ev in events:
            ev.wait()
        if box:
            raise box[0]


def _get_pool() -> _CopyPool:
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = _CopyPool(_NTHREADS)
    return _pool


def _addr_writable(mv: memoryview) -> Optional[int]:
    """Base address of a writable C-contiguous buffer, or None."""
    try:
        return ctypes.addressof(ctypes.c_char.from_buffer(mv))
    except (TypeError, ValueError, BufferError):
        return None


def _addr_readable(mv: memoryview) -> Optional[int]:
    """Base address of a (possibly read-only) C-contiguous buffer, or None.

    ``ctypes.from_buffer`` refuses read-only exporters (numpy array data,
    pickle-5 out-of-band buffers), so go through numpy, which does not.
    """
    try:
        import numpy as np

        a = np.frombuffer(mv, dtype=np.uint8)
        return int(a.ctypes.data)
    except Exception:
        return None


def copy_into(dest: memoryview, src) -> None:
    """Copy ``src`` (any contiguous bytes-like) into ``dest`` (a writable
    contiguous memoryview of the same length), releasing the GIL and using
    the copy pool for large payloads. Buffers must not overlap (ours never
    do: src is caller memory, dest a store mapping). Falls back to slice
    assignment whenever an address can't be obtained."""
    src_mv = src if isinstance(src, memoryview) else memoryview(src)
    if src_mv.format != "B" or src_mv.ndim != 1:
        src_mv = src_mv.cast("B")
    n = src_mv.nbytes
    if dest.nbytes != n:
        raise ValueError(f"copy_into: dest {dest.nbytes} != src {n} bytes")
    if n < _SLICE_MAX:
        dest[:] = src_mv
        return
    dst_addr = _addr_writable(dest)
    src_addr = _addr_readable(src_mv)
    if dst_addr is None or src_addr is None:
        dest[:] = src_mv
        return
    if n < _PARALLEL_MIN or _NTHREADS <= 1:
        ctypes.memmove(dst_addr, src_addr, n)
        return
    # exactly one contiguous chunk per pool thread; 64-byte aligned splits
    pool = _get_pool()
    nchunks = _NTHREADS
    chunk = ((n + nchunks - 1) // nchunks + 63) & ~63
    jobs = []
    lo = 0
    while lo < n:
        hi = min(n, lo + chunk)
        jobs.append((ctypes.memmove, (dst_addr + lo, src_addr + lo, hi - lo)))
        lo = hi
    pool.run_all(jobs)
    # src_mv/dest locals kept the exporting buffers alive through the copy


def iter_chunks(mv: memoryview, chunk: int = CHUNK_BYTES):
    """Yield contiguous slices of ``mv`` — the spill/restore streaming unit."""
    n = mv.nbytes
    for lo in range(0, n, chunk):
        yield mv[lo : min(lo + chunk, n)]


def prepare_map(m, length: int) -> None:
    """Allocation-time buffer prep for a fresh large mapping: ask for huge
    pages where the kernel supports them and fault pages in ahead of the
    copy loop. Every advice is best-effort — unsupported kernels just
    proceed to first-touch faulting inside the (parallel) copy."""
    import mmap as _mmap

    if length < _PARALLEL_MIN:
        return
    for advice in ("MADV_HUGEPAGE", "MADV_WILLNEED"):
        flag = getattr(_mmap, advice, None)
        if flag is None:
            continue
        try:
            m.madvise(flag)
        except (OSError, ValueError, AttributeError):
            pass


# ---------------------------------------------------------------------------
# stage timing registry (merged into the scheduler's event_stats RPC)
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
# name -> [count, total_seconds, total_bytes]
_stats: Dict[str, list] = {}


def record_stage(name: str, seconds: float, nbytes: int = 0) -> None:
    with _stats_lock:
        s = _stats.get(name)
        if s is None:
            _stats[name] = [1, seconds, nbytes]
        else:
            s[0] += 1
            s[1] += seconds
            s[2] += nbytes


def stage_stats() -> Dict[str, Tuple[int, float, int]]:
    """Snapshot: name -> (count, total_seconds, total_bytes)."""
    with _stats_lock:
        return {k: (v[0], v[1], v[2]) for k, v in _stats.items()}


def reset_stage_stats() -> None:
    with _stats_lock:
        _stats.clear()


class stage_timer:
    """``with stage_timer("store.put.copy", nbytes): ...`` — cheap enough
    for the put hot path (two perf_counter calls + one dict op)."""

    __slots__ = ("_name", "_nbytes", "_t0")

    def __init__(self, name: str, nbytes: int = 0):
        self._name = name
        self._nbytes = nbytes

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record_stage(self._name, time.perf_counter() - self._t0, self._nbytes)
        return False
