"""Shared-memory object store (plasma equivalent).

Design parity: the reference's plasma store (``src/ray/object_manager/plasma/``,
``store.h:55``) is an mmap-arena + dlmalloc shared-memory store with sealed-object
semantics, LRU eviction and fallback allocation to disk. Here every object is a
file in ``/dev/shm/<session>/`` mapped with mmap:

* ``create`` opens ``<hex>.building`` and maps it writable;
* ``seal`` atomically renames to ``<hex>.obj`` — the rename is the cross-process
  "sealed" visibility barrier (plasma uses a client notification protocol);
* ``get`` maps ``<hex>.obj`` read-only, zero-copy;
* fallback allocation: when /dev/shm is full, objects land in the session spill
  dir on disk (same mmap interface) — mirroring plasma's fallback allocator.

A per-process client tracks its open maps so deserialized numpy views stay
valid until ``release``. Eviction (LRU over sealed, unpinned objects) is driven
by the owner's reference counter, as in the reference (primary-copy pinning in
``local_object_manager.h:41``).
"""

from __future__ import annotations

import mmap
import os
import threading
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private import fastcopy
from ray_tpu_torch._private.fastcopy import stage_timer
from ray_tpu_torch._private.ids import ObjectID

_HEADER = 16  # [u64 data_size][u64 flags]


class StoreFullError(Exception):
    pass


class StorePutMixin:
    """Shared idempotent put; both store clients implement create/seal/contains.

    Every stage of the large-object pipeline (serialize → alloc → copy →
    seal) is timed into the ``fastcopy`` stage registry, surfaced by the
    scheduler's ``event_stats`` RPC — the put-bandwidth budget is
    attributable per stage instead of one opaque number."""

    def put_bytes(self, oid: ObjectID, data: bytes) -> None:
        # idempotent: a retried task re-stores the same deterministic return
        # id; object values are immutable so the first sealed copy wins.
        # create() is the atomic arbiter (raises ValueError on an existing
        # sealed object), so no contains() pre-check — fresh oids are the
        # overwhelming case and the pre-probe cost filesystem stats per put
        try:
            with stage_timer("store.put.alloc"):
                buf = self.create(oid, len(data))
        except ValueError:
            if self.contains(oid):
                return  # lost the race to a concurrent identical store
            raise  # a live creator owns it, or an unreclaimable orphan: loud
        with stage_timer("store.put.copy", len(data)):
            fastcopy.copy_into(buf, data)
        with stage_timer("store.put.seal"):
            self.seal(oid)

    def put_serialized(self, oid: ObjectID, serde, value) -> int:
        """Serialize straight into the store buffer (one copy fewer than
        serialize-to-bytes + put_bytes; parity: plasma clients write into the
        create()d buffer, ``plasma_store_provider.h:88``). Returns the
        sealed size in bytes (the head records it for locality-aware
        dispatch and transfer accounting)."""
        with stage_timer("store.put.serialize"):
            pickled, buffers = serde.serialize(value)
            size = serde.serialized_size(pickled, buffers)
        try:
            with stage_timer("store.put.alloc"):
                buf = self.create(oid, size)
        except ValueError:
            if self.contains(oid):
                return size  # duplicate store (task retry): first copy wins
            raise
        with stage_timer("store.put.copy", size):
            serde.write_to(pickled, buffers, buf)
        with stage_timer("store.put.seal"):
            self.seal(oid)
        return size


class ObjectStoreClient(StorePutMixin):
    """Client handle to the shm store; safe to use from one process."""

    def __init__(self, shm_dir: str, fallback_dir: str, capacity: int):
        self._shm_dir = shm_dir
        self._fallback_dir = fallback_dir
        self._capacity = capacity
        os.makedirs(shm_dir, exist_ok=True)
        os.makedirs(fallback_dir, exist_ok=True)
        # open maps: id -> (mmap, memoryview, writable)
        self._maps: Dict[ObjectID, Tuple[mmap.mmap, memoryview, bool]] = {}
        self._lock = threading.Lock()

    # -- paths ------------------------------------------------------------

    def _path(self, oid: ObjectID, sealed: bool, fallback: bool = False) -> str:
        base = self._fallback_dir if fallback else self._shm_dir
        return os.path.join(base, oid.hex() + (".obj" if sealed else ".building"))

    def _find_sealed(self, oid: ObjectID) -> Optional[str]:
        p = self._path(oid, True)
        if os.path.exists(p):
            return p
        p = self._path(oid, True, fallback=True)
        if os.path.exists(p):
            return p
        return None

    def _reserve_shm(self, total: int) -> None:
        """Raise OSError when the allocation would overrun the store budget.

        Cheap checks only (this is the put hot path): the filesystem must
        keep a safety margin of free space, and allocations over 8 MiB are
        additionally charged against the configured capacity (small objects
        can't meaningfully overrun it between large-object scans).
        """
        try:
            st = os.statvfs(self._shm_dir)
            free = st.f_bavail * st.f_frsize
            fs_size = st.f_blocks * st.f_frsize
        except OSError:
            return
        # safety margin scales with the filesystem (64 MiB shm in default
        # docker would otherwise never admit anything)
        margin = min(64 * 1024 * 1024, max(1024 * 1024, fs_size // 20))
        if free < total + margin:
            raise OSError(f"shm nearly full ({free} free, need {total})")
        if self._capacity and total > 8 * 1024 * 1024:
            # budget only the shm dir (spilled bytes must not poison the
            # budget forever) — scanned only on large allocations
            used = 0
            try:
                with os.scandir(self._shm_dir) as it:
                    for e in it:
                        try:
                            used += e.stat().st_size
                        except FileNotFoundError:
                            pass
            except FileNotFoundError:
                pass
            if used + total > self._capacity:
                raise OSError(f"store capacity {self._capacity} exceeded")

    # -- API --------------------------------------------------------------

    def create(self, oid: ObjectID, size: int) -> memoryview:
        """Allocate a writable buffer of ``size`` bytes; returns the data view."""
        if self._find_sealed(oid) is not None:
            raise ValueError(f"object {oid.hex()} already exists")
        total = _HEADER + size
        fallback = False
        path = self._path(oid, False)
        try:
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                self._reserve_shm(total)
                # posix_fallocate reserves pages now, so tmpfs exhaustion
                # surfaces here as ENOSPC -> disk fallback, instead of
                # SIGBUS on the first write into the sparse mapping
                os.posix_fallocate(fd, 0, total)
            except OSError:
                os.close(fd)
                os.unlink(path)
                raise StoreFullError(f"shm full allocating {total} bytes")
        except StoreFullError:
            fallback = True
            path = self._path(oid, False, fallback=True)
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                os.posix_fallocate(fd, 0, total)
            except OSError:
                os.close(fd)
                os.unlink(path)
                raise StoreFullError(
                    f"fallback dir full allocating {total} bytes"
                )
        except FileExistsError:
            # a .building file with no live writer (creator crashed between
            # create and seal) is reclaimed after a grace period so retried
            # tasks can re-store the deterministic return id
            try:
                age = time.time() - os.stat(path).st_mtime
            except FileNotFoundError:
                age = None
            if age is not None and age > 10.0:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                return self.create(oid, size)
            raise ValueError(f"object {oid.hex()} already being created")
        # allocation-time buffer prep: pages were reserved by fallocate, but
        # PTEs still fault on first touch — for large objects, populate them
        # in one syscall (and request huge pages where supported) so faults
        # don't serialize inside the copy loop
        if total >= fastcopy.LARGE_OBJECT_MIN and hasattr(mmap, "MAP_POPULATE"):
            m = mmap.mmap(fd, total, flags=mmap.MAP_SHARED | mmap.MAP_POPULATE)
        else:
            m = mmap.mmap(fd, total)
        fastcopy.prepare_map(m, total)
        os.close(fd)
        mv = memoryview(m)
        mv[:8] = size.to_bytes(8, "little")
        mv[8:16] = (1 if fallback else 0).to_bytes(8, "little")
        with self._lock:
            self._maps[oid] = (m, mv, True)
        return mv[_HEADER : _HEADER + size]

    def seal(self, oid: ObjectID) -> None:
        with self._lock:
            entry = self._maps.get(oid)
        if entry is None or not entry[2]:
            raise ValueError(f"object {oid.hex()} not under creation by this client")
        m, mv, _ = entry
        fallback = int.from_bytes(mv[8:16], "little") == 1
        src = self._path(oid, False, fallback)
        dst = self._path(oid, True, fallback)
        os.rename(src, dst)
        with self._lock:
            self._maps[oid] = (m, mv, False)

    def abort(self, oid: ObjectID) -> bool:
        """Drop an object this client created but will never seal (parity:
        plasma Abort) — a failed transfer must not leave a .building file
        that blocks every future create of the same deterministic id."""
        with self._lock:
            entry = self._maps.get(oid)
            if entry is None or not entry[2]:
                return False  # not ours, or already sealed
            del self._maps[oid]
        m, mv, _ = entry
        fallback = int.from_bytes(mv[8:16], "little") == 1
        try:
            mv.release()  # our own cached view would otherwise pin the map
            m.close()
        except (BufferError, ValueError):
            # a handed-out create() view is still alive; the unmap defers to
            # its GC — the file still goes away below
            pass
        try:
            os.unlink(self._path(oid, False, fallback))
        except FileNotFoundError:
            pass
        return True

    def contains(self, oid: ObjectID) -> bool:
        return self._find_sealed(oid) is not None

    def get(self, oid: ObjectID, timeout: Optional[float] = 0) -> Optional[memoryview]:
        """Zero-copy READ-ONLY view of a sealed object; None on timeout.

        Keep-alive contract: the returned view (and anything deserialized
        from it — numpy/arrow buffers reference their exporting view) pins
        the underlying mapping via this client's ``_maps`` table until
        ``release``/``delete``; sealed bytes are immutable, so every view is
        read-only — a consumer mutating a deserialized array gets a loud
        error instead of silently corrupting the shared copy."""
        with self._lock:
            entry = self._maps.get(oid)
            if entry is not None and not entry[2]:
                m, mv, _ = entry
                size = int.from_bytes(mv[:8], "little")
                return mv[_HEADER : _HEADER + size].toreadonly()
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.0001
        while True:
            path = self._find_sealed(oid)
            if path is not None:
                break
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(delay)
            delay = min(delay * 2, 0.01)
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            return None  # evicted between stat and open
        try:
            total = os.fstat(fd).st_size
            m = mmap.mmap(fd, total, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        mv = memoryview(m)
        size = int.from_bytes(mv[:8], "little")
        with self._lock:
            self._maps[oid] = (m, mv, False)
        return mv[_HEADER : _HEADER + size]

    def release(self, oid: ObjectID) -> None:
        """Drop this client's mapping (invalidates views)."""
        with self._lock:
            entry = self._maps.pop(oid, None)
        if entry is not None:
            m, mv, writable = entry
            try:
                mv.release()
                m.close()
            except BufferError:
                # live views (slices handed to concurrent readers, numpy
                # frombuffer) still reference the map. mv itself may already
                # be released, so re-register a FRESH view — caching the dead
                # one made the next get() blow up with "released memoryview"
                with self._lock:
                    self._maps[oid] = (m, memoryview(m), writable)

    def delete(self, oid: ObjectID) -> None:
        self.release(oid)
        for sealed in (True, False):
            for fallback in (False, True):
                try:
                    os.unlink(self._path(oid, sealed, fallback))
                except FileNotFoundError:
                    pass

    def usage_bytes(self) -> int:
        st = self.usage_stats()
        return st["sealed_bytes"] + st["unsealed_bytes"]

    def usage_stats(self) -> Dict[str, int]:
        """One consistent point-in-time usage snapshot, sealed vs unsealed
        split. ``unsealed_bytes`` are in-flight ``create`` allocations (a
        crashed creator's orphans age out via create()'s reclaim path).

        Lock-free on purpose (the 1 Hz watchdog + metrics scrapes call
        this; holding the client lock across an O(n) directory walk would
        stall every concurrent create/seal/get once per second). The
        seal-time ``.building`` → ``.obj`` rename can make a raw scan see
        BOTH names for one object — the transient that made the dashboard
        show usage > capacity — so entries are collected per object stem
        first and a stem seen sealed never also counts as unsealed."""
        out = {
            "sealed_bytes": 0,
            "unsealed_bytes": 0,
            "sealed_objects": 0,
            "unsealed_objects": 0,
            "fallback_bytes": 0,
        }
        for d in (self._shm_dir, self._fallback_dir):
            fallback = d == self._fallback_dir
            sealed: Dict[str, int] = {}
            unsealed: Dict[str, int] = {}
            try:
                with os.scandir(d) as it:
                    for e in it:
                        try:
                            size = e.stat().st_size
                        except FileNotFoundError:
                            continue
                        if e.name.endswith(".obj"):
                            sealed[e.name[:-4]] = size
                        elif e.name.endswith(".building"):
                            unsealed[e.name[:-9]] = size
                        # else: native arena file / spill .uri markers —
                        # not object payload (the arena's USED bytes are
                        # reported by the native client)
            except FileNotFoundError:
                continue
            for stem in sealed.keys() & unsealed.keys():
                del unsealed[stem]  # mid-rename duplicate: it IS sealed
            out["sealed_bytes"] += sum(sealed.values())
            out["unsealed_bytes"] += sum(unsealed.values())
            out["sealed_objects"] += len(sealed)
            out["unsealed_objects"] += len(unsealed)
            if fallback:
                out["fallback_bytes"] += sum(sealed.values()) + sum(
                    unsealed.values()
                )
        return out

    def list_objects(self):
        out = []
        for d in (self._shm_dir, self._fallback_dir):
            try:
                with os.scandir(d) as it:
                    for e in it:
                        if e.name.endswith(".obj"):
                            try:
                                out.append(
                                    (ObjectID.from_hex(e.name[:-4]), e.stat().st_size - _HEADER)
                                )
                            except (ValueError, FileNotFoundError):
                                pass
            except FileNotFoundError:
                pass
        return out

    def close(self) -> None:
        with self._lock:
            maps, self._maps = self._maps, {}
        for m, mv, _ in maps.values():
            try:
                mv.release()
                m.close()
            except BufferError:
                pass


def destroy_store(shm_dir: str) -> None:
    import shutil

    shutil.rmtree(shm_dir, ignore_errors=True)
