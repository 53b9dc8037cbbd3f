"""Python client for the C++ shm-arena object store.

Same interface as ``ray_tpu_torch._private.object_store.ObjectStoreClient``; the
data path is the native arena (``ray_tpu_torch/native/object_store.cc``), with the
file-per-object store as fallback allocator when the arena is full (parity:
plasma's fallback allocation to disk).
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Dict, Optional, Set, Tuple

from ray_tpu_torch._private import fastcopy, memplane, netplane
from ray_tpu_torch._private.fastcopy import stage_timer
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import ObjectStoreClient, StoreFullError, StorePutMixin


class _Pin:
    """Holder of one store pin over an arena payload; released on GC.

    Deserialized numpy views keep the exporting buffer — and therefore this
    object — alive; GC of the last view releases the pin, letting the
    store's deferred delete reclaim the block. This mirrors plasma's
    client-held object references (``plasma_store_provider.h:88``): memory is
    never reused under a live zero-copy view.
    """

    __slots__ = ("_lib", "_h", "_id")

    def __init__(self, lib, handle, id_bytes: bytes):
        self._lib = lib
        self._h = handle
        self._id = id_bytes

    def __del__(self):
        try:
            self._lib.rt_store_release(self._h, self._id)
        except Exception:
            pass


# ctypes array subclasses keyed by payload size: a plain ``ctypes.c_char *
# n`` instance can't carry the pin, and the ``__buffer__`` protocol (PEP
# 688) only exists on Python 3.12+ — a subclass instance accepts the
# attribute AND exports the buffer on every supported Python.
_PIN_ARR_CLASSES: Dict[int, type] = {}
_PIN_ARR_LOCK = threading.Lock()


def pinned_view(lib, handle, id_bytes: bytes, base: int, off: int, size: int) -> memoryview:
    """Read-only zero-copy view over an arena payload whose lifetime carries
    the store pin taken by ``rt_store_get``: view (or anything deserialized
    from it) GC'd → pin released → deferred delete may reclaim the block.

    Read-only is the get-side aliasing contract: the arena mapping itself is
    writable in every client, so without it a consumer mutating a
    deserialized numpy array would corrupt the sealed shared copy."""
    with _PIN_ARR_LOCK:
        cls = _PIN_ARR_CLASSES.get(size)
        if cls is None:
            if len(_PIN_ARR_CLASSES) > 4096:  # unbounded size diversity guard
                _PIN_ARR_CLASSES.clear()
            cls = type("_PinnedArr", (ctypes.c_char * size,), {})
            _PIN_ARR_CLASSES[size] = cls
    try:
        arr = cls.from_address(base + off)
        arr._pin = _Pin(lib, handle, id_bytes)
    except Exception:
        lib.rt_store_release(handle, id_bytes)  # the get's pin must not leak
        raise
    return memoryview(arr).cast("B").toreadonly()


class NativeStoreClient(StorePutMixin):
    # negative external-miss cache entries re-probe after this long even if
    # the marker file looks identical (see contains())
    _EXTERNAL_MISS_TTL_S = 5.0

    def __init__(
        self,
        lib,
        arena_path: str,
        fallback: ObjectStoreClient,
        capacity: int,
        spill_uri: str = "",
    ):
        self._lib = lib
        self._fallback = fallback
        self._capacity = capacity
        # external spill target (scheme:// URI): evicted objects go to the
        # storage backend instead of the local fallback dir (parity:
        # external_storage.py spill to FS/S3). Sidecar .uri markers in the
        # shm dir let every same-node client restore them.
        self._spill_uri = spill_uri
        self._shm_dir = os.path.dirname(arena_path)
        table_size = max(4096, min(1 << 20, capacity // (64 * 1024)))
        self._h = lib.rt_store_open(arena_path.encode(), capacity, table_size, 1)
        if not self._h:
            raise OSError(f"could not open native store arena at {arena_path}")
        self._base = lib.rt_store_base(self._h)
        self._creating: Dict[ObjectID, bool] = {}  # id -> in_arena
        # oids whose spill marker points at a backend THIS process
        # definitively cannot read (e.g. another process's memory://):
        # fail-fast locally without touching the shared marker. Keyed by
        # the marker's (mtime_ns, inode, size) — the atomic tmp+rename that
        # writes a marker always produces a fresh inode, so a re-spill is
        # detected even when the rewritten marker has identical content and
        # a same-granularity timestamp — plus a short TTL so a stale entry
        # can never wedge waiters into spurious object-lost failures.
        self._external_miss: Dict[ObjectID, Tuple[tuple, float]] = {}
        self._lock = threading.Lock()
        self._closed = False
        # arena prefault is lazy: kicked off by the first LARGE create so
        # the many short-lived small-object sessions (tests, control planes)
        # never pay background fault work they don't need
        self._prefault_started = False

    # -- helpers -----------------------------------------------------------

    def _view(self, offset: int, size: int) -> memoryview:
        buf = (ctypes.c_char * size).from_address(self._base + offset)
        return memoryview(buf).cast("B")

    def _prefault_async(self) -> None:
        """Allocation-time buffer prep: fault the arena's free space in from
        a background thread (one bounded slab per lock hold) so large-object
        copies hit resident pages instead of serializing first-touch faults
        inside the copy loop (measured here: an unprepped 128 MiB first put
        runs ~40× slower than a prepped one). The cursor lives in the shared
        arena header, so the work happens once per arena no matter how many
        clients open it. Budgeted against the shm filesystem's free space;
        kill switch via env."""
        with self._lock:
            if self._prefault_started:
                return  # lost the race: exactly one prefault thread per client
            self._prefault_started = True
        if os.environ.get("RAY_TPU_TORCH_DISABLE_PREFAULT"):
            return
        if not hasattr(self._lib, "rt_store_prefault"):
            return  # stale .so without the export
        try:
            st = os.statvfs(self._shm_dir)
            free = st.f_bavail * st.f_frsize
        except OSError:
            return
        margin = max(64 * 1024 * 1024, (st.f_blocks * st.f_frsize) // 20)
        # default: the whole arena (it is declared capacity — a large-object
        # workload WILL touch it, and faulting lazily inside the copy loop
        # is the slowest possible place to do it), still bounded by half the
        # shm filesystem's free space so co-tenant stores keep headroom
        budget = min(self._capacity, max(0, (free - margin) // 2))
        try:
            cap_mb = int(os.environ.get("RAY_TPU_TORCH_ARENA_PREFAULT_MB", ""))
            budget = min(budget, cap_mb * 1024 * 1024)
        except ValueError:
            pass
        if budget <= 0:
            return

        def run():
            # 2 MiB slabs: on hosts where fresh tmpfs pages fault slowly the
            # arena lock is held ~tens of ms per slab — small slabs keep
            # concurrent create/seal latency bounded
            step = 2 * 1024 * 1024
            done = 0
            while done < budget and not self._closed:
                try:
                    n = self._lib.rt_store_prefault(self._h, min(step, budget - done))
                except Exception:
                    return
                if not n:
                    return  # cursor reached the end (or nothing free)
                done += n
                # brief sleep so concurrent create/seal can win the arena
                # lock — a tight loop re-grabs it before they wake (first
                # puts measured 100x slower under that starvation)
                time.sleep(0.0002)

        threading.Thread(target=run, daemon=True, name="arena-prefault").start()

    def _marker_key(self, oid: ObjectID) -> Optional[tuple]:
        """Identity of the current spill marker file (None = no marker)."""
        try:
            st = os.stat(self._spill_marker(oid))
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_ino, st.st_size)

    # -- ObjectStoreClient interface --------------------------------------

    def create(self, oid: ObjectID, size: int) -> memoryview:
        if size >= fastcopy.LARGE_OBJECT_MIN and not self._prefault_started:
            self._prefault_async()
        err = ctypes.c_int(0)
        off = self._lib.rt_store_create(self._h, oid.binary(), size, ctypes.byref(err))
        if not off and err.value == 2:
            # arena full: spill LRU sealed objects to the file store, then
            # evict them, until the allocation fits (parity: plasma eviction
            # + LocalObjectManager spilling, local_object_manager.h:41).
            # Objects too large to ever fit skip straight to the fallback.
            if size + (1 << 20) < self._capacity:
                while self._spill_one_lru():
                    off = self._lib.rt_store_create(
                        self._h, oid.binary(), size, ctypes.byref(err)
                    )
                    if off or err.value != 2:
                        break
        if off:
            with self._lock:
                self._creating[oid] = True
            return self._view(off, size)
        if err.value == 1:
            raise ValueError(f"object {oid.hex()} already exists")
        # arena (still) full: fall back to the file store
        with self._lock:
            self._creating[oid] = False
        return self._fallback.create(oid, size)

    # -- external spill (scheme:// backends) ------------------------------

    def _spill_marker(self, oid: ObjectID) -> str:
        return os.path.join(self._shm_dir, f"spilled_{oid.hex()}.uri")

    def _spill_external(self, oid: ObjectID, src: memoryview) -> bool:
        from ray_tpu_torch._private import external_storage as storage

        uri = storage.join(self._spill_uri, f"{oid.hex()}.obj")
        try:
            # stream the sealed buffer in chunks straight from the arena
            # view — the old ``bytes(src)`` staged a full second copy of the
            # object in heap memory before a single byte hit the backend
            with stage_timer("store.spill.write", src.nbytes):
                storage.write_stream(uri, fastcopy.iter_chunks(src))
            # per-process tmp name: same-node clients can race on the same
            # LRU victim, and losing that race must not fail the caller's
            # put (the old local-spill path had the same tolerance)
            tmp = f"{self._spill_marker(oid)}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                fh.write(uri)
            os.replace(tmp, self._spill_marker(oid))
            return True
        except Exception:
            return os.path.exists(self._spill_marker(oid))

    def _external_spilled_uri(self, oid: ObjectID) -> Optional[str]:
        try:
            with open(self._spill_marker(oid)) as fh:
                return fh.read().strip()
        except OSError:
            return None

    def _note_external_miss(self, oid: ObjectID) -> None:
        # definitive miss (backends raise on transport errors, None means
        # not-found): remember it in a PROCESS-LOCAL negative cache so this
        # process's contains() flips False and its waiters fail fast instead
        # of polling to the object-lost timeout. Happens when the backend is
        # process-local (memory://) but the marker sits in the shared shm
        # dir — the marker itself must survive: it may be another process's
        # only pointer to a copy that IS restorable there, so unlinking it
        # would turn a local miss into cluster-wide data loss.
        key = self._marker_key(oid) or (0, 0, 0)
        self._external_miss[oid] = (key, time.monotonic())

    def _restore_external(self, oid: ObjectID) -> Optional[memoryview]:
        uri = self._external_spilled_uri(oid)
        if uri is None:
            return None
        from ray_tpu_torch._private import external_storage as storage

        # reinstate locally so repeat gets don't re-download a hot object
        # from the backend every time (the external copy stays the durable
        # one; delete() purges both). Preferred path: the backend streams
        # chunks straight into the store's create() buffer — no staging
        # bytes object. When create() loses a race or the store is full, the
        # same single download lands in a heap buffer instead (never a
        # second fetch). create/seal directly rather than put_bytes: its
        # duplicate-race handler consults contains(), which the spill
        # marker satisfies, and would recurse back here.
        created = False
        heap_buf: Optional[bytearray] = None

        def make_dest(size: int) -> Optional[memoryview]:
            nonlocal created, heap_buf
            try:
                view = self.create(oid, size)
                created = True
                return view
            except Exception:
                heap_buf = bytearray(size)
                return memoryview(heap_buf)

        def _abort_created():
            nonlocal created
            if created:
                try:
                    self.abort(oid)  # possibly part-filled: never seal it
                except Exception:
                    pass
                created = False

        t_read0 = time.perf_counter()
        try:
            with stage_timer("store.restore.read"):
                n = storage.read_into(uri, make_dest)
        except Exception:
            # transport error, NOT a definitive miss: the durable copy may
            # be intact — propagate (the old read_bytes path did the same)
            # rather than poisoning the negative cache with a false loss
            _abort_created()
            raise
        if n is None:
            _abort_created()
            heap_buf = None  # possibly part-filled: discard
        if created:
            try:
                self.seal(oid)
                mv = self.get(oid, timeout=0)
                if mv is not None:
                    self._external_miss.pop(oid, None)
                    memplane.note_restore(oid, n or 0)
                    # transfer plane: a spill restore IS a transfer
                    # (path=spill) — ledger record rides telemetry
                    netplane.record_read(
                        "spill", oid, n or 0,
                        time.perf_counter() - t_read0,
                    )
                    return mv
            except Exception:
                _abort_created()
        # fallback: the single download's heap copy (create race lost or
        # store full), or — only when the streaming read said not-found /
        # truncated — one plain bytes re-read to decide miss vs. data
        data = heap_buf if heap_buf is not None else storage.read_bytes(uri)
        if data is None:
            self._note_external_miss(oid)
            return None
        self._external_miss.pop(oid, None)
        memplane.note_restore(oid, len(data))
        netplane.record_read(
            "spill", oid, len(data), time.perf_counter() - t_read0
        )
        try:
            dest = self.create(oid, len(data))
            fastcopy.copy_into(dest, data)
            self.seal(oid)
            mv = self.get(oid, timeout=0)
            if mv is not None:
                return mv
        except Exception:
            pass
        return memoryview(data)

    def _spill_one_lru(self) -> bool:
        """Copy the LRU sealed+unpinned arena object into the file store (or
        the external storage backend when a spill URI is configured), then
        delete it from the arena. Returns False when nothing is evictable."""
        vid_buf = (ctypes.c_uint8 * ObjectID.SIZE)()
        if not self._lib.rt_store_lru_victim(self._h, vid_buf):
            return False
        vid_bytes = bytes(vid_buf)
        vid = ObjectID(vid_bytes)
        size = ctypes.c_uint64(0)
        off = self._lib.rt_store_get(self._h, vid_bytes, ctypes.byref(size))
        if off:
            try:
                src = self._view(off, size.value)
                if self._spill_uri:
                    if not os.path.exists(self._spill_marker(vid)):
                        if not self._spill_external(vid, src):
                            return False
                        memplane.note_spill(vid, size.value)
                elif not self._fallback.contains(vid):
                    try:
                        dest = self._fallback.create(vid, size.value)
                        with stage_timer("store.spill.copy", size.value):
                            fastcopy.copy_into(dest, src)
                        self._fallback.seal(vid)
                        memplane.note_spill(vid, size.value)
                    except ValueError:
                        pass  # concurrent spiller won the race
                    except FileNotFoundError:
                        # a concurrent delete() unlinked our in-flight
                        # .building: the object is dying anyway — evicting
                        # without a spill copy is exactly right
                        pass
                    except StoreFullError:
                        return False  # disk full too: stop evicting
            finally:
                self._lib.rt_store_release(self._h, vid_bytes)
        self._lib.rt_store_delete(self._h, vid_bytes)
        return True

    def seal(self, oid: ObjectID) -> None:
        with self._lock:
            in_arena = self._creating.pop(oid, None)
        if in_arena is None:
            raise ValueError(f"object {oid.hex()} not under creation by this client")
        if in_arena:
            if self._lib.rt_store_seal(self._h, oid.binary()) != 0:
                raise ValueError(f"seal({oid.hex()}) failed")
        else:
            self._fallback.seal(oid)

    def abort(self, oid: ObjectID) -> bool:
        """Drop an unsealed object this client created (plasma Abort)."""
        with self._lock:
            in_arena = self._creating.pop(oid, None)
        if in_arena is None:
            return False
        if in_arena:
            return self._lib.rt_store_abort(self._h, oid.binary()) == 0
        return self._fallback.abort(oid)

    def contains(self, oid: ObjectID) -> bool:
        if self._lib.rt_store_contains(self._h, oid.binary()):
            return True
        if self._spill_uri:
            cached = self._external_miss.get(oid)
            if cached is None:
                if os.path.exists(self._spill_marker(oid)):
                    return True
            else:
                # negative entry: honor it only while the marker identity
                # (mtime_ns, inode, size) is unchanged AND the entry is
                # fresh — a re-spill rewrites the marker via tmp+rename
                # (new inode), and the TTL re-probes even a byte-identical
                # marker so waiters can never wedge on a stale negative
                key, stamp = cached
                fresh = (time.monotonic() - stamp) < self._EXTERNAL_MISS_TTL_S
                current = self._marker_key(oid)
                if current is None:
                    self._external_miss.pop(oid, None)  # marker gone
                elif current != key or not fresh:
                    self._external_miss.pop(oid, None)
                    return True
        return self._fallback.contains(oid)

    def get(self, oid: ObjectID, timeout: Optional[float] = 0) -> Optional[memoryview]:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.0001
        while True:
            size = ctypes.c_uint64(0)
            off = self._lib.rt_store_get(self._h, oid.binary(), ctypes.byref(size))
            if off:
                # rt_store_get took a pin; the pinned view carries it and the
                # returned view (plus anything deserialized from it) keeps the
                # pin alive — deletes defer until the last view is GC'd
                return pinned_view(
                    self._lib, self._h, oid.binary(), self._base, off, size.value
                )
            mv = self._fallback.get(oid, timeout=0)
            if mv is not None:
                return mv
            if self._spill_uri:
                mv = self._restore_external(oid)
                if mv is not None:
                    return mv
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(delay)
            delay = min(delay * 2, 0.01)

    def release(self, oid: ObjectID) -> None:
        # pins are GC-driven (see _Pin); only the fallback needs explicit release
        self._fallback.release(oid)

    def delete(self, oid: ObjectID) -> None:
        self._external_miss.pop(oid, None)
        if self._spill_uri:
            uri = self._external_spilled_uri(oid)
            if uri is not None:
                from ray_tpu_torch._private import external_storage as storage

                try:
                    storage.delete(uri)
                except Exception:
                    pass
                try:
                    os.unlink(self._spill_marker(oid))
                except OSError:
                    pass
        # purge EVERY tier unconditionally: a retried put of a spilled
        # object can leave both an arena copy and a fallback file (create()
        # arbitrates against the arena only), so a success here must not
        # skip the fallback or the .obj file would leak
        self._lib.rt_store_delete(self._h, oid.binary())
        self._fallback.delete(oid)

    def usage_bytes(self) -> int:
        return int(self._lib.rt_store_used_bytes(self._h)) + self._fallback.usage_bytes()

    def usage_stats(self):
        """Arena used bytes count as sealed (the arena only holds created-
        or-sealed blocks; in-flight creates are a transient sliver), plus
        the file-store fallback's lock-consistent sealed/unsealed split."""
        out = self._fallback.usage_stats()
        out["sealed_bytes"] += int(self._lib.rt_store_used_bytes(self._h))
        return out

    def list_objects(self):
        return self._fallback.list_objects()  # arena listing: not yet exposed

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._fallback.close()
        # NOTE: the arena mapping stays alive for the process lifetime so
        # outstanding zero-copy views never dangle; rt_store_close is only
        # safe when no views exist, so we deliberately leak the mapping here.


def create_store_client(
    shm_dir: str, fallback_dir: str, capacity: int, spill_uri: str = ""
):
    """Factory: native arena client if the .so is available, else files.

    ``spill_uri`` (a ``scheme://`` target) redirects LRU eviction to an
    external storage backend instead of the local fallback dir."""
    fallback = ObjectStoreClient(shm_dir, fallback_dir, capacity)
    if os.environ.get("RAY_TPU_TORCH_DISABLE_NATIVE_STORE"):
        return fallback
    try:
        from ray_tpu_torch.native import load_native

        lib = load_native()
        if lib is None:
            return fallback
        arena_path = os.path.join(shm_dir, "arena")
        return NativeStoreClient(
            lib, arena_path, fallback, capacity, spill_uri=spill_uri
        )
    except Exception:
        return fallback
