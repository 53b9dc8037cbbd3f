"""Socket and shared-memory helpers of the object plane: TCP_NODELAY on
framed sockets, the authenticated dial of direct-call listeners, this
machine's identity, and zero-copy reads of a same-host peer's store arena.

Design parity: the reference's object manager
(``src/ray/object_manager/object_manager.h:117``). Moving objects between
hosts (object servers, pull clients) belongs to cluster mode, a later slice
of this port: every node of this runtime shares the head's store.
"""

from __future__ import annotations

import logging
import os
import threading
from multiprocessing.connection import Client
from typing import Optional

from ray_tpu_torch._private.ids import ObjectID

logger = logging.getLogger(__name__)


def set_nodelay(conn) -> None:
    """Disable Nagle on an mp.connection TCP socket.

    Every control/object socket in the cluster frames small messages
    (mp.connection writes a length header then the body); with Nagle on,
    those interact with delayed ACKs into 40ms stalls per exchange. The
    reference's gRPC channels set TCP_NODELAY by default; do the same.
    Unix-domain/pipe connections have no fileno-level TCP and are skipped.
    """
    import socket

    try:
        s = socket.socket(fileno=os.dup(conn.fileno()))
    except (OSError, ValueError):
        return
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # not a TCP socket
    finally:
        s.close()


def _dial(addr, key):
    conn = Client(tuple(addr) if isinstance(addr, (list, tuple)) else addr, authkey=key)
    set_nodelay(conn)
    return conn


_MACHINE_ID = None


def machine_id() -> str:
    """Stable identity of THIS machine (boot id + hostname): two cluster
    nodes share it iff their /dev/shm is the same memory."""
    global _MACHINE_ID
    if _MACHINE_ID is None:
        import socket

        boot = ""
        try:
            with open("/proc/sys/kernel/random/boot_id") as fh:
                boot = fh.read().strip()
        except OSError:
            pass
        _MACHINE_ID = f"{boot}:{socket.gethostname()}"
    return _MACHINE_ID


# cached read-only attachments to same-host peers' arenas: shm_dir -> handle
_PEER_ARENAS: dict = {}
_PEER_ARENAS_LOCK = threading.Lock()


def _peer_arena(src_shm_dir: str):
    # the open is held under the lock: a double-open would leak the losing
    # rt_store handle. Failures are NOT cached — a transient EMFILE must not
    # permanently demote this peer to the byte-copy path.
    with _PEER_ARENAS_LOCK:
        handle = _PEER_ARENAS.get(src_shm_dir)
        if handle is not None:
            return handle
        try:
            from ray_tpu_torch.native import load_native

            lib = load_native()
            path = os.path.join(src_shm_dir, "arena")
            if lib is not None and os.path.exists(path):
                h = lib.rt_store_open(path.encode(), 0, 0, 0)
                if h:
                    handle = (lib, h, lib.rt_store_base(h))
                    _PEER_ARENAS[src_shm_dir] = handle
        except Exception:
            handle = None
        return handle


def read_peer_pinned(src_shm_dir: str, oid: ObjectID) -> Optional[memoryview]:
    """Zero-copy same-host read: a view straight over a colocated peer
    node's store memory. Arena objects carry a cross-process pin released
    when the last deserialized view is GC'd (the peer's deferred delete
    honors it); .obj-file objects ride the mmap's lifetime. None when the
    peer doesn't hold a sealed copy reachable this way.

    This is the plasma model: on one machine, every worker reads THE shared
    memory — only cross-host reads move bytes.
    """
    import mmap

    p = os.path.join(src_shm_dir, oid.hex() + ".obj")
    if os.path.exists(p):
        try:
            with open(p, "rb") as fh:
                m = mmap.mmap(fh.fileno(), 0, prot=mmap.PROT_READ)
            mv = memoryview(m)
            size = int.from_bytes(mv[:8], "little")
            return mv[16 : 16 + size]  # slice keeps the mapping alive
        except (OSError, ValueError):
            return None
    handle = _peer_arena(src_shm_dir)
    if handle is None:
        return None
    lib, h, base = handle
    import ctypes

    from ray_tpu_torch._private.native_store import pinned_view

    size = ctypes.c_uint64(0)
    off = lib.rt_store_get(h, oid.binary(), ctypes.byref(size))
    if not off:
        return None
    return pinned_view(lib, h, oid.binary(), base, off, size.value)


