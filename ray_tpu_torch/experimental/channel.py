"""Mutable shared-memory channels: the compiled-DAG data plane.

Parity: the reference's mutable plasma objects + shm channels
(``src/ray/core_worker/experimental_mutable_object_manager.h``,
``python/ray/experimental/channel/shared_memory_channel.py:88``): a
fixed-capacity buffer written in place per execution instead of allocating a
new immutable object per call — the lock-free fast path that lets a compiled
actor pipeline run without per-hop RPC or store allocation.

Implementation: one mmap'd file per channel in the session's shm dir with a
seqlock header — writer bumps ``version`` to odd, copies the payload, bumps
to even; readers wait for a fresh even version and then validate it was
stable across their copy. Readers track the last version consumed so each
``read`` returns a *new* write (reference semantics: one read per write per
reader).

Cross-node edges use :class:`SocketChannelWriter` / :class:`SocketChannelReader`
— an authenticated point-to-point socket with the same one-slot
acquire-release semantics (writer blocks until the reader acks the previous
payload), playing the role of the reference's cross-node mutable-object
forwarding (``experimental_mutable_object_provider.h`` gRPC path).
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
import time
from typing import Any, Optional

from ray_tpu_torch._private import serialization

_HDR = struct.Struct("<QQQQ")  # version, payload_len, closed, consumed_version
_CLOSED = 1


class ChannelClosedError(Exception):
    pass


class Channel:
    """Single-writer multi-reader mutable channel."""

    def __init__(self, path: str, capacity: int = 4 * 1024 * 1024, create: bool = False):
        self.path = path
        self.capacity = capacity
        total = _HDR.size + capacity
        if create:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, total)
            finally:
                pass
        else:
            fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        self._mv = memoryview(self._mm)
        self._serde = serialization.get_context()
        self._last_read_version = 0

    # -- writer ------------------------------------------------------------

    def write(self, value: Any, timeout: Optional[float] = 60.0) -> None:
        """Acquire-release, one slot: blocks until the single reader has
        consumed the previous write (reference mutable-object semantics —
        the writer never overruns the reader)."""
        blob = self._serde.serialize_to_bytes(value)
        if len(blob) > self.capacity:
            raise ValueError(
                f"value ({len(blob)} bytes) exceeds channel capacity "
                f"({self.capacity}); recreate the channel larger"
            )
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.000_05
        while True:
            version, _, closed, consumed = _HDR.unpack_from(self._mv, 0)
            if closed:
                raise ChannelClosedError(self.path)
            if consumed >= version:
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"channel write timed out ({self.path})")
            time.sleep(delay)
            delay = min(delay * 2, 0.002)
        # seqlock: odd = write in progress
        _HDR.pack_into(self._mv, 0, version + 1, len(blob), 0, consumed)
        self._mv[_HDR.size : _HDR.size + len(blob)] = blob
        _HDR.pack_into(self._mv, 0, version + 2, len(blob), 0, consumed)

    # -- reader ------------------------------------------------------------

    def read(self, timeout: Optional[float] = 10.0) -> Any:
        """Block until a write newer than the last one read; returns value
        and releases the slot back to the writer."""
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.000_05
        while True:
            version, length, closed, consumed = _HDR.unpack_from(self._mv, 0)
            if closed:
                raise ChannelClosedError(self.path)
            if version % 2 == 0 and version > self._last_read_version:
                payload = bytes(self._mv[_HDR.size : _HDR.size + length])
                v2, _, _, _ = _HDR.unpack_from(self._mv, 0)
                if v2 == version:  # stable across the copy
                    self._last_read_version = version
                    # release the slot (single-reader ack)
                    _HDR.pack_into(self._mv, 0, version, length, 0, version)
                    return self._serde.deserialize_from(memoryview(payload))
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"channel read timed out ({self.path})")
            time.sleep(delay)
            delay = min(delay * 2, 0.002)

    def close(self) -> None:
        try:
            version, length, _, consumed = _HDR.unpack_from(self._mv, 0)
            _HDR.pack_into(self._mv, 0, version, length, _CLOSED, consumed)
        except (ValueError, OSError):
            pass

    def release(self) -> None:
        try:
            self._mv.release()
            self._mm.close()
        except (BufferError, OSError):
            pass

    def __reduce__(self):
        return (Channel, (self.path, self.capacity, False))


# -- cross-node channels -----------------------------------------------------

_FRAME_DATA = b"D"
_FRAME_CLOSE = b"C"
_FRAME_ACK = b"A"


class SocketChannelWriter:
    """Writer endpoint of a cross-node single-reader channel.

    One listener per edge (the reader dials this address), HMAC-challenge
    authenticated like every other socket in the framework. One-slot
    semantics: ``write`` blocks until the reader has acked the previous
    payload, so a slow consumer backpressures the producer exactly like the
    shm seqlock channel."""

    def __init__(self, auth_key: bytes):
        from multiprocessing.connection import Listener

        # every node of this runtime is on this host: loopback only
        self._listener = Listener(("127.0.0.1", 0), authkey=auth_key)
        self.address = tuple(self._listener.address)
        self._conn = None
        self._awaiting_ack = False
        self._serde = serialization.get_context()
        self._closed = False

    def _ensure_conn(self, timeout: Optional[float]):
        if self._conn is not None:
            return
        # honor the write timeout during the initial accept too — a reader
        # that never dials (stage failed to start) must not hang the writer
        sock = getattr(getattr(self._listener, "_listener", None), "_socket", None)
        if sock is not None and timeout is not None:
            sock.settimeout(timeout)
        try:
            self._conn = self._listener.accept()
            from ray_tpu_torch._private.object_transfer import set_nodelay

            set_nodelay(self._conn)
        except (TimeoutError, OSError) as e:
            if isinstance(e, OSError) and not isinstance(e, TimeoutError):
                raise
            raise TimeoutError(
                f"socket channel accept timed out ({self.address})"
            ) from e
        finally:
            if sock is not None:
                sock.settimeout(None)
        self._listener.close()

    def write(self, value: Any, timeout: Optional[float] = 60.0) -> None:
        if self._closed:
            raise ChannelClosedError(str(self.address))
        try:
            self._ensure_conn(timeout)
            if self._awaiting_ack:
                if not self._conn.poll(timeout):
                    raise TimeoutError(
                        f"socket channel write timed out ({self.address})"
                    )
                ack = self._conn.recv_bytes()
                if ack != _FRAME_ACK:
                    raise ChannelClosedError(str(self.address))
                self._awaiting_ack = False
            blob = self._serde.serialize_to_bytes(value)
            self._conn.send_bytes(_FRAME_DATA + blob)
            self._awaiting_ack = True
        except (EOFError, OSError, BrokenPipeError) as e:
            self._closed = True
            raise ChannelClosedError(str(self.address)) from e

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._ensure_conn(timeout=1.0)
            self._conn.send_bytes(_FRAME_CLOSE)
        except Exception:
            pass
        for c in (self._conn, self._listener):
            try:
                if c is not None:
                    c.close()
            except Exception:
                pass


class SocketChannelReader:
    """Reader endpoint: dials the writer's address; read() returns one
    payload per write and acks it (releasing the writer's slot)."""

    def __init__(self, address, auth_key: bytes):
        from multiprocessing.connection import Client

        self._conn = Client(tuple(address), authkey=auth_key)
        from ray_tpu_torch._private.object_transfer import set_nodelay

        set_nodelay(self._conn)
        self._serde = serialization.get_context()
        self._closed = False

    def read(self, timeout: Optional[float] = 10.0) -> Any:
        if self._closed:
            raise ChannelClosedError("socket channel closed")
        try:
            if not self._conn.poll(timeout):
                raise TimeoutError("socket channel read timed out")
            frame = self._conn.recv_bytes()
            if frame[:1] == _FRAME_CLOSE:
                self._closed = True
                raise ChannelClosedError("socket channel closed by writer")
            value = self._serde.deserialize_from(memoryview(frame)[1:])
            self._conn.send_bytes(_FRAME_ACK)
            return value
        except (EOFError, OSError, BrokenPipeError) as e:
            self._closed = True
            raise ChannelClosedError("socket channel peer died") from e

    def close(self) -> None:
        self._closed = True
        try:
            self._conn.close()
        except Exception:
            pass


def node_shm_dir() -> Optional[str]:
    """This process's node-local shm dir — processes that share it can use
    shm channels; otherwise edges go over socket channels."""
    from ray_tpu_torch._private.worker import get_runtime

    rt = get_runtime()
    if hasattr(rt, "node"):  # driver
        return rt.node.shm_dir
    return getattr(rt, "shm_dir", None)


def create_writer(kind: str, edge_id: str, auth_key: bytes, capacity: int,
                  shm_dir: Optional[str] = None):
    """Create the writer endpoint of an edge; returns (endpoint, spec). The
    spec travels to the reader, which opens it with open_reader."""
    if kind == "shm":
        path = os.path.join(shm_dir or tempfile.gettempdir(), "channels", edge_id)
        return Channel(path, capacity, create=True), ("shm", path)
    if kind == "sock":
        w = SocketChannelWriter(auth_key)
        return w, ("sock", w.address)
    raise ValueError(kind)


def open_reader(spec, auth_key: bytes, capacity: int):
    kind, arg = spec
    if kind == "shm":
        return Channel(arg, capacity, create=False)
    if kind == "sock":
        return SocketChannelReader(arg, auth_key)
    raise ValueError(kind)
