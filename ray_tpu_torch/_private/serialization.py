"""Value serialization with zero-copy out-of-band buffers.

Design parity: the reference serializes with vendored cloudpickle plus
pickle-protocol-5 out-of-band buffers so numpy/arrow payloads are written into
plasma once and mapped zero-copy on read (``python/ray/_private/serialization.py``,
``python/ray/util/serialization.py``). We use the same scheme with a flat wire
format so the C++ store only ever sees one contiguous blob:

    [u32 nbufs][u64 pickled_len][u64 buf_len]*nbufs | pickle bytes | buf bytes...

Each out-of-band buffer is 64-byte aligned within the blob so a deserialized
numpy array view is aligned for dlpack/device_put.
"""

from __future__ import annotations

import collections
import io
import pickle
import struct
from typing import Any, Callable, List, Optional, Tuple

import cloudpickle

_ALIGN = 64
_HDR = struct.Struct("<IQ")


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class SerializationContext:
    """Per-process serializer with a custom-serializer registry.

    Mirrors ``ray.util.serialization.register_serializer``.
    """

    def __init__(self):
        self._custom: dict = {}
        self._pickler_cls = None  # cache, rebuilt on (de)registration

    def register_serializer(self, cls, *, serializer: Callable, deserializer: Callable):
        self._custom[cls] = (serializer, deserializer)
        self._pickler_cls = None

    def deregister_serializer(self, cls):
        self._custom.pop(cls, None)
        self._pickler_cls = None

    # -- wire format ------------------------------------------------------

    def serialize(self, value: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
        """Return (pickled_bytes, out_of_band_buffers)."""
        buffers: List[pickle.PickleBuffer] = []

        def buffer_callback(buf: pickle.PickleBuffer) -> bool:
            buffers.append(buf)
            return False  # do not serialize in-band

        sio = io.BytesIO()
        p = self._get_pickler_cls()(sio, protocol=5, buffer_callback=buffer_callback)
        p.dump(value)
        return sio.getvalue(), buffers

    def _get_pickler_cls(self):
        if self._pickler_cls is not None:
            return self._pickler_cls
        if not self._custom:
            self._pickler_cls = cloudpickle.Pickler
            return self._pickler_cls
        # Dispatch table scoped to a context-owned subclass, so custom
        # reducers never leak into cloudpickle's process-global table and
        # deregistration actually takes effect. (The C pickler snapshots
        # dispatch_table at construction, so it must be a class attribute
        # before instantiation.)
        custom_reducers = {}
        for cls, (ser, des) in self._custom.items():
            def make_reduce(ser=ser, des=des):
                def _reduce(obj):
                    return (_deserialize_custom, (cloudpickle.dumps(des), ser(obj)))
                return _reduce
            custom_reducers[cls] = make_reduce()
        base = getattr(cloudpickle.Pickler, "dispatch_table", None)
        table = (
            collections.ChainMap(custom_reducers, base)
            if base is not None
            else custom_reducers
        )
        self._pickler_cls = type(
            "_ContextPickler", (cloudpickle.Pickler,), {"dispatch_table": table}
        )
        return self._pickler_cls

    def serialized_size(self, pickled: bytes, buffers: List[pickle.PickleBuffer]) -> int:
        n = _HDR.size + 8 * len(buffers)
        n = _align(n + len(pickled))
        for b in buffers:
            n = _align(n + memoryview(b).nbytes)
        return n

    def write_to(self, pickled: bytes, buffers: List[pickle.PickleBuffer], dest: memoryview) -> int:
        """Write the flat blob into ``dest``; returns bytes written.

        Out-of-band buffer payloads go through the parallel GIL-releasing
        copy pool (``fastcopy.copy_into``) — for a multi-MiB numpy array
        this is the entire put data volume."""
        from ray_tpu_torch._private import fastcopy

        raw = [memoryview(b).cast("B") for b in buffers]
        off = _HDR.size + 8 * len(raw)
        _HDR.pack_into(dest, 0, len(raw), len(pickled))
        for i, b in enumerate(raw):
            struct.pack_into("<Q", dest, _HDR.size + 8 * i, b.nbytes)
        dest[off : off + len(pickled)] = pickled
        off = _align(off + len(pickled))
        for b in raw:
            fastcopy.copy_into(dest[off : off + b.nbytes], b)
            off = _align(off + b.nbytes)
        return off

    def serialize_to_bytes(self, value: Any) -> bytes:
        pickled, buffers = self.serialize(value)
        size = self.serialized_size(pickled, buffers)
        out = bytearray(size)
        self.write_to(pickled, buffers, memoryview(out))
        return bytes(out)

    def deserialize_from(self, src: memoryview) -> Any:
        """Zero-copy deserialize: returned arrays view into ``src``."""
        nbufs, plen = _HDR.unpack_from(src, 0)
        sizes = [struct.unpack_from("<Q", src, _HDR.size + 8 * i)[0] for i in range(nbufs)]
        off = _HDR.size + 8 * nbufs
        pickled = src[off : off + plen]
        off = _align(off + plen)
        bufs = []
        for s in sizes:
            bufs.append(src[off : off + s])
            off = _align(off + s)
        return pickle.loads(pickled, buffers=bufs)


def _deserialize_custom(pickled_deserializer: bytes, payload):
    return cloudpickle.loads(pickled_deserializer)(payload)


_context: Optional[SerializationContext] = None


def get_context() -> SerializationContext:
    global _context
    if _context is None:
        _context = SerializationContext()
    return _context
