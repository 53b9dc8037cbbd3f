"""DataIterator: the per-trainer-worker consumption handle.

Parity: ``python/ray/data/iterator.py`` (``DataIterator.iter_batches``,
``iter_torch_batches``). A copy of ``ray_tpu/data/iterator.py`` whose
device feed is ``iter_torch_batches``: it takes the role of the
reference's ``iter_jax_batches`` (``device_put`` of each batch, with an
optional sharding). On a CUDA device each column is staged in pinned host
memory and copied ``non_blocking`` on a CUDA stream that the iterator
owns; the consumer's current stream waits on the copy's event, so the copy
runs beside whatever the consumer's stream still has queued (the overlap
that JAX's asynchronous ``device_put`` gives the reference). The
reference's ``iter_tf_batches`` has no counterpart (no TensorFlow).

This is also the training step plane's ingest seam: when a step timer is
active (``_private/stepplane``), time spent blocked in ``next()`` lands in
the step's ``data_wait`` stage — attributed to the bottleneck streaming-
executor operator via the pipeline's live backpressure stats — the host
side of ``iter_torch_batches``' transfer (staging and enqueueing the
copies) in ``host_to_device``, and every batch's abstract-shape signature
feeds the recompilation detector.
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Any, Dict, Iterator, Optional

import numpy as np

# ingest stalls shorter than this are loop noise, not backpressure — they
# accrue to data_wait but skip the per-operator attribution walk
_ATTRIBUTE_STALL_S = 0.002


class DataIterator:
    def __init__(self, dataset):
        self._ds = dataset

    def _bottleneck_operator(self) -> str:
        """The streaming-executor stage the consumer is most plausibly
        waiting on RIGHT NOW: the stage with the deepest in-flight window
        (its backpressure queue is where the pipeline's slack went). Falls
        back to "source" when the dataset has no live execution stats
        (materialized datasets, plain block lists)."""
        stats = getattr(self._ds, "_exec_stats", None) or ()
        best, depth = None, 0
        for st in stats:
            try:
                inflight = st.inflight
            except Exception:
                continue
            if inflight > depth:
                best, depth = st.name, inflight
        return best or "source"

    def iter_batches(self, *, batch_size: int = 256, drop_last: bool = False):
        from ray_tpu_torch._private import stepplane

        it = iter(
            self._ds.iter_batches(batch_size=batch_size, drop_last=drop_last)
        )
        while True:
            timer = stepplane.current()  # re-read: a step may start mid-iter
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            if timer is not None:
                wait = time.perf_counter() - t0
                timer.note_data_wait(
                    wait,
                    self._bottleneck_operator()
                    if wait >= _ATTRIBUTE_STALL_S
                    else None,
                )
                timer.note_batch_signature(stepplane.batch_signature(batch))
            yield batch

    def iter_rows(self):
        return self._ds.iter_rows()

    def count(self) -> int:
        return self._ds.count()

    def materialize(self):
        return self._ds.materialize()

    def iter_torch_batches(
        self,
        *,
        batch_size: int = 256,
        drop_last: bool = False,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Optional[Any] = None,
        sharding: Optional[Any] = None,
        mesh: Optional[Any] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Batches as dicts of torch tensors on ``device`` (default
        ``"cuda"``, which raises without a card; the CPU takes
        ``device="cpu"``). ``dtypes`` maps columns to torch dtypes; the
        cast runs after the copy, on the consumer's stream. ``sharding``
        (a ``ray_tpu_torch.parallel.sharding.PartitionSpec``) with ``mesh``
        (a ``Mesh``) keeps this rank's block of every column
        (``shard_tensor``) and places it on the mesh's device, as the
        reference's ``sharding`` does with a global batch.

        On a CUDA device each batch's columns are staged in pinned host
        memory and copied ``non_blocking`` on the iterator's copy stream;
        the current stream waits on the copy's event and ``record_stream``
        ties each tensor's memory to it, so the caching allocator does not
        hand the memory out while the consumer still reads it. Staging
        buffers come from PyTorch's pinned-memory cache, which records an
        event on the copy stream and hands a buffer out again only once
        the copy that read it has completed."""
        import torch

        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch._private import stepplane

        if sharding is not None:
            if mesh is None:
                raise ValueError("iter_torch_batches: sharding= needs mesh=")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(
                    f"iter_torch_batches: device {device!r} is not the mesh's "
                    f"device {mesh.device}"
                )
            dev = mesh.device
        else:
            dev = resolve_device("cuda" if device is None else device)
        feed = None
        if dev.type == "cuda":
            feed = self._feed = _CudaFeed(dev)
        for batch in self.iter_batches(batch_size=batch_size, drop_last=drop_last):
            t0 = time.perf_counter()
            out = {}
            for k, v in batch.items():
                t = _host_view(v)
                if sharding is not None:
                    from ray_tpu_torch.parallel.sharding import shard_tensor

                    t = shard_tensor(t, sharding, mesh)
                out[k] = t
            if feed is not None:
                out = feed.put(out)
            else:
                # the caller's tensors never view the store's read-only
                # blocks
                out = {
                    k: (t if np.asarray(batch[k]).flags.writeable else t.clone()).to(dev)
                    for k, t in out.items()
                }
            if dtypes:
                out = {k: t.to(dtypes[k]) if k in dtypes else t for k, t in out.items()}
            timer = stepplane.current()
            if timer is not None:
                timer.note_host_to_device(time.perf_counter() - t0)
            yield out

    def copy_stats(self) -> Dict[str, float]:
        """The CUDA feed of the last ``iter_torch_batches`` so far:
        ``batches``, ``bytes`` and ``copy_ms``, the copy stream's time from
        each batch's first copy to its last (CUDA events; waits for the
        copies still in flight). Zeros before any CUDA feed ran."""
        feed = getattr(self, "_feed", None)
        if feed is None:
            return {"batches": 0, "bytes": 0, "copy_ms": 0.0}
        return feed.stats()


def _host_view(v) -> "Any":
    """A CPU tensor over a batch column, without a copy. The store's
    blocks are read-only numpy views: torch warns that it cannot protect
    them, and the callers here never write through the view."""
    import torch

    arr = np.asarray(v)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


class _CudaFeed:
    """One ``iter_torch_batches`` pass's copy stream and its transfer
    accounting (CUDA events around each batch's copies)."""

    # (start, done) event pairs kept unread before the oldest are folded
    _PENDING = 16

    def __init__(self, device):
        import torch

        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.batches = 0
        self.bytes = 0
        self.copy_ms = 0.0
        self._pending: deque = deque()

    def put(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        import torch

        consumer = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        staged = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
                  for k, t in batch.items()}
        nbytes = sum(t.numel() * t.element_size() for t in staged.values())
        with torch.cuda.stream(self.stream):
            # allocate first: the events time the copies alone
            out = {k: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                   for k, t in staged.items()}
            start.record(self.stream)
            for k, t in staged.items():
                out[k].copy_(t, non_blocking=True)
            done.record(self.stream)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        self.batches += 1
        self.bytes += nbytes
        self._pending.append((start, done))
        while len(self._pending) > self._PENDING or (
            self._pending and self._pending[0][1].query()
        ):
            self._fold()
        return out

    def _fold(self) -> None:
        start, done = self._pending.popleft()
        done.synchronize()
        self.copy_ms += start.elapsed_time(done)

    def stats(self) -> Dict[str, float]:
        while self._pending:
            self._fold()
        return {"batches": self.batches, "bytes": self.bytes, "copy_ms": self.copy_ms}
