"""A pool of rank processes that run jobs together.

One process per rank, started with the ``spawn`` method, joined into one
process group (``distributed.initialize``) and kept for many jobs:
``RankPool.run(fn, *args)`` calls ``fn(*args)`` on every rank and returns
the ranks' results in rank order. ``fn`` is sent by reference, so it must
be a module-level function of a module the ranks can import.

A job that raises on any rank, a rank that dies, or a job that outlasts its
timeout kills every rank and raises ``RankFailure``: one rank's fault never
leaves the others blocked in a collective. The next ``run`` starts fresh
ranks.

    with RankPool(4, device="cpu") as pool:       # gloo ranks
        losses = pool.run(train_one_step, seed)
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import time
import traceback
from typing import Any, Callable, List, Optional

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel import distributed


class RankFailure(RuntimeError):
    """A job failed, a rank died, or a job timed out; the pool was killed."""


def _rank_main(rank, world, address, device, conn) -> None:
    import torch

    # one intra-op thread a rank: ranks share the host's cores
    torch.set_num_threads(1)
    try:
        distributed.initialize(address, world, rank, device=device, timeout_s=120.0)
        conn.send(("ready", None))
        while True:
            job = conn.recv()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                result = fn(*args, **kwargs)
                status = "ok"
            except BaseException:  # reported to the caller, who kills the pool
                result, status = traceback.format_exc(), "error"
            conn.send((status, result))
    finally:
        distributed.shutdown()
        conn.close()


class RankPool:
    """``world_size`` rank processes on ``device`` (``"cuda"``, the
    default: NCCL, rank r on ``cuda:r``, and an error without a card;
    ``"cpu"``: gloo, one process group over the CPU).

    ``store_dir`` names a directory for a ``file://`` rendezvous (one new
    file per start); without it rank 0 listens on a free local port."""

    def __init__(
        self,
        world_size: int,
        *,
        device: DeviceLike = "cuda",
        store_dir: Optional[str] = None,
        timeout_s: float = 60.0,
    ):
        self.world_size = world_size
        self.device = resolve_device(device).type
        self.timeout_s = timeout_s
        self._store_dir = store_dir
        self._starts = 0
        self._procs: List[multiprocessing.Process] = []
        self._conns: List[multiprocessing.connection.Connection] = []

    def _address(self) -> str:
        self._starts += 1
        if self._store_dir is None:
            return f"127.0.0.1:{distributed.free_port()}"
        return "file://" + os.path.join(self._store_dir, f"rendezvous-{os.getpid()}-{self._starts}")

    def start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        address = self._address()
        for rank in range(self.world_size):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main,
                args=(rank, self.world_size, address, self.device, child),
                daemon=True,
            )
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        self._collect("start")

    def run(self, fn: Callable, *args: Any, timeout_s: Optional[float] = None, **kwargs: Any) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; the results in rank order."""
        if not self._procs:
            self.start()
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", str(fn)), timeout_s)

    def _collect(self, what: str, timeout_s: Optional[float] = None) -> List[Any]:
        deadline = time.monotonic() + (self.timeout_s if timeout_s is None else timeout_s)
        results: List[Any] = [None] * self.world_size
        pending = set(range(self.world_size))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self.close(kill=True)
                raise RankFailure(f"{what}: ranks {sorted(pending)} did not answer in time")
            waitables = [self._conns[r] for r in pending] + [self._procs[r].sentinel for r in pending]
            multiprocessing.connection.wait(waitables, timeout=left)
            for r in sorted(pending):
                try:
                    answer = self._conns[r].recv() if self._conns[r].poll() else None
                except EOFError:  # the rank closed its end: it is exiting
                    answer = None
                if answer is not None:
                    status, value = answer
                    if status == "error":
                        self.close(kill=True)
                        raise RankFailure(f"{what}: rank {r} raised:\n{value}")
                    results[r] = value
                    pending.discard(r)
                elif not self._procs[r].is_alive() or self._conns[r].closed:
                    self._procs[r].join(timeout=5)
                    code = self._procs[r].exitcode
                    self.close(kill=True)
                    raise RankFailure(f"{what}: rank {r} died (exit code {code})")
        return results

    def close(self, kill: bool = False) -> None:
        """Stop the ranks: ask them to leave, or (``kill``) terminate them."""
        if not kill:
            for conn in self._conns:
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for proc in self._procs:
            proc.join(timeout=0 if kill else 10)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

