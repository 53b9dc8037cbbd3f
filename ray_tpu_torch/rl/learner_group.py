"""Multi-process SPMD learner group (port of ``ray_tpu/rl/learner_group.py``).

Parity: ``rllib/core/learner/learner_group.py:154-174`` — N learner workers
updating one policy. Each learner is an actor of the port's runtime (one
device each: ``num_gpus=1`` on the card, or the CPU); the ranks join one
``torch.distributed`` process group (NCCL on GPUs, gloo on the CPU) through
the runtime's KV under the group's key, where the reference's join one
``jax.distributed`` mesh and run one jitted program over it.

Per step the group splits the host batch into per-rank shards along
the env axis and invokes ``update`` on every worker concurrently. Each rank
computes its shard's gradients with ``ray_tpu_torch.rl.impala``'s losses;
the gradients are all-reduced before the clipped Adam step, so every rank
applies the same step to the same parameters. Rank 0 returns the metrics,
the host params and the host optimizer state.

The loss is the reference's masked mean over the GLOBAL batch: a rank's
loss is its masked sum over its own lane count, so each rank weighs its
gradients and metrics by ``count / global_count`` (the counts are
all-reduced first) before the sum. Averaging the ranks' own means instead
would be wrong whenever their masks differ. The gradient norm that the clip
reads is the global gradient's, after the all-reduce.

Fault tolerance (parity: the learner-group restart of
``train/_internal/backend_executor.py``): a worker death surfaces as a
failed ``update`` round; :meth:`restart` tears the group down, rendezvous
under a fresh attempt-suffixed key, and restores the last known params and
optimizer state. A group of one rank is a one-rank process group too, so
it runs the same collectives as a larger one. The survivors of a death are blocked in the collective,
so their state cannot be asked for: the state salvaged is the one rank 0
returned with the last completed update, which is also the pre-batch
state of the failed one (no rank stepped), so re-feeding the batch applies
it once.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc

_DEATH_ERRORS = (exc.ActorDiedError, exc.ActorUnavailableError, exc.WorkerCrashedError)


@ray_tpu_torch.remote
class SPMDLearnerWorker:
    """One learner process; rank 0 is the metrics/params endpoint."""

    def __init__(self, rank: int, world: int, rdzv_key: str, builder_config: dict):
        from ray_tpu_torch._private.worker import get_runtime
        from ray_tpu_torch.parallel import distributed as dist

        self.rank, self.world = rank, world
        rt = get_runtime()
        coord = dist.rendezvous_via_kv(rt, rdzv_key, rank, world)
        # a GPU learner sees only its own card: cuda:0 in its process
        self.device = dist.initialize(coord, world, rank,
                                      device=builder_config.get("device", "cuda"), local_rank=0)
        if rank == 0:
            dist.release_rendezvous(rt, rdzv_key)
        self._build(builder_config)

    def _build(self, bc: dict) -> None:
        from ray_tpu_torch.rl.impala import resolve_loss
        from ray_tpu_torch.rl.models import init_mlp_policy, load_params
        from ray_tpu_torch.rl.optim import Adam

        self.optimizer = Adam(bc["lr"], grad_clip=bc["grad_clip"])
        if bc.get("init_params") is not None:
            self.params = load_params(bc["init_params"], self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(bc["seed"])
            self.params = init_mlp_policy(gen, bc["obs_dim"], bc["num_actions"], bc["hidden"],
                                          device=self.device)
        if bc.get("init_opt_state") is not None:
            self.opt_state = self.optimizer.load_state(bc["init_opt_state"], self.params,
                                                       self.device)
        else:
            self.opt_state = self.optimizer.init(self.params)
        self._loss = resolve_loss(bc.get("update_builder", "impala"))
        self._cfg_vals = bc["cfg_vals"]

    def _all_reduce(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum ``tensors`` over the ranks in one collective."""
        import torch.distributed as dist

        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view_as(t))
            at += t.numel()
        return out

    def update(self, local_batch: Dict[str, np.ndarray]):
        """One gang-executed SPMD step; all ranks must call concurrently."""
        from ray_tpu_torch.rl.optim import value_and_grad

        batch = {k: torch.tensor(v, device=self.device) for k, v in local_batch.items()}
        T = batch["actions"].shape[0]
        count = (batch["mask"].sum() * T).reshape(1)
        (total,) = self._all_reduce([count.clone()])
        _, metrics, grads = value_and_grad(self._loss, self.params, batch, self._cfg_vals)
        names = sorted(metrics)
        # this rank's share of the global masked mean
        weight = count / torch.clamp(total, min=1.0)
        parts = [g * weight for g in grads] + [(metrics[k].detach() * weight).reshape(1)
                                               for k in names]
        summed = self._all_reduce(parts)
        self.optimizer.step(self.params, summed[:len(grads)], self.opt_state)
        if self.rank != 0:
            return None
        host = {k: float(v) for k, v in zip(names, summed[len(grads):])}
        return host, self.host_params(), self.host_opt_state()

    def host_params(self):
        from ray_tpu_torch.rl.optim import to_numpy

        return to_numpy(self.params)

    def host_opt_state(self):
        from ray_tpu_torch.rl.optim import state_numpy

        return state_numpy(self.opt_state)

    def set_params(self, host_params) -> None:
        from ray_tpu_torch.rl.models import load_params

        self.params = load_params(host_params, self.device)

    def total_devices(self) -> int:
        return self.world


class _GroupFailed(Exception):
    """A learner died, or the gang wedged, during an update round."""


class SPMDLearnerGroup:
    """Handle to N gang-scheduled learner worker actors.

    ``builder_config`` holds ``cfg_vals``, ``update_builder`` (``"impala"``
    or ``"appo"``), ``obs_dim``, ``num_actions``, ``hidden``, ``lr``,
    ``grad_clip``, ``seed``, optionally ``init_params`` (a numpy tree) and
    ``device`` (``"cuda"``, the default, or ``"cpu"``). On ``"cuda"`` each
    learner asks for one GPU.
    """

    def __init__(
        self,
        num_workers: int,
        builder_config: dict,
        runtime_env: Optional[dict] = None,
        num_cpus_per_worker: float = 1.0,
        init_timeout_s: float = 300.0,
        update_timeout_s: float = 300.0,
    ):
        self.num_workers = num_workers
        self._builder_config = dict(builder_config)
        self._runtime_env = runtime_env
        self._num_cpus = num_cpus_per_worker
        self._init_timeout = init_timeout_s
        self._update_timeout = update_timeout_s
        self._attempt = 0
        self._params_cache = None
        self._opt_cache = None
        self.workers: List[Any] = []
        self.total_devices = 0
        self._start()

    def _start(self) -> None:
        key = f"torch_rl_learners_{uuid.uuid4().hex[:8]}_a{self._attempt}"
        opts: Dict[str, Any] = {"num_cpus": self._num_cpus}
        if str(self._builder_config.get("device", "cuda")).startswith("cuda"):
            opts["num_gpus"] = 1
        if self._runtime_env:
            opts["runtime_env"] = self._runtime_env
        bc = dict(self._builder_config)
        bc["init_params"] = self._params_cache if self._params_cache is not None \
            else bc.get("init_params")
        bc["init_opt_state"] = self._opt_cache
        self.workers = [
            SPMDLearnerWorker.options(**opts).remote(rank, self.num_workers, key, bc)
            for rank in range(self.num_workers)
        ]
        # barrier: every worker joined the process group and built its state
        counts = ray_tpu_torch.get(
            [w.total_devices.remote() for w in self.workers],
            timeout=self._init_timeout,
        )
        assert len(set(counts)) == 1, f"device-count disagreement: {counts}"
        self.total_devices = counts[0]
        if self._params_cache is None:
            self._params_cache = ray_tpu_torch.get(
                self.workers[0].host_params.remote(), timeout=self._init_timeout
            )
        if self._opt_cache is None:
            self._opt_cache = ray_tpu_torch.get(
                self.workers[0].host_opt_state.remote(), timeout=self._init_timeout
            )

    def split(self, batch: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Split the padded host batch into per-rank contiguous shards along
        the env axis (rank order is the shards' order)."""
        world = self.num_workers
        shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(world)]
        for k, v in batch.items():
            env_axis = 0 if k in ("last_values", "mask") else 1
            n = v.shape[env_axis]
            assert n % world == 0, f"{k}: env axis {n} not divisible by {world}"
            step = n // world
            for i in range(world):
                sl = [slice(None)] * v.ndim
                sl[env_axis] = slice(i * step, (i + 1) * step)
                shards[i][k] = v[tuple(sl)]
        return shards

    def _round(self, shards) -> list:
        """Run one update on every rank. A rank that dies fails the round at
        once (its peers are then blocked in the collective); a bare timeout
        gets one extended wait (the gang may be slow, not wedged: killing it
        could discard an applied update), a second one fails the round."""
        refs = [w.update.remote(s) for w, s in zip(self.workers, shards)]
        index = {r: i for i, r in enumerate(refs)}
        out: List[Any] = [None] * len(refs)
        pending = list(refs)
        extended = False
        deadline = time.monotonic() + self._update_timeout
        while pending:
            ready, pending = ray_tpu_torch.wait(
                pending, num_returns=1, timeout=max(0.0, deadline - time.monotonic())
            )
            if not ready:
                if extended:
                    raise _GroupFailed("update timed out twice")
                extended = True
                deadline = time.monotonic() + self._update_timeout
                continue
            for r in ready:
                try:
                    out[index[r]] = ray_tpu_torch.get(r, timeout=self._update_timeout)
                except _DEATH_ERRORS + (exc.TaskError,) as e:
                    raise _GroupFailed(f"learner rank {index[r]} failed: {e}") from e
        return out

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One SPMD step across the group; restarts the group when a round
        fails and re-feeds the batch once (the pre-batch params and
        optimizer state are restored, so it is not a double apply)."""
        shards = self.split(batch)
        try:
            out = self._round(shards)
        except _GroupFailed:
            self.restart()
            out = self._round(shards)
        metrics, self._params_cache, self._opt_cache = out[0]
        return metrics

    def cached_params(self):
        return self._params_cache

    def cached_opt_state(self):
        return self._opt_cache

    def set_params(self, host_params) -> None:
        self._params_cache = host_params
        ray_tpu_torch.get(
            [w.set_params.remote(host_params) for w in self.workers],
            timeout=self._update_timeout,
        )

    def restart(self) -> None:
        """Kill every worker and rebuild the gang under a fresh rendezvous
        key, restoring the params and optimizer state salvaged from rank 0's
        last update (parity: backend_executor's worker-group restart). The
        reference reads the optimizer state back from a surviving worker;
        here the survivors of a failed round are blocked in the collective,
        and rank 0 returns its state with every update instead."""
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self._attempt += 1
        self._start()

    def stop(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
