"""DataParallelTrainer: data-parallel training on a gang of worker actors.

Port of ``ray_tpu/train/jax_trainer.py`` (``JaxTrainer``), under upstream
Ray's name for it (``python/ray/train/data_parallel_trainer.py:25``), which
that file's docstring cites. ``fit()`` gang-schedules
``ScalingConfig.num_workers`` worker actors (``use_gpu=True``: one ``GPU``
each, so each worker's process sees its own card), runs the train loop on
every rank with ``train.report`` streaming metrics and checkpoints back,
commits checkpoints through the checkpoint plane, and restarts the gang
from the latest committed checkpoint up to ``FailureConfig.max_failures``
times.

``ScalingConfig(use_torch_distributed=True)`` makes every worker join one
``torch.distributed`` process group before the loop runs: the address is
agreed through the runtime's KV (``parallel.distributed.rendezvous_via_kv``)
and the group is NCCL for GPU workers, gloo for CPU workers
(``parallel.distributed.initialize``). This is the counterpart of the
reference's ``jax.distributed`` join (``_setup_jax_distributed``); the loop
then builds its mesh with ``parallel.mesh.create_mesh``. Unlike the
reference, a one-worker gang joins too (a one-rank group): the port's mesh
is built over a process group. Each attempt rendezvous under a fresh key,
which rank 0 drops from the KV once its process group is destroyed.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train._backend_executor import BackendExecutor
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._config import RunConfig, ScalingConfig
from ray_tpu_torch.train._result import Result


def _retry_backoff(attempt: int, fail_cfg) -> float:
    """Delay before gang-restart ``attempt`` (1-based): exponential from
    ``retry_backoff_s`` capped at ``retry_backoff_max_s``, with +/-
    ``retry_backoff_jitter`` fraction of randomization so crash-looping
    gangs desynchronize instead of hammering the scheduler in lockstep."""
    import random

    base = max(0.0, fail_cfg.retry_backoff_s)
    delay = base * (2 ** max(0, attempt - 1))
    jitter = min(1.0, max(0.0, fail_cfg.retry_backoff_jitter))
    if jitter:
        delay *= 1.0 + random.uniform(-jitter, jitter)
    # the cap is applied LAST: retry_backoff_max_s is a hard bound an
    # operator can rely on, jitter included
    return max(0.0, min(fail_cfg.retry_backoff_max_s, delay))


def _setup_torch_distributed(rendezvous_key: str, use_gpu: bool) -> None:
    """Join this rank to the gang's process group: rank 0 publishes an
    address through the runtime's KV, every rank joins it (NCCL on the
    worker's one visible card, or gloo on the CPU)."""
    from ray_tpu_torch._private.worker import get_runtime
    from ray_tpu_torch.parallel import distributed as dist
    from ray_tpu_torch.train._session import get_context

    ctx = get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    coord = dist.rendezvous_via_kv(get_runtime(), rendezvous_key, rank, world)
    # a GPU worker sees only its own card: it is cuda:0 in its process
    dist.initialize(
        coord, world, rank, device="cuda" if use_gpu else "cpu", local_rank=0
    )


def _teardown_torch_distributed(rendezvous_key: str) -> None:
    import torch.distributed

    from ray_tpu_torch._private.worker import get_runtime
    from ray_tpu_torch.parallel import distributed as dist
    from ray_tpu_torch.train._session import get_context

    try:
        # best-effort: a peer that finished first may already have torn its
        # side down, which must never overwrite a successful result
        dist.shutdown()
    except Exception:
        pass
    if get_context().get_world_rank() == 0 and not torch.distributed.is_initialized():
        # drop the published address once the group it names is gone: a
        # key left in the KV marks a group that was not destroyed
        dist.release_rendezvous(get_runtime(), rendezvous_key)


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        # name -> Dataset or DataIterator, read in the loop through
        # train.get_dataset_shard(name)
        self.datasets = datasets or {}
        if self.scaling_config.use_torch_distributed:
            self.train_loop = self._wrap_distributed(
                train_loop_per_worker, self.scaling_config.use_gpu
            )

    @staticmethod
    def _wrap_distributed(user_fn: Callable, use_gpu: bool) -> Callable:
        base_key = f"torchdist_{uuid.uuid4().hex[:12]}"

        def wrapped(config=None):
            import inspect

            # fit() injects a per-attempt suffix so a retry never rendezvous
            # against the dead address a failed attempt left in the KV
            if isinstance(config, dict):
                key = f"{base_key}_{config.pop('__torchdist_attempt__', 0)}"
            else:
                key = base_key
            _setup_torch_distributed(key, use_gpu)
            try:
                if config is not None and len(inspect.signature(user_fn).parameters):
                    return user_fn(config)
                return user_fn()
            finally:
                _teardown_torch_distributed(key)

        return wrapped

    def fit(self) -> Result:
        from ray_tpu_torch.train import checkpointing

        name = self.run_config.name or f"{type(self).__name__}_{time.strftime('%Y%m%d_%H%M%S')}"
        trial_dir = checkpointing.resolve_trial_dir(
            self.run_config.resolved_storage_path(), name
        )
        os.makedirs(trial_dir, exist_ok=True)

        ckpt_cfg = self.run_config.checkpoint_config
        manager = checkpointing.CheckpointManager(
            trial_dir,
            world_size=self.scaling_config.num_workers,
            keep=ckpt_cfg.num_to_keep,
            run_name=name,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        executor = BackendExecutor(self.scaling_config, self.run_config, trial_dir)
        last: Dict[str, Any] = {}

        def on_report(rank, iteration, metrics, ckpt_path):
            if rank == 0:
                last.clear()
                last.update(metrics)
                last["training_iteration"] = iteration
            # shard barrier: once all world ranks have landed a shard for
            # this step — or every rank has reported it and at least one
            # brought a shard (rank-0-only checkpointing) — the manager
            # commits (manifest + COMMIT) in its background uploader;
            # train.report never waits on it
            manager.note_report(
                rank,
                iteration,
                ckpt_path or None,
                metrics=metrics if rank == 0 else None,
            )

        fail_cfg = self.run_config.failure_config
        max_failures = fail_cfg.max_failures
        attempt = 0
        error: Optional[Exception] = None
        train_fn = self.train_loop
        config = self.train_loop_config
        if self.datasets:
            config = dict(config or {})
            config["__datasets__"] = self.datasets

        def resume_fn():
            # every restart resumes from the latest COMMITTED step — never
            # from a partial, uncommitted save
            return manager.latest_checkpoint() or self.resume_from_checkpoint

        def prepare_resume():
            # MUST fully drain before ranks rewrite the same step dirs a
            # still-running commit may be hashing, and a dead attempt's
            # half-complete barrier must not bleed into the restarted one.
            # The wait is bounded: a wedged commit must surface as a
            # CheckpointDrainError (failing the run), not hang the restart
            # forever — proceeding without the drain could tear a
            # committed-looking dir, so failing is the only safe exit.
            drain_timeout = self.run_config.checkpoint_config.drain_timeout_s
            if not manager.wait(timeout=drain_timeout):
                raise checkpointing.CheckpointDrainError(
                    manager.pending_steps(), drain_timeout
                )
            manager.reset_barrier()

        try:
            while True:
                try:
                    executor.start()
                    # auto-resume via resume_fn; the FIRST attempt honors an
                    # explicit resume_from_checkpoint even when the (reused)
                    # trial dir holds older commits.
                    if attempt == 0 and self.resume_from_checkpoint is not None:
                        latest = self.resume_from_checkpoint
                    else:
                        latest = resume_fn()
                    run_config = config
                    if self.scaling_config.use_torch_distributed:
                        # per-attempt rendezvous key suffix (see _wrap_distributed)
                        run_config = dict(config or {})
                        run_config["__torchdist_attempt__"] = attempt
                    executor.run(
                        train_fn,
                        run_config,
                        latest_ckpt=latest,
                        report_callback=on_report,
                        run_name=name,
                    )
                    error = None
                    break
                except Exception as e:  # noqa: BLE001
                    error = e
                    attempt += 1
                    # downtime ledger: the whole teardown -> backoff ->
                    # restart window is attributed (closed by the restarted
                    # attempt's first dispatch)
                    executor.open_downtime(
                        "gang_restart",
                        detail=f"attempt {attempt}: {type(e).__name__}",
                    )
                    executor.shutdown()
                    try:
                        prepare_resume()
                    except checkpointing.CheckpointDrainError as de:
                        # the plane is wedged: retrying would hit the same
                        # wall — surface the drain failure and stop, with
                        # the attempt's real error preserved as the cause
                        de.__cause__ = error
                        error = de
                        break
                    if max_failures != -1 and attempt > max_failures:
                        break
                    try:
                        from ray_tpu_torch.train._backend_executor import _get_metrics

                        _get_metrics()["restarts"].inc(tags={"kind": "gang"})
                    except Exception:
                        pass
                    time.sleep(_retry_backoff(attempt, fail_cfg))
                finally:
                    executor.shutdown()
        finally:
            # drain the upload queue before returning: fit()'s contract is
            # that every fully-reported checkpoint is committed (or failed
            # loudly) by the time the Result exists — and a drain that
            # TIMES OUT must never return looking fully committed
            drain_timeout = self.run_config.checkpoint_config.drain_timeout_s
            drain_t0 = time.monotonic()
            drained = manager.wait(timeout=drain_timeout)
            drain_s = time.monotonic() - drain_t0
            if drain_s > 0.05:
                # blocking on uncommitted uploads at teardown is downtime
                # the goodput ledger must attribute (the checkpoint_commit
                # spans show the same window from the storage side)
                executor.add_downtime(
                    "checkpoint_drain", drain_s, detail="fit() teardown drain"
                )
            if not drained:
                from ray_tpu_torch.train._backend_executor import _record_event

                undrained = manager.pending_steps()
                _record_event(
                    "CHECKPOINT_FAILED",
                    f"run {name}: checkpoint drain timed out after "
                    f"{drain_timeout:.0f}s with steps {undrained} still "
                    f"uncommitted",
                    severity="ERROR",
                    run=name,
                    undrained_steps=undrained,
                )
                drain_err = checkpointing.CheckpointDrainError(
                    undrained, drain_timeout
                )
                if error is None:
                    error = drain_err
                else:
                    # the run already failed; ride along as context
                    error.checkpoint_drain_error = drain_err
            manager.shutdown(wait=False)

        best = manager.latest_checkpoint()
        # a terminally-failed attempt can leave its gang_restart window open (the break skips the dispatch that would close it):
        # close it now so downtime_s == sum(ledger) in the final stats
        executor._close_downtime()
        goodput = executor.goodput_stats()
        goodput["downtime_ledger"] = executor.downtime_ledger()
        # final publication: the run's terminal status + complete ledger
        # land in the scheduler's StepIndex (state.train_run / dashboard)
        executor._push_run_meta(
            name, status="failed" if error is not None else "finished"
        )
        executor._publish_goodput(name)
        return Result(
            metrics=dict(last),
            checkpoint=best,
            path=trial_dir,
            error=error,
            goodput=goodput,
        )
