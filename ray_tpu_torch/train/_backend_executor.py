"""Worker-group executor for training (port of
``ray_tpu/train/_backend_executor.py``).

Parity: ``BackendExecutor`` (``python/ray/train/_internal/backend_executor.py:67``,
PG creation ``:213``) + ``WorkerGroup`` (``_internal/worker_group.py``): N
worker actors gang-scheduled in a placement group, reports streamed back to
the driver. A GPU worker asks for one ``GPU`` and runs in a process whose
CUDA is untouched (the runtime forks actors from its own fork server and
retires workers that initialised CUDA), seeing only its card; the trainer
joins the workers into a torch process group when asked
(``data_parallel_trainer``).

A rank that dies fails the attempt: ``DataParallelTrainer.fit()`` tears the
whole gang down and restarts it at the same world size from the last
committed checkpoint, up to ``FailureConfig.max_failures`` times. The
reference's in-run elasticity (keeping survivors, provisioning replacements,
shrinking to ``min_workers``) and its straggler replacement are not in the
port yet.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.train._config import RunConfig, ScalingConfig
from ray_tpu_torch.train._session import TrainContext, _Session, _set_session
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

_DEATH_ERRORS = (
    exc.ActorDiedError,
    exc.ActorUnavailableError,
    exc.WorkerCrashedError,
)


class WorkerGroupError(RuntimeError):
    """A rank of the gang died. fit() treats this like any attempt
    failure: whole-gang restart with backoff."""


_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def _get_metrics() -> Dict[str, Any]:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge

            _metrics = {
                "restarts": Counter(
                    "ray_tpu_torch_train_restarts_total",
                    "training restarts (kind=gang: full worker-group "
                    "teardown + restart)",
                    tag_keys=("kind",),
                ),
                "lost_workers": Counter(
                    "ray_tpu_torch_train_lost_workers_total",
                    "train workers lost to preemption/crash during a run",
                ),
                "goodput": Gauge(
                    "ray_tpu_torch_train_goodput",
                    "useful-step-time / wall-time of the training run "
                    "(1.0 = no time lost to churn, redone steps, or "
                    "recovery); published live on "
                    "train_goodput_publish_interval_s, not just at fit() "
                    "teardown",
                    tag_keys=("run",),
                ),
                "downtime": Counter(
                    "ray_tpu_torch_train_downtime_seconds",
                    "training wall time lost to attributed downtime "
                    "windows (cause=gang_restart|checkpoint_drain|"
                    "admission_wait) — the goodput gap's "
                    "ledger",
                    tag_keys=("run", "cause"),
                ),
            }
    return _metrics


@ray_tpu_torch.remote(num_cpus=0)
class _ReportCollector:
    """Buffers (rank, iteration, metrics, checkpoint_path) reports until the
    executor drains them."""

    def __init__(self):
        self.reports: List[Tuple[int, int, dict, Optional[str], Any]] = []
        self._offset = 0  # entries already drained and dropped

    def report(self, rank, iteration, metrics, ckpt_path, step_rec=None):
        # step_rec is the rank's PREVIOUS step-plane record riding this
        # report (compact tuple; see _private/stepplane.py) — drained to
        # the executor, which batch-pushes records into the scheduler's
        # StepIndex on the publish cadence
        self.reports.append((rank, iteration, metrics, ckpt_path, step_rec))
        return True

    def drain(self, start: int):
        # drained entries are never re-read: drop them and keep a running
        # offset — a long run's full metrics history would otherwise
        # accumulate in this actor forever
        idx = max(0, start - self._offset)
        out = self.reports[idx:]
        self._offset += len(self.reports)
        self.reports = []
        return out


@ray_tpu_torch.remote
class _TrainWorker:
    """One member of the worker group; runs the user train loop once."""

    def __init__(self, rank: int, world_size: int, trial_dir: str):
        self.context = TrainContext(
            world_rank=rank,
            world_size=world_size,
            local_rank=rank,
            trial_dir=trial_dir,
        )

    def run(
        self,
        fn_blob: bytes,
        config: Optional[dict],
        collector,
        latest_ckpt,
        run_name: str = "train",
    ):
        fn = cloudpickle.loads(fn_blob)
        datasets = None
        if isinstance(config, dict) and "__datasets__" in config:
            # internal plumbing, not a hyperparameter: the user fn gets a
            # config it can json.dumps/log without tripping over Datasets
            config = dict(config)
            datasets = config.pop("__datasets__")
        session = _Session(
            self.context, collector, latest_ckpt, run_name=run_name, datasets=datasets
        )
        _set_session(session)
        try:
            if config is not None:
                result = fn(config)
            else:
                result = fn()
            return result
        finally:
            _set_session(None)
            # the executor kills this worker right after the result lands;
            # push buffered telemetry (checkpoint_save spans, save-seconds
            # histogram) ahead of it — pipe FIFO makes the batch arrive
            # before the task result, so nothing is lost to the kill
            from ray_tpu_torch._private import telemetry

            telemetry.flush()


def _record_event(type: str, message: str, severity: str = "INFO", **extra):
    try:
        from ray_tpu_torch._private import telemetry

        telemetry.record_cluster_event(
            type, message, severity=severity, source="TRAIN", **extra
        )
    except Exception:
        pass


class BackendExecutor:
    def __init__(self, scaling: ScalingConfig, run_config: RunConfig, trial_dir: str):
        self.scaling = scaling
        self.run_config = run_config
        self.failure = run_config.failure_config
        self.trial_dir = trial_dir
        self.pg = None
        self.workers: List = []
        self.collector = None
        self._seen = 0  # reports drained from the current collector
        # goodput accounting (persists across gang restarts: one fit call,
        # one wall clock)
        self._gp = {
            "wall_start": None,
            "useful_s": 0.0,
            "max_step": 0,
            "last_ts": None,
            "steps_useful": 0,
            "steps_redone": 0,
        }
        # downtime ledger: goodput's gap attributed by cause. Each entry is
        # {cause, start (wall clock), end, seconds, detail}; _open_dt is the
        # window currently accruing (closed by the restarted gang's first
        # report). Windows open at the LAST PROGRESS timestamp, not at
        # detection: the work since the last report is redone by the
        # restart, so it is part of the loss this ledger must sum to.
        self._downtime: List[Dict[str, Any]] = []
        self._open_dt: Optional[Dict[str, Any]] = None
        self._last_progress: Optional[float] = None  # wall clock
        self._last_publish: float = 0.0
        self._run_name: str = "train"
        self._admission_noted = False  # start() runs once per gang attempt
        # step-plane records drained off reports, batch-pushed into the
        # scheduler's StepIndex on the publish cadence
        self._step_recs: List[Any] = []

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        res = self.scaling.worker_resources()
        bundles = [dict(res) for _ in range(self.scaling.num_workers)]
        short = self._short_resources(self.scaling.total_resources)
        if short:
            # the port runs one node: a gang larger than the whole cluster
            # can never be placed, so fail now rather than after the wait
            raise RuntimeError(
                f"could not gang-schedule {self.scaling.num_workers} workers "
                f"with {res} each: the cluster has {short}"
            )
        self.pg = placement_group(bundles, strategy=self.scaling.placement_strategy)
        if not self.pg.wait(60):
            remove_placement_group(self.pg)
            self.pg = None
            raise RuntimeError(
                f"could not gang-schedule {self.scaling.num_workers} workers "
                f"with {res} each (cluster too small?)"
            )
        self.collector = _ReportCollector.remote()
        self._seen = 0
        self.workers = [
            self._spawn(rank, self.scaling.num_workers)
            for rank in range(self.scaling.num_workers)
        ]
        self._note_admission_wait()

    @staticmethod
    def _short_resources(demand: Dict[str, float]) -> Dict[str, float]:
        """The resources of which the whole cluster holds less than
        ``demand``, with what it holds."""
        total = ray_tpu_torch.cluster_resources()
        return {
            k: total.get(k, 0.0)
            for k, v in demand.items()
            if v > 0 and total.get(k, 0.0) < v - 1e-9
        }

    def _note_admission_wait(self) -> None:
        """If this driver's job sat in the admission queue (multi-tenant
        plane: JOB_QUEUED -> JOB_ADMITTED), that wait is training downtime
        too — attribute it in the ledger instead of letting it read as a
        slow first step."""
        if self._admission_noted:
            return
        self._admission_noted = True
        try:
            from ray_tpu_torch._private.worker import get_runtime

            job_hex = getattr(get_runtime(), "job_id", None)
            job_hex = job_hex.hex() if job_hex is not None else None
            if not job_hex:
                return
            queued = admitted = None
            for ev in self._list_events(limit=512):
                if ev.get("job_id") != job_hex:
                    continue
                if ev.get("type") == "JOB_QUEUED":
                    queued = ev.get("time")
                elif ev.get("type") == "JOB_ADMITTED" and queued is not None:
                    admitted = ev.get("time")
            if queued is not None and admitted is not None and admitted > queued:
                self.add_downtime(
                    "admission_wait",
                    admitted - queued,
                    detail=f"job {job_hex} queued for admission",
                )
        except Exception:
            pass

    def _spawn(self, rank: int, world: int):
        res = self.scaling.worker_resources()
        opts = dict(
            # the actor's demand must equal the bundle's contents — a CPU
            # default here would never fit a CPU-less bundle
            num_cpus=res.get("CPU", 0.0),
            num_gpus=res.get("GPU", 0.0),
            resources={k: v for k, v in res.items() if k not in ("CPU", "GPU")},
            runtime_env=self.scaling.worker_runtime_env,
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=self.pg, placement_group_bundle_index=rank
            ),
        )
        return _TrainWorker.options(**opts).remote(rank, world, self.trial_dir)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self.pg is not None:
            remove_placement_group(self.pg)
            self.pg = None

    # -- reports / goodput --------------------------------------------------

    def _drain_reports(self, report_callback: Optional[Callable]) -> None:
        new = ray_tpu_torch.get(self.collector.drain.remote(self._seen), timeout=60)
        self._seen += len(new)
        if new:
            self._last_progress = time.time()
            if self._open_dt is not None and self._open_dt.pop(
                "until_report", False
            ):
                # a restart's downtime window ends at the first report the
                # restarted gang produces (dispatch alone is not recovery —
                # session re-setup is part of the loss), minus one nominal
                # step: the step that produced this report was useful work
                gp = self._gp
                avg = (
                    gp["useful_s"] / gp["steps_useful"]
                    if gp["steps_useful"]
                    else 0.0
                )
                self._close_downtime(discount_s=avg)
        for r in new:
            self._note_goodput(r)
            if len(r) > 4 and r[4] is not None:
                self._step_recs.append(r[4])
            if report_callback:
                report_callback(*r[:4])

    def _note_goodput(self, report) -> None:
        rank, iteration = report[0], report[1]
        if rank != 0:
            return
        now = time.monotonic()
        gp = self._gp
        if gp["last_ts"] is not None:
            dt = now - gp["last_ts"]
            if iteration > gp["max_step"]:
                gp["useful_s"] += dt
                gp["steps_useful"] += 1
            else:
                gp["steps_redone"] += 1
        gp["max_step"] = max(gp["max_step"], iteration)
        gp["last_ts"] = now

    def goodput_stats(self) -> Dict[str, Any]:
        gp = self._gp
        wall = (
            time.monotonic() - gp["wall_start"] if gp["wall_start"] else 0.0
        )
        by_cause: Dict[str, float] = {}
        for e in self._downtime:
            by_cause[e["cause"]] = by_cause.get(e["cause"], 0.0) + e["seconds"]
        return {
            "wall_s": wall,
            "useful_step_s": gp["useful_s"],
            "steps_useful": gp["steps_useful"],
            "steps_redone": gp["steps_redone"],
            "goodput": (gp["useful_s"] / wall) if wall > 0 else 0.0,
            "downtime_s": round(sum(by_cause.values()), 3),
            "downtime_by_cause": {k: round(v, 3) for k, v in by_cause.items()},
        }

    # -- downtime ledger ----------------------------------------------------

    def downtime_ledger(self) -> List[Dict[str, Any]]:
        """Closed downtime windows so far, in order. The open window (if
        any) is included with its running duration — a live dashboard must
        see the outage it is currently in."""
        out = [dict(e) for e in self._downtime]
        if self._open_dt is not None:
            cur = dict(self._open_dt)
            cur["seconds"] = round(max(0.0, time.time() - cur["start"]), 3)
            cur["open"] = True
            out.append(cur)
        return out

    def open_downtime(self, cause: str, detail: str = "", start: Optional[float] = None) -> None:
        """Begin a downtime window; the restarted gang's first report closes
        it. Starts at the last progress timestamp unless given explicitly —
        work done since the last report is redone by the restart, so it
        counts."""
        if self._open_dt is not None:
            return  # already in an outage; first cause wins
        t0 = start if start is not None else (self._last_progress or time.time())
        self._open_dt = {"cause": cause, "start": t0, "detail": detail}

    def _close_downtime(self, discount_s: float = 0.0) -> None:
        dt = self._open_dt
        if dt is None:
            return
        self._open_dt = None
        dt.pop("until_report", None)
        dt["end"] = time.time()
        dt["seconds"] = round(
            max(0.0, dt["end"] - dt["start"] - max(0.0, discount_s)), 3
        )
        self._downtime.append(dt)
        try:
            _get_metrics()["downtime"].inc(
                dt["seconds"], tags={"run": self._run_name, "cause": dt["cause"]}
            )
        except Exception:
            pass

    def add_downtime(self, cause: str, seconds: float, detail: str = "") -> None:
        """Record an already-measured downtime window (checkpoint drains,
        admission waits — stalls with explicit bounds)."""
        if seconds <= 0:
            return
        end = time.time()
        self._downtime.append(
            {
                "cause": cause,
                "start": end - seconds,
                "end": end,
                "seconds": round(seconds, 3),
                "detail": detail,
            }
        )
        try:
            _get_metrics()["downtime"].inc(
                round(seconds, 3), tags={"run": self._run_name, "cause": cause}
            )
        except Exception:
            pass

    def _sched_rpc(self, op: str, args: tuple):
        from ray_tpu_torch._private.worker import get_runtime

        rt = get_runtime()
        if hasattr(rt, "scheduler_rpc"):
            return rt.scheduler_rpc(op, args)
        return rt.rpc(op, *args)

    def _push_step_records(self) -> None:
        """Batch-push drained step records into the scheduler's StepIndex
        (on the publish cadence — per-record pushes would tax the step
        hot path the records were moved OFF of)."""
        if not self._step_recs:
            return
        recs, self._step_recs = self._step_recs, []
        try:
            self._sched_rpc("train_steps_batch", (recs,))
        except Exception:
            self._step_recs = recs + self._step_recs  # retry next push

    def _push_run_meta(self, run_name: str, status: str = "running") -> None:
        """Publish this run's goodput + downtime ledger into the
        scheduler's StepIndex (state.train_run / dashboard read side)."""
        self._push_step_records()
        try:
            self._sched_rpc(
                "train_run_meta",
                (
                    run_name,
                    {
                        "goodput": self.goodput_stats(),
                        "downtime_ledger": self.downtime_ledger(),
                        "world_size": self.scaling.num_workers,
                        "live_world": len(self.workers),
                        "status": status,
                    },
                ),
            )
        except Exception:
            pass

    def _publish_interval_s(self) -> float:
        try:
            from ray_tpu_torch._private.worker import get_runtime

            cfg = getattr(get_runtime(), "config", None)
            return float(
                getattr(cfg, "train_goodput_publish_interval_s", 5.0) or 5.0
            )
        except Exception:
            return 5.0

    def _maybe_publish(self, run_name: str) -> None:
        """Live goodput on a periodic cadence: dashboards see the run
        mid-flight, not only at fit() teardown."""
        now = time.monotonic()
        if now - self._last_publish < self._publish_interval_s():
            return
        self._last_publish = now
        self._publish_goodput(run_name)
        self._push_run_meta(run_name)

    def _publish_goodput(self, run_name: str) -> None:
        try:
            _get_metrics()["goodput"].set(
                round(self.goodput_stats()["goodput"], 4), tags={"run": run_name}
            )
        except Exception:
            pass

    # -- cluster events -----------------------------------------------------

    def _list_events(self, limit: int = 256) -> List[dict]:
        from ray_tpu_torch._private.worker import get_runtime

        rt = get_runtime()
        try:
            if hasattr(rt, "scheduler_rpc"):
                return rt.scheduler_rpc("list_cluster_events", (limit,)) or []
            return rt.rpc("list_cluster_events", limit) or []
        except Exception:
            return []

    # -- the run ------------------------------------------------------------

    def run(
        self,
        train_fn: Callable,
        config: Optional[dict],
        latest_ckpt=None,
        report_callback: Optional[Callable] = None,
        timeout: Optional[float] = None,
        *,
        run_name: str = "train",
    ) -> List[Any]:
        """Run the user loop once on every rank and return the ranks'
        results in rank order. A rank that dies raises
        :class:`WorkerGroupError`, and a loop that raises raises its error:
        the caller's whole-gang restart takes it from there."""
        fn_blob = cloudpickle.dumps(train_fn)
        self._run_name = run_name
        if self._gp["wall_start"] is None:
            self._gp["wall_start"] = time.monotonic()
        self._gp["last_ts"] = None
        world = len(self.workers)
        ref_to_rank = {
            w.run.remote(fn_blob, config, self.collector, latest_ckpt, run_name): rank
            for rank, w in enumerate(self.workers)
        }
        # the open window (a gang restart) runs until this attempt's first
        # report lands: dispatch alone is not recovery
        if self._open_dt is not None:
            self._open_dt["until_report"] = True
        results: Dict[int, Any] = {}
        deadline = None if timeout is None else time.monotonic() + timeout
        while ref_to_rank:
            ready, _ = ray_tpu_torch.wait(
                list(ref_to_rank), num_returns=1, timeout=0.5
            )
            self._drain_reports(report_callback)
            for r in ready:
                rank = ref_to_rank.pop(r)
                try:
                    results[rank] = ray_tpu_torch.get(r)
                except _DEATH_ERRORS as e:
                    self._note_lost_worker(rank, world, e, run_name)
                    raise WorkerGroupError(
                        f"run {run_name}: rank {rank} of {world} died "
                        f"({type(e).__name__}: {e})"
                    ) from e
            self._maybe_publish(run_name)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("training run timed out")
        self._drain_reports(report_callback)
        self._close_downtime()  # a window no report ever closed (rare)
        self._publish_goodput(run_name)
        self._push_run_meta(run_name)
        return [results[rank] for rank in sorted(results)]

    def _note_lost_worker(self, rank: int, world: int, err: Exception, run_name: str) -> None:
        try:
            _get_metrics()["lost_workers"].inc()
        except Exception:
            pass
        _record_event(
            "TRAIN_WORKER_DIED",
            f"run {run_name}: rank {rank}/{world} lost "
            f"({type(err).__name__}: {err}); restarting the gang",
            severity="WARNING",
            run=run_name,
            rank=rank,
            world_size=world,
        )
