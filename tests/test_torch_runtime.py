"""The port's core runtime (``ray_tpu_torch``: tasks, actors, objects, the KV
store, the GPU resource) held against the JAX package's (``ray_tpu``).

Each program runs once through each runtime, both started once for the module
and alive at once, and the two results must be equal; exceptions compare by
class name and cause. ``num_gpus`` under ``RAY_TPU_TORCH_FAKE_GPUS=2`` is held
against ``num_tpus`` under ``RAY_TPU_FAKE_CHIPS=2``: the same placement, the
same device indices (``CUDA_VISIBLE_DEVICES`` / ``TPU_VISIBLE_CHIPS``), the same
isolation. Remote functions are defined inside the programs, so workers
unpickle them by value and never import this module (which imports JAX).
"""

import importlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import pytest

import ray_tpu
import ray_tpu_torch

T = 60  # every get's timeout, in seconds


@pytest.fixture(scope="module")
def runtimes():
    saved = {k: os.environ.get(k) for k in ("RAY_TPU_FAKE_CHIPS", "RAY_TPU_TORCH_FAKE_GPUS")}
    os.environ["RAY_TPU_FAKE_CHIPS"] = "2"
    os.environ["RAY_TPU_TORCH_FAKE_GPUS"] = "2"
    for R in (ray_tpu, ray_tpu_torch):
        if R.is_initialized():
            R.shutdown()
    try:
        # the fewest CPUs the programs need, and no prestarted workers
        ray_tpu.init(num_cpus=2, _system_config={"prestart_workers": False})
        ray_tpu_torch.init(num_cpus=2, _system_config={"prestart_workers": False})
        yield {"ref": ray_tpu, "port": ray_tpu_torch}
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _exc_key(e):
    """An exception as the programs compare it: class name, and the class
    name and message of its cause (the user's exception a task raised)."""
    cause = getattr(e, "cause", None)
    return (type(e).__name__ if type(e).__name__ != "_Wrapped" else "TaskError",
            type(cause).__name__ if cause is not None else None,
            str(cause) if cause is not None else None)


def _accel(R):
    """(resource name, visible-devices env var, num_<x> option) of a runtime."""
    if R is ray_tpu:
        return "TPU", "TPU_VISIBLE_CHIPS", "num_tpus"
    return "GPU", "CUDA_VISIBLE_DEVICES", "num_gpus"


# -- the programs -------------------------------------------------------------


def prog_tasks(R):
    @R.remote
    def add(a, b):
        return a + b

    @R.remote(num_returns=3)
    def three(x):
        return x, x * 2, x * 3

    ref = add.remote(1, 2)
    for i in range(5):
        ref = add.remote(ref, i)  # a chain of refs
    parts = three.remote(ref)

    @R.remote
    def outer(x):
        return R.get(add.remote(x, 100), timeout=60)  # a task submitting a task

    return R.get(ref, timeout=T), R.get(list(parts), timeout=T), R.get(outer.remote(1), timeout=T)


def prog_objects(R):
    import numpy as np

    big = np.arange(300_000, dtype=np.float64)  # 2.4 MB: a store-backed object
    big_ref, small_ref = R.put(big), R.put({"k": [1, 2]})

    @R.remote
    def total(x):
        return float(x.sum())

    @R.remote
    def sleep(t):
        import time

        time.sleep(t)
        return t

    fast, slow = sleep.remote(0.0), sleep.remote(1.5)
    ready, not_ready = R.wait([fast, slow], num_returns=1, timeout=T)
    try:
        R.get(slow, timeout=0.2)
        timed_out = None
    except Exception as e:  # noqa: BLE001 - compared by class name
        timed_out = _exc_key(e)
    none_ready = R.wait([sleep.remote(1.0)], num_returns=1, timeout=0.2)
    return (
        bool(np.array_equal(R.get(big_ref, timeout=T), big)),
        R.get(small_ref, timeout=T),
        R.get(total.remote(big_ref), timeout=T),
        [R.get(r, timeout=T) for r in ready],
        len(not_ready),
        timed_out,
        [len(x) for x in none_ready],
        R.get(slow, timeout=T),
    )


def prog_actors(R):
    @R.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    name = f"counter-{R.__name__}"
    c = Counter.options(name=name).remote(10)
    vals = R.get([c.inc.remote() for _ in range(3)], timeout=T)
    vals.append(R.get(R.get_actor(name).inc.remote(5), timeout=T))
    R.kill(c)
    try:
        R.get(c.inc.remote(), timeout=T)
        after_kill = None
    except Exception as e:  # noqa: BLE001
        after_kill = _exc_key(e)[0]
    return vals, after_kill


def prog_errors(R):
    @R.remote(max_retries=0)
    def boom():
        raise ValueError("boom 7")

    @R.remote
    def consume(x):
        return x

    out = []
    for ref in (boom.remote(), consume.remote(boom.remote())):
        try:
            R.get(ref, timeout=T)
            out.append(None)
        except Exception as e:  # noqa: BLE001
            out.append((_exc_key(e), isinstance(e, ValueError)))
    return out


def prog_placement_groups(R):
    pgmod = importlib.import_module(R.__name__ + ".util.placement_group")
    strat = importlib.import_module(R.__name__ + ".util.scheduling_strategies")

    @R.remote(num_cpus=1)
    def where():
        return "ran"

    out = {}
    for strategy in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        pg = pgmod.placement_group([{"CPU": 1}, {"CPU": 1}], strategy=strategy)
        # one node: STRICT_SPREAD cannot place two bundles
        placed = pg.wait(timeout_seconds=10 if strategy != "STRICT_SPREAD" else 0.5)
        ran = None
        if placed:
            s = strat.PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=1)
            ran = R.get(where.options(scheduling_strategy=s).remote(), timeout=T)
        pgmod.remove_placement_group(pg)
        out[strategy] = (placed, ran)
    return out


def prog_cluster_resources(R):
    name, _, _ = _accel(R)
    res = R.cluster_resources()
    return {("ACCEL" if k == name else k): v for k, v in res.items()}


def prog_device_indices(R):
    """Concurrent one-device tasks see one device each, the two devices in
    turn; an actor holds its device for life, and while two actors hold both,
    a one-device task stays pending until one is killed."""
    name, env, opt = _accel(R)

    @R.remote(**{opt: 1})
    def visible():
        import os
        import time

        time.sleep(0.3)
        return os.environ.get(env)

    @R.remote(**{opt: 1})
    class Holder:
        def ids(self):
            import os

            return os.environ.get(env), R.get_runtime_context().get_accelerator_ids()[name]

    tasks = sorted(R.get([visible.remote() for _ in range(4)], timeout=T))
    a, b = Holder.remote(), Holder.remote()
    held = sorted(R.get([a.ids.remote(), b.ids.remote()], timeout=T))
    pending = visible.remote()
    ready, _ = R.wait([pending], num_returns=1, timeout=1.0)
    R.kill(a)
    freed = R.get(pending, timeout=T)
    R.kill(b)
    return tasks, held, len(ready), freed == held[0][0]


PROGRAMS = [
    prog_tasks,
    prog_objects,
    prog_actors,
    prog_errors,
    prog_placement_groups,
    prog_cluster_resources,
    prog_device_indices,
]


@pytest.mark.parametrize("prog", PROGRAMS, ids=[p.__name__ for p in PROGRAMS])
def test_program_same_through_both_runtimes(runtimes, prog):
    ref = prog(runtimes["ref"])
    port = prog(runtimes["port"])
    assert port == ref


def test_device_placement_expected(runtimes):
    """The shared results are also the right ones (not merely equal)."""
    tasks, held, pending_ready, freed_reused = prog_device_indices(runtimes["port"])
    assert tasks == ["0", "0", "1", "1"]
    assert held == [("0", ["0"]), ("1", ["1"])]
    assert pending_ready == 0 and freed_reused
    assert prog_cluster_resources(runtimes["port"])["ACCEL"] == 2.0


def test_both_runtimes_alive_with_disjoint_sessions(runtimes):
    ref_node = ray_tpu._private.worker.get_driver().node
    port_node = ray_tpu_torch._private.worker.get_driver().node
    assert ray_tpu.is_initialized() and ray_tpu_torch.is_initialized()
    ref_root = os.path.dirname(ref_node.session_dir)
    port_root = os.path.dirname(port_node.session_dir)
    # the port's root follows TMPDIR (two checkouts with their own TMPDIR
    # never meet) and is not the reference's
    assert os.path.dirname(port_root) == tempfile.gettempdir()
    assert os.path.basename(port_root) == "ray_tpu_torch_sessions"
    assert ref_root != port_root
    assert os.path.basename(port_node.shm_dir).startswith("ray_tpu_torch_session_")
    assert os.path.basename(ref_node.shm_dir).startswith("ray_tpu_session_")
    assert port_node.shm_dir != ref_node.shm_dir
    # each runtime serves its own tasks while the other is up
    assert prog_tasks(ray_tpu_torch) == prog_tasks(ray_tpu)


def test_rendezvous_via_kv_between_actors(runtimes):
    """Two actors agree on an address through the port's KV, form a gloo
    group, all-reduce, and rank 0 drops the key."""
    R = runtimes["port"]

    @R.remote
    class Rank:
        def __init__(self, rank, world):
            self.rank, self.world = rank, world

        def join(self, key):
            import torch
            import torch.distributed as dist

            from ray_tpu_torch._private.worker import get_runtime
            from ray_tpu_torch.parallel import distributed as D

            rt = get_runtime()
            addr = D.rendezvous_via_kv(rt, key, self.rank, self.world, timeout_s=60)
            D.initialize(addr, self.world, self.rank, device="cpu", timeout_s=60)
            t = torch.full((4,), float(self.rank + 1))
            dist.all_reduce(t)
            if self.rank == 0:
                D.release_rendezvous(rt, key)
            D.shutdown()
            return addr, t.tolist()

    ranks = [Rank.remote(r, 2) for r in range(2)]
    (addr0, sum0), (addr1, sum1) = R.get([r.join.remote("pg-key") for r in ranks], timeout=T)
    assert addr0 == addr1 and addr0.startswith("127.0.0.1:")
    assert sum0 == sum1 == [3.0] * 4
    from ray_tpu_torch.parallel import distributed as D

    rt = ray_tpu_torch._private.worker.get_runtime()
    assert rt.rpc("kv_get", D._NAMESPACE, b"pg-key") is None
    for r in ranks:
        R.kill(r)


_NO_JAX = r"""
import json, sys
import ray_tpu_torch as R

def bad():
    import sys
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))

R.init(num_cpus=2)
task = R.remote(bad)

@R.remote
class Actor:
    def bad(self):
        return bad()

a = Actor.remote()
out = {"driver": bad(), "task": R.get(task.remote(), timeout=60),
       "actor": R.get(a.bad.remote(), timeout=60)}
R.shutdown()
print(json.dumps(out))
"""


def test_runtime_imports_nothing_of_jax():
    """``init`` and ``remote`` with neither ``jax`` nor ``ray_tpu`` imported,
    in the driver, in a task's worker or in an actor's (extends
    ``test_parallel_modules_and_rank_jobs_leave_jax_out``)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=root, capture_output=True,
                       text=True, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"driver": [], "task": [], "actor": []}


def test_cluster_mode_is_a_later_slice():
    with pytest.raises(NotImplementedError, match="later slice"):
        ray_tpu_torch._private.worker.init(address="127.0.0.1:6379")
