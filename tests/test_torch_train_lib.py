"""The port's Train library (``ray_tpu_torch.train``) against the JAX
package's (``ray_tpu.train``), on the CPU: each runtime started once for the
module (two CPUs, no pre-started workers).

- One worker: the reference's ``JaxTrainer`` and the port's
  ``DataParallelTrainer`` train a GPT-J-style model (parallel block, gelu,
  fp32, 2 layers of width 64) from the reference's initial parameters
  (carried into the port with ``ray_tpu_torch.weights``; the reference's
  train worker reports the same ones), 3 AdamW steps on the same seeded
  batches (B=4, S=12). The reference's trainer runs in a thread while the
  port's runs train: the two runtimes share nothing. The reported losses agree to 1e-3 relative (the rule of
  ``tests/test_torch_train.py``'s two AdamW steps: Adam moves elements
  whose gradients lie at the rounding level by lr in a direction rounding
  decides; the first loss is before any step and agrees to 1e-5).
- Two gloo workers (``use_torch_distributed=True``), each keeping half of
  the batch on a ``data=2`` mesh, report the one-worker port's losses to
  1e-5 relative (the same model; only the order of the batch sums and the
  gradient all-reduce differ); each of their reports closes one step-plane
  record per rank, and each rank's process group is gone (its rendezvous
  key released) when the run ends.
- ``tests/test_train.py``'s checkpoint, failure-restart (one run serves
  both), worker-error and gang-too-big cases; ``TorchTrainer`` with DDP over
  gloo, fed by ``prepare_data_loader``: both ranks' weights equal plain
  single-process SGD on the union of their batches to 1e-6, and the two
  shards are disjoint and cover the dataset; ``topology=`` and ``use_gpu``
  without a card raising; pure cases of the checkpoint plane (commit,
  manifest, retention) and of the elastic format (N -> M re-sharding, in
  both directions between the two packages).
"""

import concurrent.futures
import dataclasses
import json
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu import train as jtrain  # noqa: E402
from ray_tpu.models import transformer as JT  # noqa: E402
from ray_tpu_torch import train  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    CheckpointConfig,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)

FIRST_LOSS_RTOL, STEP_RTOL, GLOO_RTOL, DDP_ATOL = 1e-5, 1e-3, 1e-5, 1e-6
LR, STEPS, SEED = 1e-3, 3, 0
CFG = JT.TransformerConfig(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64,
    parallel_block=True, use_swiglu=False, dtype=jnp.float32, remat=False,
)


@pytest.fixture(scope="module")
def runtimes():
    for R in (ray_tpu, ray_tpu_torch):
        if R.is_initialized():
            R.shutdown()
    try:
        ray_tpu.init(num_cpus=2, _system_config={"prestart_workers": False})
        ray_tpu_torch.init(num_cpus=2, _system_config={"prestart_workers": False})
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _batches(cfg, steps=STEPS, b=4, s=12, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32) for _ in range(steps)]


def _port_loop_fn():
    """The port's loop, made here so that it is pickled by value: a train
    worker unpickling a function of this module by reference would import
    it, and with it jax."""

    def _port_loop(config):
        """The port's loop: the reference's parameters into build_lm_train_step,
        on a data mesh when the trainer formed a process group."""
        import sys

        import numpy as np
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.models import transformer as PT
        from ray_tpu_torch.parallel.mesh import create_mesh
        from ray_tpu_torch.parallel.sharding import DEFAULT_LM_RULES, shard_params
        from ray_tpu_torch.parallel.spmd import build_lm_train_step
        from ray_tpu_torch.weights import params_from_jax

        cfg = PT.TransformerConfig(**config["cfg"], dtype=torch.float32)
        full = params_from_jax(config["params"], device="cpu")
        mesh = create_mesh(data=-1) if dist.is_initialized() else None
        bundle = build_lm_train_step(cfg, mesh, device="cpu", learning_rate=config["lr"])
        if mesh is not None:
            full = shard_params(full, PT.param_logical_axes(cfg), DEFAULT_LM_RULES, mesh)
        state = bundle.state_from_params(full)
        losses = []
        for tokens in config["batches"]:
            tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))
            state, metrics = bundle.step_fn(state, tok, tgt)
            losses.append(float(metrics["loss"]))
            train.report({"losses": list(losses),
                          "rows": int(tok.shape[0]),
                          "jax_loaded": any(m.split(".")[0] in ("jax", "ray_tpu") for m in sys.modules)})

    return _port_loop


def _jax_loop(config):
    import jax
    import numpy as np

    from ray_tpu import train
    from ray_tpu.models import transformer as JT
    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.parallel.spmd import build_lm_train_step

    cfg = JT.TransformerConfig(**config["cfg"], dtype=jax.numpy.float32)
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    bundle = build_lm_train_step(cfg, mesh, learning_rate=config["lr"])
    state = bundle.init_fn(jax.random.PRNGKey(config["seed"]))
    # the initial parameters ride the reports, for the port to start from
    init = jax.tree.map(np.asarray, state["params"])
    losses = []
    for tokens in config["batches"]:
        tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))
        state, metrics = bundle.step_fn(state, tok, tgt)
        losses.append(float(jax.device_get(metrics["loss"])))
        train.report({"losses": list(losses), "init_params": init})


@pytest.fixture(scope="module")
def lm_runs(runtimes, tmp_path_factory):
    """The reference's one-worker run and the port's one- and two-worker
    runs of the same loop, each ``fit()`` once for the module, and the
    reference's initial parameters."""
    tmp = str(tmp_path_factory.mktemp("lm"))
    fields = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(JT.TransformerConfig)
              if f.name != "dtype"}
    batches = _batches(CFG)
    reference = jtrain.JaxTrainer(
        _jax_loop,
        train_loop_config={"cfg": fields, "batches": batches, "lr": LR, "seed": SEED},
        scaling_config=jtrain.ScalingConfig(num_workers=1),
        run_config=jtrain.RunConfig(storage_path=tmp, name="jax_lm"),
    )
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref_future = pool.submit(reference.fit)
        # the reference's init_fn, here: the parameters its worker starts from
        init = jax.tree.map(np.asarray, jax.jit(lambda k: JT.init_params(k, CFG))(
            jax.random.PRNGKey(SEED)))
        config = {"cfg": fields, "batches": batches, "lr": LR, "params": init}
        one = DataParallelTrainer(
            _port_loop_fn(), train_loop_config=config, scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(storage_path=tmp, name="port_lm1"),
        ).fit()
        two = DataParallelTrainer(
            _port_loop_fn(), train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=2, use_torch_distributed=True),
            run_config=RunConfig(storage_path=tmp, name="port_lm2"),
        ).fit()
        ref = ref_future.result(timeout=300)
    return ref, one, two, init


def test_one_worker_losses_match_jax_trainer(lm_runs):
    ref, one, _, init = lm_runs
    assert ref.error is None and one.error is None, (ref.error, one.error)
    for got, want in zip(jax.tree.leaves(ref.metrics["init_params"]), jax.tree.leaves(init)):
        np.testing.assert_array_equal(got, want)
    assert one.metrics["training_iteration"] == ref.metrics["training_iteration"] == STEPS
    assert not one.metrics["jax_loaded"], "the port's train worker imported jax or ray_tpu"
    want, got = np.asarray(ref.metrics["losses"]), np.asarray(one.metrics["losses"])
    assert len(got) == STEPS
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    assert got[-1] < got[0]


def test_two_gloo_workers_report_the_one_worker_losses(lm_runs):
    _, one, two, _ = lm_runs
    assert two.error is None, two.error
    assert two.metrics["rows"] == 2  # rank 0 kept half of the batch of 4
    assert not two.metrics["jax_loaded"]
    np.testing.assert_allclose(two.metrics["losses"], one.metrics["losses"], rtol=GLOO_RTOL)
    # rank 0 drops the rendezvous key only once its process group is destroyed
    from ray_tpu_torch._private.worker import get_runtime

    assert get_runtime().rpc("kv_keys", "torch_rendezvous", b"torchdist_") == []


def test_each_report_closes_one_step_record_per_rank(lm_runs):
    # each rank's last record drains through the telemetry ring after the run
    deadline = time.monotonic() + 20
    while True:
        tl = ray_tpu_torch.train_timeline("port_lm2").to_dict()
        per_rank = {}
        for step in tl.get("steps", []):
            for rank in step["ranks"]:
                per_rank.setdefault(int(rank), []).append(step["step"])
        per_rank = {r: sorted(steps) for r, steps in per_rank.items()}
        if per_rank == {0: [1, 2, 3], 1: [1, 2, 3]} or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    assert per_rank == {0: [1, 2, 3], 1: [1, 2, 3]}
    assert tl["rank_steps"] == {"0": 3, "1": 3} and tl["world"] == 2


# -- tests/test_train.py's cases -----------------------------------------------


@pytest.fixture(scope="module")
def restarted_run(runtimes, tmp_path_factory):
    """One run of tests/test_train.py's checkpoint and failure-restart loops
    together: a checkpoint per iteration (two kept), a failure after the
    second, a restart from the latest committed one."""
    tmp = tmp_path_factory.mktemp("restart")
    marker = str(tmp / "fail_once")

    def loop():
        import os
        import tempfile

        from ray_tpu_torch import train

        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "it.txt")) as fh:
                start = int(fh.read()) + 1
        for i in range(start, 4):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "it.txt"), "w") as fh:
                fh.write(str(i))
            with open(os.path.join(d, "model.txt"), "w") as fh:
                fh.write(f"iter-{i}")
            train.report({"it": float(i), "start": start},
                         checkpoint=train.Checkpoint.from_directory(d))
            if i == 1 and not os.path.exists(marker):
                open(marker, "w").close()
                raise RuntimeError("injected failure")

    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp), name="t4",
                             checkpoint_config=CheckpointConfig(num_to_keep=2),
                             failure_config=FailureConfig(max_failures=1, retry_backoff_s=0.0)),
    ).fit()
    return result, str(tmp / "t4")


def test_checkpoint_reported_and_kept(restarted_run):
    from ray_tpu_torch.train import checkpointing

    result, trial_dir = restarted_run
    assert result.error is None, result.error
    with open(os.path.join(result.checkpoint.path, "model.txt")) as fh:
        assert fh.read() == "iter-3"
    kept = [r["step"] for r in checkpointing.list_checkpoints(trial_dir)]
    assert sorted(kept) == [3, 4]


def test_failure_restart_from_checkpoint(restarted_run):
    result, _ = restarted_run
    assert result.error is None, result.error
    assert result.metrics["it"] == 3.0 and result.metrics["start"] == 2  # resumed from it=1
    assert result.metrics["training_iteration"] == 4
    assert "gang_restart" in result.goodput["downtime_by_cause"]


def test_worker_error_surfaces(runtimes, tmp_path):
    def loop():
        raise ValueError("bad train fn")

    result = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path), name="t5"),
    ).fit()
    assert result.error is not None and "bad train fn" in str(result.error)


def test_gang_schedule_too_big_fails_fast(runtimes, tmp_path):
    t0 = time.monotonic()
    result = DataParallelTrainer(
        lambda: None,
        scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 100}),
        run_config=RunConfig(storage_path=str(tmp_path), name="t6"),
    ).fit()
    assert isinstance(result.error, RuntimeError) and "gang-schedule" in str(result.error)
    assert time.monotonic() - t0 < 10.0


def _ddp_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    return x, x.sum(1, keepdims=True)


def test_torch_trainer_ddp_gloo(runtimes, tmp_path):
    """Two ranks, DDP over the trainer's gloo group, each fed its shard by
    prepare_data_loader: the shards are disjoint and cover the dataset, and
    both ranks end with the weights of plain SGD on the union of each
    step's two batches (DDP averages the ranks' gradients)."""
    import torch

    def train_fn(config):
        import json
        import os

        import numpy as np
        import torch
        import torch.nn as nn
        from torch.utils.data import DataLoader, TensorDataset

        from ray_tpu_torch.train import get_context, prepare_data_loader, prepare_model, report

        rank = get_context().get_world_rank()
        torch.manual_seed(0)
        model = prepare_model(nn.Linear(4, 1))
        x, y = (torch.from_numpy(np.asarray(a, np.float32)) for a in config["data"])
        loader = prepare_data_loader(DataLoader(TensorDataset(torch.arange(64), x, y),
                                                batch_size=8))
        seen = []
        for idx, xb, yb in loader:
            seen.append(idx.tolist())
            loss = ((model(xb) - yb) ** 2).mean()
            model.zero_grad()
            loss.backward()  # DDP averages the gradients over the ranks here
            with torch.no_grad():  # plain SGD (no torch.optim: it imports torch._dynamo)
                for p in model.parameters():
                    p -= 0.05 * p.grad
        w = [p.detach().numpy().ravel().tolist() for p in model.module.parameters()]
        with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as fh:
            json.dump({"w": w, "seen": seen}, fh)
        report({"ddp": type(model).__name__})

    x, y = _ddp_data()
    result = TorchTrainer(
        train_fn,
        train_loop_config={"data": [x.tolist(), y.tolist()], "out": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path), name="ddp"),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics["ddp"] == "DistributedDataParallel"
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    seen = [sorted(i for b in rk["seen"] for i in b) for rk in ranks]
    assert not set(seen[0]) & set(seen[1]) and sorted(seen[0] + seen[1]) == list(range(64))
    assert len(ranks[0]["seen"]) == len(ranks[1]["seen"]) == 4
    # plain single-process SGD over each step's union of the two ranks' batches
    torch.manual_seed(0)
    params = list(torch.nn.Linear(4, 1).parameters())
    for b0, b1 in zip(ranks[0]["seen"], ranks[1]["seen"]):
        rows = b0 + b1
        pred = torch.from_numpy(x[rows]) @ params[0].T + params[1]
        loss = ((pred - torch.from_numpy(y[rows])) ** 2).mean()
        with torch.no_grad():
            for p, g in zip(params, torch.autograd.grad(loss, params)):
                p -= 0.05 * g
    want = [p.detach().numpy().ravel() for p in params]
    for rk in ranks:
        for got, ref in zip(rk["w"], want):
            np.testing.assert_allclose(got, ref, atol=DDP_ATOL, rtol=0)


def test_topology_and_gpu_without_a_card_raise():
    with pytest.raises(ValueError, match="TPU-only"):
        ScalingConfig(num_workers=4, topology="v5litepod-16")
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            ScalingConfig(num_workers=1, use_gpu=True)
    # datasets= is taken (the data library feeds it); the shard is read
    # inside a training session only
    ds = {"train": object()}
    assert DataParallelTrainer(lambda: None, datasets=ds).datasets is ds
    with pytest.raises(RuntimeError, match="outside a training session"):
        train.get_dataset_shard()


# -- the checkpoint plane and the elastic format, pure ---------------------------


def test_commit_manifest_and_retention(tmp_path):
    from ray_tpu._private import external_storage as jstorage
    from ray_tpu_torch._private import external_storage as storage
    from ray_tpu_torch.train import checkpointing

    base = str(tmp_path / "run")
    os.makedirs(base)
    for step in (1, 2, 3):
        sd = os.path.join(base, checkpointing.step_dir_name(step))
        os.makedirs(sd)
        open(os.path.join(sd, "w.bin"), "wb").write(bytes([step]) * 32)
        if step != 2:  # step 2 is a crashed, never-committed save
            storage.write_commit_markers(
                sd, storage.build_manifest(sd, step=step, created=time.time()))
    # the port's manifest is the reference's: its reader accepts it
    manifest = jstorage.read_committed_manifest(
        os.path.join(base, checkpointing.step_dir_name(3)))
    assert manifest["step"] == 3 and set(manifest["files"]) == {"w.bin"}
    assert checkpointing.latest_checkpoint(base).path.endswith(checkpointing.step_dir_name(3))
    assert sorted(checkpointing.gc_checkpoints(base, keep=1)) == [1, 2]
    rows = checkpointing.list_checkpoints(base)
    assert [(r["step"], r["committed"]) for r in rows] == [(3, True)]


def _commit_elastic_step(pkg, base, step, arrays, world):
    checkpointing, elastic, storage = pkg
    step_dir = os.path.join(base, checkpointing.step_dir_name(step))
    for r in range(world):
        shard = checkpointing.shard_dir_name(r, world)
        elastic.save_elastic_shard(os.path.join(step_dir, shard) if shard else step_dir,
                                   arrays, rank=r, world_size=world, extra={"step": step})
    storage.write_commit_markers(step_dir,
                                 storage.build_manifest(step_dir, step=step, world_size=world))
    return step_dir


@pytest.mark.parametrize("save_world,load_world,saver", [
    (3, 1, "port"), (1, 4, "port"), (2, 3, "jax"), (4, 2, "jax")])
def test_elastic_reshard_n_to_m(tmp_path, save_world, load_world, saver):
    """N -> M: every new rank's slice, concatenated, is the saved array bit
    for bit; a checkpoint either package saved loads in the other."""
    from ray_tpu._private import external_storage as jstorage
    from ray_tpu.train import checkpointing as jckpt, elastic as jelastic
    from ray_tpu_torch._private import external_storage as pstorage
    from ray_tpu_torch.train import checkpointing as pckpt, elastic as pelastic

    port, ref = (pckpt, pelastic, pstorage), (jckpt, jelastic, jstorage)
    save, load = (port, ref) if saver == "port" else (ref, port)
    g = {"w": np.arange(20 * 5, dtype=np.float32).reshape(20, 5), "b": np.linspace(-1, 1, 7)}
    step_dir = _commit_elastic_step(save, str(tmp_path), 1, g, save_world)
    for name, want in g.items():
        slices = []
        for r in range(load_world):
            arrays, extra = load[1].load_elastic_state(step_dir, rank=r, world_size=load_world,
                                                       arrays=[name])
            assert extra == {"step": 1}
            slices.append(arrays[name])
        assert np.array_equal(np.concatenate(slices), want)
