"""The port's learner group (``ray_tpu_torch.rl.learner_group``) against the
JAX package's IMPALA learner over several devices, on the CPU.

The port's runtime is started once for the module (two CPUs, no pre-started
workers); the reference's learner runs in-process on two of its virtual CPU
devices (``num_learner_devices=2``: one jitted program over a ``data``
mesh). Both start from the reference's initial parameters.

- A two-rank gloo ``SPMDLearnerGroup`` update (IMPALA and APPO) equals the
  reference's two-device update and the port's one-device update on a batch
  of 8 lanes whose two shards hold 4 and 1 unmasked lanes: metrics and
  every parameter to 1e-5 absolute (``tests/test_torch_rl_algos.py``'s
  rule for one update). The masked mean is over the global batch.
- A learner killed between updates: the next update restarts the group,
  and its params and Adam moments equal an uninterrupted group's bit for
  bit (the restarted ranks load the state rank 0 returned last, and both
  groups run the same arithmetic).
- IMPALA with ``num_learner_workers=2`` and with ``num_learner_devices=2``
  trains two iterations; the ``rl`` usage record; ``mesh_from_pod_type``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import ray_tpu.rl as JR  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.rl as PR  # noqa: E402
from ray_tpu_torch.rl.learner_group import SPMDLearnerGroup  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module")
def runtime():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    try:
        ray_tpu_torch.init(num_cpus=2, _system_config={"prestart_workers": False})
        # start the fork server (it imports torch) while the reference compiles
        ray_tpu_torch.remote(lambda: None).remote()
        yield
    finally:
        ray_tpu_torch.shutdown()


def _vtrace_batch(T=16, N=8, masked=(5, 6, 7), seed=2):
    """A learner batch whose masked lanes are zero-filled, as the reference
    pads them."""
    rng = np.random.default_rng(seed)
    b = {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
         "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
         "logp": (np.log(0.5) + rng.normal(scale=0.3, size=(T, N))).astype(np.float32),
         "rewards": np.ones((T, N), np.float32),
         "dones": (rng.random((T, N)) < 0.1).astype(np.float32),
         "last_values": rng.normal(size=N).astype(np.float32),
         "mask": np.ones(N, np.float32)}
    for k, v in b.items():
        if k in ("mask", "last_values"):
            v[list(masked)] = 0.0
        else:
            v[:, list(masked)] = 0
    return b


def _configs(name, devices):
    out = []
    for R in (JR, PR):
        cfg = getattr(R, name)().env_runners(num_env_runners=0, num_envs_per_env_runner=8)
        out.append(cfg.learners(num_learner_devices=devices).debugging(seed=0))
    return out


def _group_config(algo, loss_name, init_params, **extra):
    return {"cfg_vals": dict(algo._cfg_vals), "update_builder": loss_name, "obs_dim": 4,
            "num_actions": 2, "hidden": algo.config.hidden, "lr": algo.config.lr,
            "grad_clip": algo.config.grad_clip, "seed": 0, "init_params": init_params,
            "device": "cpu", **extra}


def _assert_trees_close(got, want, atol=ATOL, what=""):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("name,loss_name", [("IMPALAConfig", "impala"), ("APPOConfig", "appo")])
def test_two_rank_group_matches_two_device_reference(runtime, name, loss_name):
    jcfg, pcfg = _configs(name, 1)
    ja2 = jcfg.learners(num_learner_devices=2).build()
    pa = pcfg.build(device="cpu")
    init = jax.tree.map(np.asarray, ja2.get_state()["params"])
    pa.set_state({"params": init})
    batch = _vtrace_batch()
    shards_unmasked = [batch["mask"][:4].sum(), batch["mask"][4:].sum()]
    assert shards_unmasked == [4.0, 1.0]  # the shards' masks differ
    jp, _, jm = ja2._update(ja2.params, ja2.opt_state, batch)
    _, _, pm = pa._update(pa.params, pa.opt_state, pa._to_device(batch))

    group = SPMDLearnerGroup(2, _group_config(pa, loss_name, init), num_cpus_per_worker=1.0,
                             init_timeout_s=120, update_timeout_s=120)
    try:
        assert group.total_devices == 2
        gm = group.update(batch)
        gp = group.cached_params()
    finally:
        group.stop()
    assert sorted(gm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(gm[k], float(jm[k]), atol=ATOL, rtol=ATOL, err_msg=k)
        np.testing.assert_allclose(gm[k], float(pm[k]), atol=ATOL, rtol=ATOL, err_msg=k)
    _assert_trees_close(gp, jp, what="group vs the reference's two devices")
    _assert_trees_close(gp, pa.get_state()["params"], what="group vs the port's one device")


def test_killed_learner_restarts_the_group_with_its_state(runtime):
    _, pcfg = _configs("IMPALAConfig", 1)
    pa = pcfg.build(device="cpu")
    init = pa.get_state()["params"]
    b1, b2, b3 = (_vtrace_batch(seed=s) for s in (3, 4, 5))

    def run(kill: bool):
        group = SPMDLearnerGroup(2, _group_config(pa, "impala", init), init_timeout_s=120,
                                 update_timeout_s=120)
        try:
            group.update(b1)
            if kill:
                ray_tpu_torch.kill(group.workers[1])
            group.update(b2)
            group.update(b3)
            return group._attempt, group.cached_params(), group.cached_opt_state()
        finally:
            group.stop()

    attempts, params, opt = run(kill=True)
    calm_attempts, calm_params, calm_opt = run(kill=False)
    assert (attempts, calm_attempts) == (1, 0)
    assert int(opt["count"]) == int(calm_opt["count"]) == 3
    for got, want in ((params, calm_params), (opt["mu"], calm_opt["mu"]), (opt["nu"], calm_opt["nu"])):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("learners", [{"num_learner_workers": 2}, {"num_learner_devices": 2}],
                         ids=["workers", "devices"])
def test_impala_trains_through_the_group(runtime, learners):
    algo = (PR.IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=6, rollout_fragment_length=16)
            .learners(**learners).debugging(seed=0).build(device="cpu"))
    try:
        assert algo._group is not None and algo._group.total_devices == 2
        for i in range(2):
            result = algo.train()
            assert result["num_env_steps_sampled_lifetime"] == 6 * 16 * (i + 1)
            assert all(np.isfinite(result[k]) for k in ("pg_loss", "vf_loss", "entropy"))
        # the runner acts with the group's parameters
        np.testing.assert_array_equal(algo.get_state()["params"]["pi"]["w"],
                                      algo._group.cached_params()["pi"]["w"])
    finally:
        algo.stop()


def test_rl_usage_is_recorded(tmp_path):
    import json

    from ray_tpu_torch._private import usage

    assert "rl" in usage.get_usage_report()["libraries_used"]
    with open(usage.write_usage_report(str(tmp_path))) as fh:
        assert "rl" in json.load(fh)["libraries_used"]


def test_mesh_from_pod_type_checks_the_group():
    from ray_tpu_torch.parallel import distributed as D
    from ray_tpu_torch.parallel.mesh import mesh_from_pod_type, pod_chip_count

    assert pod_chip_count("v5litepod-64") == 64 and pod_chip_count("v5litepod") == 0
    D.initialize(f"127.0.0.1:{D.free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        with pytest.raises(ValueError, match="has 4 chips but the process group has 1 ranks"):
            mesh_from_pod_type("v5litepod-4")
        mesh = mesh_from_pod_type("v5litepod-1")
        assert mesh.shape["data"] == 1 and mesh.size == 1
    finally:
        D.shutdown()
