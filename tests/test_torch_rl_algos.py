"""The port's RL algorithms (``ray_tpu_torch.rl``) against the JAX
package's (``ray_tpu.rl``), on the CPU, fp32, at the reference's widths
(CartPole, hidden (64, 64)) and default configurations.

Both sides start from the JAX algorithm's parameters, carried over by
``set_state(jax_algo.get_state())``; batches are made from numpy seeds.

- **One learner update** (PPO with the gradient norm above and below
  ``grad_clip``, IMPALA with one padded lane masked, APPO, DQN double and
  plain Q, SAC, BC, MARWIL, CQL, multi-agent PPO) against the JAX
  ``jax.jit``-ed update on the same batch: losses and metrics to 1e-5
  absolute (1e-5 relative above 1), every parameter, target network and
  log-alpha after the update to 1e-5 absolute.
- **Three training steps** where all randomness is numpy's (DQN, SAC,
  multi-agent PPO; BC, MARWIL and CQL on one in-test dataset): the actions
  both sides take are compared step by step. Where one differs, JAX's top
  two scores (Q-values for DQN, logits plus the shared Gumbel draw for SAC
  and multi-agent PPO) must lie within 1e-4 of each other there, and the
  runs are not compared past it; otherwise reported metrics to 1e-4
  relative and 1e-5 absolute, parameters to 1e-5 absolute.
- **One training step from an injected rollout** (PPO's 32 minibatch
  updates, IMPALA, APPO; the runners' sampled actions are the port's own
  bits, so both sides get the same rollout): metrics and parameters as
  for the three-step runs.
- PPO learns CartPole to a mean return of 150 within 49 iterations and
  101,000 env steps (``tests/test_rl.py``'s bar); checkpoints restore; a
  JAX PPO's parameters give the same greedy ``evaluate()`` returns.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import ray_tpu.rl as JR  # noqa: E402
import ray_tpu_torch.rl as PR  # noqa: E402
from ray_tpu_torch.rl.models import tree_leaves  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

ATOL = 1e-5
RUN_RTOL = 1e-4
TOP2 = 1e-4


def _assert_trees_close(port_tree, jax_tree, atol=ATOL, what=""):
    assert jax.tree.structure(port_tree) == jax.tree.structure(jax.tree.map(np.asarray,
                                                                            jax_tree)), what
    for a, b in zip(jax.tree.leaves(port_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0,
                                   err_msg=what)


def _assert_metrics_close(port, ref, rtol=ATOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(port[k]), float(ref[k]), atol=ATOL, rtol=rtol,
                                   err_msg=k)


def _pair(name, **training):
    """A JAX algorithm and the port's (CPU), the port loaded with JAX's
    initial state."""
    jcfg = getattr(JR, name)().env_runners(num_env_runners=0, num_envs_per_env_runner=8)
    pcfg = getattr(PR, name)().env_runners(num_env_runners=0, num_envs_per_env_runner=8)
    for cfg in (jcfg, pcfg):
        cfg.training(**training).debugging(seed=0)
        if name == "MultiAgentPPOConfig":
            cfg.environment(lambda seed=None: JR.MultiAgentCartPole(num_agents=2, seed=seed))
            cfg.multi_agent(policies=["p0", "p1"],
                            policy_mapping_fn=lambda aid: "p0" if aid == "agent_0" else "p1")
    if name == "MultiAgentPPOConfig":
        pcfg.environment(lambda seed=None: PR.MultiAgentCartPole(num_agents=2, seed=seed))
    ja, pa = jcfg.build(), pcfg.build(device="cpu")
    pa.set_state(ja.get_state())
    return ja, pa


class _Dataset:
    """The offline dataset contract both packages read: ``materialize()``
    and ``iter_batches(batch_size=, drop_last=)`` over dict-of-array rows."""

    def __init__(self, columns):
        self.columns = columns

    def materialize(self):
        return self

    def iter_batches(self, batch_size, drop_last=False):
        n = len(next(iter(self.columns.values())))
        stop = n - n % batch_size if drop_last else n
        for s in range(0, stop, batch_size):
            yield {k: v[s:s + batch_size] for k, v in self.columns.items()}


def _dataset(n=700, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(scale=0.5, size=(n, 4)).astype(np.float32)
    return _Dataset({
        "obs": obs,
        "actions": (obs[:, 2] + 0.25 * obs[:, 3] > 0).astype(np.int64),
        "returns": rng.uniform(0, 60, n).astype(np.float32),
        "rewards": np.ones(n, np.float32),
        "next_obs": (obs + rng.normal(scale=0.05, size=(n, 4))).astype(np.float32),
        "dones": (rng.random(n) < 0.05).astype(np.float32),
    })


def _offline_pair(name):
    ds = _dataset()
    jcfg = getattr(JR, name)().offline_data(ds).debugging(seed=0)
    pcfg = getattr(PR, name)().offline_data(ds).debugging(seed=0)
    ja, pa = jcfg.build(), pcfg.build(device="cpu")
    pa.set_state(ja.get_state())
    return ja, pa


# -- one learner update -------------------------------------------------------


def _ppo_batch(n=512, seed=1):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "logp_old": (np.log(0.5) + rng.normal(scale=0.1, size=n)).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "returns": rng.normal(scale=5.0, size=n).astype(np.float32)}


def _vtrace_batch(T=32, N=8, pad=1, seed=2):
    rng = np.random.default_rng(seed)
    b = {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
         "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
         "logp": (np.log(0.5) + rng.normal(scale=0.3, size=(T, N))).astype(np.float32),
         "rewards": np.ones((T, N), np.float32),
         "dones": (rng.random((T, N)) < 0.1).astype(np.float32),
         "last_values": rng.normal(size=N).astype(np.float32),
         "mask": np.ones(N, np.float32)}
    # the last `pad` lanes are padding, zero-filled as the reference pads
    for k, v in b.items():
        if k == "mask" or k == "last_values":
            v[N - pad:] = 0.0
        else:
            v[:, N - pad:] = 0
    return b


def _replay_batch(n, seed=3):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": np.ones(n, np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


def _other_params(seed):
    from ray_tpu.rl.models import init_mlp_policy

    return jax.tree.map(np.asarray, init_mlp_policy(jax.random.PRNGKey(seed), 4, 2, (64, 64)))


def _grad_norm(loss_fn, params, *args):
    from ray_tpu_torch.rl.optim import value_and_grad

    _, _, grads = value_and_grad(loss_fn, params, *args)
    return float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))


@pytest.mark.parametrize("grad_clip", [0.5, 1e4], ids=["norm_above_clip", "norm_below_clip"])
def test_ppo_update_matches_jax(grad_clip):
    from ray_tpu_torch.rl.ppo import ppo_loss

    ja, pa = _pair("PPOConfig", grad_clip=grad_clip)
    batch = _ppo_batch()
    cfg = pa.config
    norm = _grad_norm(ppo_loss, pa.params, pa._to_device(batch), cfg.clip_param,
                      cfg.vf_loss_coeff, cfg.entropy_coeff)
    assert (norm > grad_clip) == (grad_clip == 0.5), norm
    jp, jo, jm = ja._update(ja.params, ja.opt_state, batch)
    pp, po, pm = pa._update(pa.params, pa.opt_state, pa._to_device(batch))
    _assert_metrics_close(pm, jm)
    _assert_trees_close(pa.get_state()["params"], jp)
    _assert_trees_close(pa.get_state()["opt_state"]["nu"], jo[1][0].nu, atol=1e-7)


@pytest.mark.parametrize("name", ["IMPALAConfig", "APPOConfig"])
def test_vtrace_update_matches_jax_with_a_masked_lane(name):
    ja, pa = _pair(name)
    batch = _vtrace_batch()
    jp, _, jm = ja._update(ja.params, ja.opt_state, batch)
    _, _, pm = pa._update(pa.params, pa.opt_state, pa._to_device(batch))
    _assert_metrics_close(pm, jm)
    _assert_trees_close(pa.get_state()["params"], jp)
    # the padded lane carries no weight: changing its data changes nothing
    ja2, pa2 = _pair(name)
    noisy = _vtrace_batch()
    noisy["obs"][:, -1] = 7.0
    noisy["rewards"][:, -1] = -3.0
    _, _, pm2 = pa2._update(pa2.params, pa2.opt_state, pa2._to_device(noisy))
    _assert_metrics_close(pm2, pm)


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_jax(double_q):
    ja, pa = _pair("DQNConfig", double_q=double_q)
    state = ja.get_state()
    state["target_params"] = _other_params(5)
    ja.set_state(state)
    pa.set_state(state)
    batch = _replay_batch(64)
    jp, _, jm = ja._update(ja.params, ja.target_params, ja.opt_state, batch)
    _, _, pm = pa._update(pa.params, pa.target_params, pa.opt_state, pa._to_device(batch))
    _assert_metrics_close(pm, jm)
    _assert_trees_close(pa.get_state()["params"], jp)
    # the target network is a snapshot, not the online network
    _assert_trees_close(pa.get_state()["target_params"], state["target_params"], atol=0)


def test_sac_update_matches_jax():
    ja, pa = _pair("SACConfig")
    # targets apart from the critics, so the Polyak step shows
    ja.q1_target, ja.q2_target = _other_params(6), _other_params(7)
    pa.q1_target = params_from_jax(ja.q1_target, device="cpu")
    pa.q2_target = params_from_jax(ja.q2_target, device="cpu")
    batch = _replay_batch(128)
    state, jm = ja._update(ja._state_tuple(), batch)
    pm = pa._update(pa._to_device(batch))
    _assert_metrics_close(pm, jm)
    got = pa.get_state()
    for i, key in enumerate(("actor", "q1", "q2")):
        _assert_trees_close(got[key], state[i], what=key)
    _assert_trees_close(jax.tree.map(lambda t: t.detach().numpy(), pa.q1_target), state[3])
    _assert_trees_close(jax.tree.map(lambda t: t.detach().numpy(), pa.q2_target), state[4])
    np.testing.assert_allclose(got["log_alpha"], np.asarray(state[5]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["BCConfig", "MARWILConfig"])
def test_bc_update_matches_jax(name):
    ja, pa = _offline_pair(name)
    batch = ja._next_batch()
    assert ("returns" in batch) == (name == "MARWILConfig")
    jp, _, jm = ja._update(ja.params, ja.opt_state, batch)
    _, _, pm = pa._update(pa.params, pa.opt_state, pa._to_device(batch))
    _assert_metrics_close(pm, jm)
    _assert_trees_close(pa.get_state()["params"], jp)


def test_cql_update_matches_jax():
    ja, pa = _offline_pair("CQLConfig")
    state = ja.get_state()
    state["target_params"] = _other_params(8)
    ja.set_state(state)
    pa.set_state(state)
    batch = ja._next_batch()
    jp, jt, _, jm = ja._update(ja.params, ja.target_params, ja.opt_state, batch)
    _, _, _, pm = pa._update(pa.params, pa.target_params, pa.opt_state, pa._to_device(batch))
    _assert_metrics_close(pm, jm)
    got = pa.get_state()
    _assert_trees_close(got["params"], jp)
    _assert_trees_close(got["target_params"], jt)


def test_multi_agent_ppo_update_matches_jax():
    ja, pa = _pair("MultiAgentPPOConfig")
    batch = _ppo_batch(256, seed=4)
    jp, _, jl = ja._update(ja.params["p1"], ja.opt_states["p1"], batch)
    _, _, pl = pa._update(pa.params["p1"], pa.opt_states["p1"], pa._to_device(batch))
    np.testing.assert_allclose(float(pl), float(jl), atol=ATOL, rtol=ATOL)
    _assert_trees_close(pa.get_state()["params"]["p1"], jp)


# -- whole runs ---------------------------------------------------------------


class _RecordingRng:
    """A numpy Generator that keeps its Gumbel draws."""

    def __init__(self, rng):
        self._rng, self.gumbel_draws = rng, []

    def gumbel(self, *args, **kwargs):
        u = self._rng.gumbel(*args, **kwargs)
        self.gumbel_draws.append(u)
        return u

    def __getattr__(self, name):
        return getattr(self._rng, name)


def _record(algo, kind):
    """Wrap an algorithm's acting so that each acting call logs its scores
    (what the action is the argmax of) and the actions taken."""
    log = {"scores": [], "actions": []}
    if kind == "dqn":
        q_values, step = algo._q_values, algo.envs.step

        def q(p, o):
            out = np.asarray(q_values(p, o))
            log["scores"].append(out)
            return out

        def env_step(actions):
            log["actions"].append(np.asarray(actions))
            return step(actions)

        algo._q_values, algo.envs.step = q, env_step
        return log
    rng = algo._rng = _RecordingRng(algo._rng)
    logits_attr = "_policy_logits" if kind == "sac" else "_act"
    inner = getattr(algo, logits_attr)
    logits_log = []

    def logits_fn(p, o):
        out = inner(p, o)
        first = out if kind == "sac" else out[0]
        logits_log.append(np.asarray(first))
        return out

    setattr(algo, logits_attr, logits_fn)
    if kind == "sac":
        step = algo.envs.step

        def env_step(actions):
            log["actions"].append(np.asarray(actions))
            return step(actions)

        algo.envs.step = env_step
    else:
        act_fn = algo._act_fn

        def recorded_act_fn(pid, obs):
            out = act_fn(pid, obs)
            log["actions"].append(np.asarray(out[0]))
            return out

        algo._act_fn = recorded_act_fn

    def scores():
        return [lg[: len(u)] + u for lg, u in zip(logits_log, rng.gumbel_draws)]

    log["scores_fn"] = scores
    return log


def _acted_alike(jlog, plog) -> bool:
    """True where both runs took the same actions throughout; else the
    first difference must be a near tie in JAX's scores (top-two rule)."""
    jscores = jlog["scores_fn"]() if "scores_fn" in jlog else jlog["scores"]
    assert len(jlog["actions"]) == len(plog["actions"])
    for k, (aj, ap) in enumerate(zip(jlog["actions"], plog["actions"])):
        rows = np.nonzero(aj != ap)[0]
        if len(rows):
            top = np.sort(jscores[k][rows[0]])
            assert top[-1] - top[-2] < TOP2, (k, rows[0], jscores[k][rows[0]])
            return False
    return True


@pytest.mark.parametrize("name,kind", [("DQNConfig", "dqn"), ("SACConfig", "sac"),
                                       ("MultiAgentPPOConfig", "ma")])
def test_three_training_steps_match_jax(name, kind):
    ja, pa = _pair(name)
    jlog, plog = _record(ja, kind), _record(pa, kind)
    jres = [ja.train() for _ in range(3)]
    pres = [pa.train() for _ in range(3)]
    if not _acted_alike(jlog, plog):
        return
    for p, j in zip(pres, jres):
        _assert_metrics_close(p, j, rtol=RUN_RTOL)
    jstate, pstate = ja.get_state(), pa.get_state()
    keys = ["params"] if kind != "sac" else ["actor", "q1", "q2", "log_alpha"]
    for key in keys:
        _assert_trees_close(pstate[key], jstate[key], what=key)
    if kind == "dqn":
        _assert_trees_close(pstate["target_params"], jstate["target_params"])
        assert jres[-1]["td_loss"] > 0  # past learning_starts: the updates ran


@pytest.mark.parametrize("name", ["BCConfig", "MARWILConfig", "CQLConfig"])
def test_offline_three_training_steps_match_jax(name):
    ja, pa = _offline_pair(name)
    for _ in range(3):
        _assert_metrics_close(pa.train(), ja.train(), rtol=RUN_RTOL)
    jstate, pstate = ja.get_state(), pa.get_state()
    _assert_trees_close(pstate["params"], jstate["params"])
    if name == "CQLConfig":
        _assert_trees_close(pstate["target_params"], jstate["target_params"])
    assert pstate["samples"] == jstate["samples"] == 3 * 16 * 256


def _rollout(T=128, N=8, seed=9):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
            "logp": (np.log(0.5) + rng.normal(scale=0.1, size=(T, N))).astype(np.float32),
            "values": rng.normal(size=(T, N)).astype(np.float32),
            "rewards": np.ones((T, N), np.float32),
            "dones": rng.random((T, N)) < 0.05,
            "last_values": rng.normal(size=N).astype(np.float32),
            "episode_returns": np.array([21.0, 35.0], np.float32)}


@pytest.mark.parametrize("name", ["PPOConfig", "IMPALAConfig", "APPOConfig"])
def test_one_training_step_from_an_injected_rollout_matches_jax(name):
    ja, pa = _pair(name)
    rollout = _rollout()
    for algo in (ja, pa):
        algo.runners.sample = lambda params: [copy.deepcopy(rollout)]
    _assert_metrics_close(pa.train(), ja.train(), rtol=RUN_RTOL)
    _assert_trees_close(pa.get_state()["params"], ja.get_state()["params"])


# -- learning, checkpoints, evaluation ---------------------------------------


def test_ppo_learns_cartpole():
    cfg = (
        PR.PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                     rollout_fragment_length=128)
        .debugging(seed=0)
    )
    algo = cfg.build(device="cpu")
    best = 0.0
    for _ in range(49):  # <= ~100k env steps, the reference's budget
        result = algo.train()
        best = max(best, result["episode_return_mean"])
        if best >= 150:
            break
    assert best >= 150, f"PPO failed to reach 150 (best {best})"
    assert result["num_env_steps_sampled_lifetime"] <= 101_000


def test_save_restore(tmp_path):
    cfg = PR.PPOConfig().env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                                     rollout_fragment_length=32)
    algo = cfg.build(device="cpu")
    algo.train()
    path = algo.save(str(tmp_path / "ckpt"))
    algo2 = cfg.build(device="cpu")
    algo2.restore(path)
    assert algo2.iteration == 1
    for a, b in zip(tree_leaves(algo.params), tree_leaves(algo2.params)):
        assert torch.equal(a, b)
    assert algo2.opt_state["count"] == algo.opt_state["count"] > 0
    # the same next step from the same state and the same injected rollout
    rollout = _rollout(T=32, N=4)
    for a in (algo, algo2):
        a.runners.sample = lambda params: [copy.deepcopy(rollout)]
    r1, r2 = algo.train(), algo2.train()
    assert r2["training_iteration"] == 2 and r1["total_loss"] == r2["total_loss"]


def test_jax_params_give_the_same_greedy_evaluation():
    ja = JR.PPOConfig().env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                                    rollout_fragment_length=64).debugging(seed=0).build()
    for _ in range(6):
        ja.train()
    pa = PR.PPOConfig().debugging(seed=0).build(device="cpu")
    pa.set_state(ja.get_state())
    want, got = ja.evaluate(num_episodes=3), pa.evaluate(num_episodes=3)
    assert got == want, (got, want)
    assert pa.compute_single_action([0.0, 0.0, 0.0, 0.0]) == ja.compute_single_action(
        [0.0, 0.0, 0.0, 0.0])


def test_evaluate_uses_trained_connector_state_without_mutating_it():
    algo = (
        PR.PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                     rollout_fragment_length=32,
                     env_to_module_connector=lambda: [PR.NormalizeObservations(),
                                                      PR.FrameStack(k=2)])
        .debugging(seed=0)
        .build(device="cpu")
    )
    assert algo.params["layers"][0]["w"].shape[0] == 8  # sized for the pipeline's output
    algo.train()
    pipe = algo.runners.local.connectors
    before = copy.deepcopy(pipe.get_state())
    out = algo.evaluate(num_episodes=2)["evaluation"]
    assert out["episodes_this_iter"] == 2
    after = pipe.get_state()
    assert after[0]["count"] == before[0]["count"] > 0
    np.testing.assert_array_equal(after[0]["mean"], before[0]["mean"])
    np.testing.assert_array_equal(after[1]["buf"], before[1]["buf"])


# -- what raises --------------------------------------------------------------


def test_remote_runners_and_learner_groups_raise():
    # remote env runners and learner groups are actors of the port's runtime
    # (their tests are tests/test_torch_rl_remote.py and
    # tests/test_torch_learner_group.py): without a started runtime they raise
    import ray_tpu_torch

    assert not ray_tpu_torch.is_initialized()
    with pytest.raises(RuntimeError, match=r"init\(\) has not been called"):
        PR.PPOConfig().env_runners(num_env_runners=2).build(device="cpu")
    with pytest.raises(RuntimeError, match=r"init\(\) has not been called"):
        PR.IMPALAConfig().learners(num_learner_devices=2).build(device="cpu")
    with pytest.raises(RuntimeError, match=r"init\(\) has not been called"):
        PR.APPOConfig().learners(num_learner_workers=2).build(device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (PR.PPOConfig(), PR.DQNConfig(), PR.SACConfig()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cfg.build()  # the default device is cuda
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.BCConfig().offline_data(_dataset()).build(device="cuda")
