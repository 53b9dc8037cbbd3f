"""The port's RL building blocks (``ray_tpu_torch.rl``) against the JAX
package's (``ray_tpu.rl``), on the CPU, fp32, at the reference's widths
(CartPole: 4 observations, 2 actions; hidden (64, 64)).

Inputs are made from numpy seeds. Tolerances:

- ``params_from_jax`` carries a JAX ``init_mlp_policy`` tree bit-exact;
- ``apply_mlp_policy``: logits and values to 1e-5 absolute;
- ``vtrace_targets`` (T=16, N=8, with dones, rhos on both sides of both
  clips): vs and pg_adv to 1e-5 absolute;
- Adam and the global-norm clip against ``optax.chain(clip_by_global_norm,
  adam)``, three steps with the gradient norm above and below the clip:
  parameters to 1e-6 absolute, moments to 1e-7;
- the Huber loss against ``optax.huber_loss``, value and gradient: 1e-6;
- the numpy env, vector env, multi-agent env and connectors: bit-exact
  (they are copies of the reference's numpy code).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import optax  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import ray_tpu.rl as JR  # noqa: E402
import ray_tpu_torch.rl as PR  # noqa: E402
from ray_tpu.rl import connectors as JC  # noqa: E402
from ray_tpu.rl import env as JE  # noqa: E402
from ray_tpu.rl import impala as JI  # noqa: E402
from ray_tpu.rl import models as JM  # noqa: E402
from ray_tpu.rl.multi_agent import MultiAgentCartPole as JMultiAgentCartPole  # noqa: E402
from ray_tpu_torch.rl import connectors as PC  # noqa: E402
from ray_tpu_torch.rl import env as PE  # noqa: E402
from ray_tpu_torch.rl import impala as PI  # noqa: E402
from ray_tpu_torch.rl import models as PM  # noqa: E402
from ray_tpu_torch.rl import optim as PO  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

ATOL = 1e-5


def _jax_policy(seed=0, obs_dim=4, hidden=(64, 64)):
    return jax.tree.map(np.asarray, JM.init_mlp_policy(jax.random.PRNGKey(seed), obs_dim, 2,
                                                       hidden))


def test_all_names_match_the_reference():
    assert PR.__all__ == JR.__all__


def test_params_from_jax_carries_the_policy_tree_bit_exact():
    jp = _jax_policy()
    tp = params_from_jax(jp, device="cpu")
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 2
    assert jax.tree.structure(PO.to_numpy(tp)) == jax.tree.structure(jp)
    for a, b in zip(PM.tree_leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)


def test_init_mlp_policy_has_the_reference_tree_and_scales():
    gen = torch.Generator().manual_seed(0)
    tp = PM.init_mlp_policy(gen, 4, 2, (64, 64), device="cpu")
    jp = _jax_policy()
    assert jax.tree.structure(PO.to_numpy(tp)) == jax.tree.structure(jp)
    for a, b in zip(PM.tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape and a.requires_grad
    assert abs(tp["layers"][1]["w"].std().item() - (2 / 64) ** 0.5) < 0.02
    assert abs(tp["pi"]["w"].std().item() - 0.01) < 0.003
    again = PM.init_mlp_policy(torch.Generator().manual_seed(0), 4, 2, (64, 64), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(PM.tree_leaves(tp), PM.tree_leaves(again)))


@pytest.mark.parametrize("obs_dim,hidden", [(4, (64, 64)), (8, (32,))])
def test_apply_mlp_policy_matches_jax(obs_dim, hidden):
    jp = _jax_policy(1, obs_dim, hidden)
    obs = np.random.default_rng(2).normal(size=(33, obs_dim)).astype(np.float32)
    logits, values = jax.jit(JM.apply_mlp_policy)(jp, obs)
    tl, tv = PM.apply_mlp_policy(params_from_jax(jp, device="cpu"), torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(values), atol=ATOL, rtol=0)
    assert tuple(tl.shape) == (33, 2) and tuple(tv.shape) == (33,)


def test_sample_actions_is_reproducible_and_consistent():
    tp = params_from_jax(_jax_policy(3), device="cpu")
    obs = torch.from_numpy(np.random.default_rng(4).normal(size=(256, 4)).astype(np.float32))
    a1, lp1, v1 = PM.sample_actions(tp, obs, torch.Generator().manual_seed(5))
    a2, lp2, v2 = PM.sample_actions(tp, obs, torch.Generator().manual_seed(5))
    assert torch.equal(a1, a2) and torch.equal(lp1, lp2) and torch.equal(v1, v2)
    logits, values = PM.apply_mlp_policy(tp, obs)
    want = torch.log_softmax(logits, -1).gather(1, a1[:, None])[:, 0]
    torch.testing.assert_close(lp1, want, atol=0, rtol=0)
    torch.testing.assert_close(v1, values, atol=0, rtol=0)
    # near-uniform logits (0.01-scaled head): both actions are drawn
    assert 0.3 < a1.float().mean().item() < 0.7


def test_vtrace_targets_match_jax():
    rng = np.random.default_rng(6)
    T, N = 16, 8
    values = rng.normal(size=(T, N)).astype(np.float32)
    last_values = rng.normal(size=N).astype(np.float32)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.15
    # ratios well below and well above both clips
    rhos = np.exp(rng.normal(scale=1.0, size=(T, N))).astype(np.float32)
    assert (rhos < 0.7).any() and (rhos > 1.2).any() and dones.any()
    for clip_rho, clip_c in ((1.0, 1.0), (1.2, 0.7)):
        want = jax.jit(JI.vtrace_targets, static_argnums=(5, 6, 7))(
            values, last_values, rewards, dones, rhos, 0.99, clip_rho, clip_c)
        t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
        got = PI.vtrace_targets(t(values), t(last_values), t(rewards), t(dones), t(rhos), 0.99,
                                clip_rho, clip_c)
        for g, w in zip(got, want):
            assert not g.requires_grad
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_vtrace_targets_stop_the_gradient():
    v = torch.randn(4, 3, requires_grad=True)
    vs, adv = PI.vtrace_targets(v, torch.zeros(3), torch.ones(4, 3), torch.zeros(4, 3),
                                torch.ones(4, 3), 0.9)
    assert not vs.requires_grad and not adv.requires_grad


@pytest.mark.parametrize("grad_clip", [0.5, 1e4], ids=["norm_above_clip", "norm_below_clip"])
def test_adam_and_clip_match_optax(grad_clip):
    jp = _jax_policy(7)
    rng = np.random.default_rng(8)
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), jp)
             for _ in range(3)]
    norm = float(optax.global_norm(grads[0]))
    assert (norm > grad_clip) == (grad_clip == 0.5)
    tx = optax.chain(optax.clip_by_global_norm(grad_clip), optax.adam(3e-4))
    params, state = jp, tx.init(jp)
    step = jax.jit(lambda p, s, g: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    opt = PO.Adam(3e-4, grad_clip=grad_clip)
    tp = PM.load_params(jp, "cpu")
    ts = opt.init(tp)
    for g in grads:
        params, state = step(params, state, g)
        opt.step(tp, [torch.from_numpy(x) for x in jax.tree.leaves(g)], ts)
    for a, b in zip(PM.tree_leaves(tp), jax.tree.leaves(params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)
    adam_state = state[1][0]
    assert ts["count"] == int(adam_state.count) == 3
    for ours, theirs in ((ts["mu"], adam_state.mu), (ts["nu"], adam_state.nu)):
        for a, b in zip(PM.tree_leaves(ours), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)
    # optax's own state carries over into the port's
    loaded = opt.load_state(jax.tree.map(np.asarray, state), tp, "cpu")
    assert loaded["count"] == 3
    for a, b in zip(PM.tree_leaves(loaded["nu"]), jax.tree.leaves(adam_state.nu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_clip_scales_only_above_the_clip():
    opt = PO.Adam(1.0, grad_clip=0.5)
    for g, want in ((0.25, 0.25), (0.5, 0.25)):  # norms 0.5 (at the clip) and 1.0
        p = {"w": torch.zeros(4, requires_grad=True)}
        st = opt.init(p)
        opt.step(p, [torch.full((4,), g)], st)
        np.testing.assert_allclose(st["mu"]["w"].numpy(), 0.1 * want, rtol=1e-6)
    # torch's clip_grad_norm_ divides by norm + 1e-6, so it scales at the clip
    w = torch.nn.Parameter(torch.zeros(4))
    w.grad = torch.full((4,), 0.25)
    torch.nn.utils.clip_grad_norm_([w], 0.5)
    assert w.grad[0].item() != 0.25


def test_huber_matches_optax():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    want = np.asarray(optax.huber_loss(x))
    want_g = np.asarray(jax.grad(lambda v: optax.huber_loss(v).sum())(x))
    t = torch.from_numpy(x).requires_grad_()
    got = F.huber_loss(t, torch.zeros_like(t), reduction="none", delta=1.0)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.grad.numpy(), want_g, atol=1e-6, rtol=0)


def test_get_state_copies_parameters():
    algo = PR.PPOConfig().env_runners(num_envs_per_env_runner=2,
                                      rollout_fragment_length=8).build(device="cpu")
    before = algo.get_state()["params"]
    kept = jax.tree.map(np.copy, before)
    algo.train()
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(kept)):
        np.testing.assert_array_equal(a, b)


# -- numpy copies ------------------------------------------------------------


def test_cartpole_and_vector_env_match_the_reference():
    for cls in (PE.CartPoleEnv, JE.CartPoleEnv):
        assert cls.spec.obs_dim == 4 and cls.spec.num_actions == 2
    pv, jv = PE.VectorEnv("CartPole-v1", 4, seed=3), JE.VectorEnv("CartPole-v1", 4, seed=3)
    np.testing.assert_array_equal(pv.reset(), jv.reset())
    rng = np.random.default_rng(9)
    for _ in range(120):
        a = rng.integers(0, 2, 4)
        for x, y in zip(pv.step(a), jv.step(a)):
            np.testing.assert_array_equal(x, y)


def test_env_registry_is_the_ports_own():
    PE.register_env("PortOnly-v0", lambda seed=None: PE.CartPoleEnv(seed=seed))
    assert isinstance(PE.make_env("PortOnly-v0", seed=1), PE.CartPoleEnv)
    with pytest.raises(ValueError):
        JE.make_env("PortOnly-v0")
    with pytest.raises(ValueError):
        PE.make_env("DoesNotExist-v99")


def test_multi_agent_cartpole_matches_the_reference():
    pe, je = PR.MultiAgentCartPole(num_agents=3, seed=0), JMultiAgentCartPole(num_agents=3,
                                                                               seed=0)
    po, jo = pe.reset()[0], je.reset()[0]
    rng = np.random.default_rng(10)
    for _ in range(200):
        assert po.keys() == jo.keys()
        for k in po:
            np.testing.assert_array_equal(po[k], jo[k])
        acts = {a: int(rng.integers(0, 2)) for a in po}
        pr, jr = pe.step(acts), je.step(acts)
        assert pr[1:4] == jr[1:4]
        po, jo = pr[0], jr[0]
        if pr[2]["__all__"] or pr[3]["__all__"]:
            po, jo = pe.reset()[0], je.reset()[0]


def test_connector_pipeline_matches_the_reference():
    make = lambda C: C.ConnectorPipeline([C.NormalizeObservations(), C.FrameStack(k=3),  # noqa
                                          C.ClipActions()])
    pp, jp = make(PC), make(JC)
    assert pp.out_dim(4) == jp.out_dim(4) == 12
    rng = np.random.default_rng(11)
    for _ in range(20):
        obs = rng.normal(size=(5, 4)).astype(np.float32)
        dones = rng.random(5) < 0.2
        np.testing.assert_array_equal(pp(obs, dones), jp(obs, dones))
    acts = rng.normal(size=3) * 3
    np.testing.assert_array_equal(pp.transform_action(acts), jp.transform_action(acts))
    ps, js = pp.get_state(), jp.get_state()
    np.testing.assert_array_equal(ps[0]["mean"], js[0]["mean"])
    np.testing.assert_array_equal(ps[1]["buf"], js[1]["buf"])
