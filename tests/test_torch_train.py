"""The port's training path against the JAX package's, on the CPU:
``loss_fn`` and its gradients, remat, two AdamW steps of
``build_lm_train_step``, and the in-place accumulation of the stacked
parameters' gradients.

Weights are made with numpy in the reference's shapes and carried into
both packages; both optimizers start from zero moments. Tolerances, fp32:

- the loss to 1e-4 relative (measured below 3e-7);
- each gradient to 5e-4 in relative Frobenius norm (measured up to
  1.1e-4, on TINY's embedding, whose gradient reaches 19 in magnitude: a
  float64 run of the port puts both packages' fp32 gradients at the same
  distance, so this is fp32 rounding, not a difference of method);
- after two AdamW steps, loss and grad_norm to 1e-3 relative (measured
  2.2e-4 on TINY, 1.1e-4 on the GPT-J config) and each parameter's total
  update to 1e-2 in relative Frobenius norm (measured up to 5.8e-3 on
  TINY, 2.7e-3 on the GPT-J config): Adam's first steps move each element by
  about lr whatever its gradient's size, so the few elements whose
  gradients lie at the rounding level move by lr in either package in a
  direction that rounding decides.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import transformer as JT  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from ray_tpu.parallel.spmd import build_lm_train_step as jax_build_lm_train_step  # noqa: E402
from ray_tpu_torch.models import transformer as PT  # noqa: E402
from ray_tpu_torch.parallel.spmd import build_lm_train_step, layer_leaves  # noqa: E402
from test_torch_transformer import carried, port_cfg  # noqa: E402

LOSS_RTOL, GRAD_RTOL = 1e-4, 5e-4
STEP_RTOL, UPDATE_RTOL = 1e-3, 1e-2


def rel_frobenius(got: np.ndarray, ref: np.ndarray) -> float:
    scale = max(np.linalg.norm(ref), 1e-30)
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref) / scale)

CONFIGS = {
    # sequential block, swiglu MLP
    "tiny_f32": dataclasses.replace(JT.TINY, dtype=jnp.float32),
    # GPT-J architecture: parallel block, gelu MLP, untied embeddings
    "gptj_f32": JT.TransformerConfig(
        vocab_size=101, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64,
        parallel_block=True, use_swiglu=False, dtype=jnp.float32, remat=False,
    ),
}


def _batch(cfg, b=2, s=16, seed=1):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1), (rs.rand(b, s) > 0.3).astype(np.float32)


def _port_value_and_grad(tp, cfg, tokens, targets, loss_mask=None):
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss = PT.loss_fn(
        leaves, torch.from_numpy(tokens), torch.from_numpy(targets), cfg,
        loss_mask=None if loss_mask is None else torch.from_numpy(loss_mask),
    )
    loss.backward()
    # a parameter the config leaves unused (GPT-J's mlp_norm) has no
    # gradient in torch and a zero one in JAX
    return loss.detach(), {
        k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in leaves.items()
    }


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_grads_match_jax(name, masked):
    cfg = CONFIGS[name]
    jp, tp = carried(cfg)
    tokens, targets, mask = _batch(cfg)
    mask = mask if masked else None

    def jloss(p):
        return JT.loss_fn(p, tokens, targets, cfg, loss_mask=mask)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jp)
    loss, grads = _port_value_and_grad(tp, port_cfg(cfg), tokens, targets, mask)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(ref_grads)
    for k in grads:
        assert rel_frobenius(grads[k].numpy(), np.asarray(ref_grads[k])) <= GRAD_RTOL, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_modes_give_identical_gradients(dtype):
    jp, tp = carried(CONFIGS["gptj_f32"], seed=2)
    base = dataclasses.replace(port_cfg(CONFIGS["gptj_f32"]), dtype=dtype)
    tp = {k: v.to(dtype) if v.dtype == torch.float32 and "norm" not in k else v for k, v in tp.items()}
    tokens, targets, _ = _batch(base, seed=3)
    results = [
        _port_value_and_grad(tp, dataclasses.replace(base, remat=remat, remat_policy=policy),
                             tokens, targets)
        for remat, policy in ((False, None), (True, None), (True, "dots"))
    ]
    loss0, grads0 = results[0]
    for loss, grads in results[1:]:
        assert torch.equal(loss, loss0)
        for k in grads0:
            assert torch.equal(grads[k], grads0[k]), k


def test_dots_policy_saves_projections_and_recomputes_attention():
    """The selective policy keeps the batch-1 products (projections) and
    sends attention's batched products to recompute."""
    from torch.utils.checkpoint import CheckpointPolicy

    proj = torch.zeros(1, 8, 4)
    att = torch.zeros(6, 8, 4)
    assert PT._dots_policy(None, torch.ops.aten.bmm.default, proj, proj) == CheckpointPolicy.MUST_SAVE
    assert PT._dots_policy(None, torch.ops.aten.mm.default, proj[0], proj[0].T) == CheckpointPolicy.MUST_SAVE
    assert PT._dots_policy(None, torch.ops.aten.bmm.default, att, att) == CheckpointPolicy.PREFER_RECOMPUTE
    assert PT._dots_policy(None, torch.ops.aten.exp.default, att) == CheckpointPolicy.PREFER_RECOMPUTE


def _jax_state(jp, cfg, lr):
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    bundle = jax_build_lm_train_step(cfg, mesh, learning_rate=lr)
    params = jax.tree.map(jax.device_put, {k: jnp.asarray(v) for k, v in jp.items()},
                          bundle.param_shardings)
    opt = optax.adamw(lr, weight_decay=0.01).init(params)
    return bundle, {"params": params, "opt": opt, "step": jnp.zeros((), jnp.int32)}


def test_two_adamw_steps_match_jax():
    """GPT-J's architecture (the training slice's target); the optimizer's
    arithmetic does not depend on the block, and TINY's gradients are held
    above."""
    cfg = CONFIGS["gptj_f32"]
    lr = 1e-3
    jp, tp = carried(cfg, seed=4)
    start = {k: np.asarray(v, np.float64) for k, v in jp.items()}
    tokens, targets, _ = _batch(cfg, b=4, s=12, seed=5)
    jbundle, jstate = _jax_state(jp, cfg, lr)
    bundle = build_lm_train_step(port_cfg(cfg), device="cpu", learning_rate=lr)
    state = bundle.state_from_params(tp)
    tok, tgt = bundle.shard_batch(tokens, targets)
    for step in range(2):
        jstate, jm = jbundle.step_fn(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        state, m = bundle.step_fn(state, tok, tgt)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=STEP_RTOL)
    assert state["step"] == int(jstate["step"]) == 2
    for k, v in state["params"].items():
        update = v.numpy() - start[k]
        ref_update = np.asarray(jstate["params"][k], np.float64) - start[k]
        assert rel_frobenius(update, ref_update) <= UPDATE_RTOL, k


def test_lm_train_step_loss_decreases():
    """Counterpart of ``test_parallel.py::test_lm_train_step_loss_decreases``:
    TINY in bf16, lr 1e-3, (8, 128) tokens, 5 steps."""
    bundle = build_lm_train_step(PT.TINY, device="cpu", learning_rate=1e-3)
    state = bundle.init_state(0)
    assert state["params"]["w_up"].dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 255, (8, 128), dtype=np.int32)
    tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))
    losses = []
    for _ in range(5):
        state, metrics = bundle.step_fn(state, tok, tgt)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
    assert losses[-1] < losses[0]


def _select_backward_count(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name == "aten::select_backward")


def test_step_makes_no_stack_sized_gradient_per_layer():
    """The step differentiates per-layer views of the stacked storage: no
    ``select_backward`` (each of which would fill a zero tensor the size of
    the whole stack), and each layer's gradient is made at its own size.
    Differentiating the stacks themselves, as a control, shows one per
    stacked parameter per layer."""
    cfg = dataclasses.replace(PT.TINY, n_layers=3)
    bundle = build_lm_train_step(cfg, device="cpu")
    state = bundle.init_state(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 255, (2, 16)))
    targets = torch.roll(tokens, -1, 1)
    assert _select_backward_count(lambda: bundle.step_fn(state, tokens, targets)) == 0
    w_up = state["opt"].leaves["w_up"]
    assert len(w_up) == 3 and all(g.grad.shape == (128, 512) for g in w_up)
    # the leaves share storage with the stacks the state holds
    assert w_up[1].data_ptr() == state["params"]["w_up"][1].data_ptr()

    stacked = {k: v.detach().clone().requires_grad_() for k, v in state["params"].items()}
    n_stacked = sum(1 for k in stacked if k not in PT.UNSTACKED)

    def naive():
        PT.loss_fn(stacked, tokens, targets, cfg).backward()

    assert _select_backward_count(naive) == n_stacked * cfg.n_layers


def test_step_updates_the_stacks_in_place():
    bundle = build_lm_train_step(PT.TINY, device="cpu", learning_rate=1e-2)
    state = bundle.init_state(1)
    w_up = state["params"]["w_up"]
    before = w_up.clone()
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 255, (2, 16)))
    state, _ = bundle.step_fn(state, tokens, torch.roll(tokens, -1, 1))
    assert state["params"]["w_up"] is w_up
    assert not torch.equal(w_up, before)


def test_layer_leaves_view_the_stacks():
    params = PT.init_params(torch.Generator().manual_seed(0), PT.TINY, device="cpu")
    leaves = layer_leaves(params)
    assert all(len(leaves[k]) == PT.TINY.n_layers for k in params if k not in PT.UNSTACKED)
    assert leaves["embed"].requires_grad and not params["embed"].requires_grad
    with torch.no_grad():
        leaves["wq"][1].add_(1.0)
    assert torch.equal(params["wq"][1], leaves["wq"][1])


def test_train_step_device_and_mesh_rules(monkeypatch):
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        build_lm_train_step(PT.TINY, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_lm_train_step(PT.TINY)  # the default device is cuda
    from ray_tpu_torch.entry import entry

    with pytest.raises(RuntimeError):
        entry()


def test_entry_forward_on_cpu():
    """The port's entry: the reference's flagship GPT-J-architecture
    config, a forward step over (2, 256) tokens."""
    import __graft_entry__
    from ray_tpu_torch.entry import entry, flagship_config

    ref_cfg = __graft_entry__._flagship_config()
    cfg = flagship_config()
    for f in dataclasses.fields(JT.TransformerConfig):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    fn, (params, tokens) = entry("cpu")
    with torch.inference_mode():
        logits = fn(params, tokens)
    assert logits.shape == (2, 256, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
