"""The port's sharded ``build_lm_train_step`` on four gloo ranks against the
JAX package's step on a mesh of the same shape (four of the virtual CPU
devices): TINY in fp32, the same numpy weights carried into both, two
AdamW steps from zero moments on one global batch. Then the sharded
``forward`` and masked ``loss_fn`` and their gradients (grouped-query
heads, tied embeddings, remat) against the JAX package's. The ranks run
in processes that import torch and never jax (``test_torch_rank_jobs``).

Tolerances are those of the single-device parity test
(``test_torch_train.py``), fp32: per step, loss and grad_norm to 1e-3
relative; after the two steps, each parameter's total update to 1e-2 in
relative Frobenius norm (Adam's first steps move an element by about lr
whatever its gradient's size, so elements whose gradients lie at the
rounding level move in a direction rounding decides). On one device the
gradients agree to 1.1e-4 relative Frobenius (TINY's embedding). The
forward's logits to 1e-4 absolute and relative, the loss to 1e-4 relative
and each gradient to 5e-4 relative Frobenius (the single-device tests'
tolerances, ``test_torch_transformer.py`` and ``test_torch_train.py``).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import transformer as JT  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from ray_tpu.parallel.spmd import build_lm_train_step  # noqa: E402
from test_torch_rank_jobs import WORLD, forward_and_grads, ranks, train_steps  # noqa: E402,F401
from test_torch_train import GRAD_RTOL, LOSS_RTOL, rel_frobenius  # noqa: E402
from test_torch_transformer import numpy_params, port_cfg  # noqa: E402

STEP_RTOL, UPDATE_RTOL = 1e-3, 1e-2
LR = 1e-3
CFG = dataclasses.replace(JT.TINY, dtype=jnp.float32)

# (mesh, context_parallel, this rank's shard of w_up (L, D, F) and of embed (V, D))
CASES = {
    "data2_fsdp2": (dict(data=2, fsdp=2), False, (2, 64, 512), (256, 64)),
    "fsdp2_tensor2": (dict(fsdp=2, tensor=2), False, (2, 64, 256), (128, 64)),
    "context2_tensor2": (dict(context=2, tensor=2), True, (2, 128, 256), (128, 128)),
}


def _jax_steps(sizes, context_parallel, params, tokens, targets, steps):
    mesh = create_mesh(MeshConfig(**sizes), devices=jax.devices()[:WORLD])
    bundle = build_lm_train_step(CFG, mesh, learning_rate=LR, context_parallel=context_parallel)
    p = jax.tree.map(jax.device_put, {k: jnp.asarray(v) for k, v in params.items()},
                     bundle.param_shardings)
    state = {"params": p, "opt": optax.adamw(LR, weight_decay=0.01).init(p),
             "step": jnp.zeros((), jnp.int32)}
    tok, tgt = bundle.shard_batch(tokens, targets)
    metrics = []
    for _ in range(steps):
        state, m = bundle.step_fn(state, tok, tgt)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, {k: np.asarray(v, np.float64) for k, v in state["params"].items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_steps_match_jax(ranks, case):
    sizes, context_parallel, w_up_shard, embed_shard = CASES[case]
    params = numpy_params(CFG, seed=11)
    rs = np.random.RandomState(12)
    tokens = rs.randint(0, CFG.vocab_size, size=(4, 16)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    want_metrics, want_params = _jax_steps(sizes, context_parallel, params, tokens, targets, 2)
    results = ranks.run(train_steps, sizes, port_cfg(CFG), params, tokens, targets, LR, 2,
                        context_parallel)
    for r in results:
        assert r["shapes"]["w_up"] == w_up_shard and r["shapes"]["embed"] == embed_shard
        np.testing.assert_allclose(r["metrics"], want_metrics, rtol=STEP_RTOL)
    got = results[0]["params"]
    assert sorted(got) == sorted(want_params)
    for k, v in got.items():
        start = params[k].astype(np.float64)
        assert rel_frobenius(v - start, want_params[k] - start) <= UPDATE_RTOL, k


# grouped-query heads (one kv head per tensor rank), tied embeddings (the
# unembedding is the vocab-sharded embedding's transpose), remat
GQA_TIED = JT.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=64,
    tie_embeddings=True, dtype=jnp.float32, remat=True,
)


@pytest.mark.parametrize("sizes", [dict(fsdp=2, tensor=2), dict(context=2, tensor=2)],
                         ids=["fsdp2_tensor2", "context2_tensor2"])
def test_sharded_forward_loss_and_grads_match_jax(ranks, sizes):
    params = numpy_params(GQA_TIED, seed=13)
    rs = np.random.RandomState(14)
    tokens = rs.randint(0, GQA_TIED.vocab_size, size=(2, 16)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    mask = (rs.rand(2, 16) > 0.3).astype(np.float32)
    want_logits = np.asarray(jax.jit(JT.forward, static_argnums=2)(params, tokens, GQA_TIED))
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, tokens, targets, GQA_TIED, loss_mask=mask)))(params)
    got = ranks.run(forward_and_grads, sizes, port_cfg(GQA_TIED), params, tokens, targets, mask)
    for r in got:
        b, s, v = r["starts"]
        block = r["logits"]
        want = want_logits[b:b + block.shape[0], s:s + block.shape[1], v:v + block.shape[2]]
        np.testing.assert_allclose(block, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(r["loss"], float(want_loss), rtol=LOSS_RTOL)
    grads = got[0]["grads"]
    assert sorted(grads) == sorted(want_grads)
    for k, g in grads.items():
        assert rel_frobenius(g, np.asarray(want_grads[k], np.float64)) <= GRAD_RTOL, k
