"""Ring attention, GPipe and expert-parallel MoE of the port on four gloo
ranks against the JAX package on a mesh of the same shape (four of the
virtual CPU devices), the ranks' places on the mesh against JAX's device
grid, ``dryrun_multichip`` on four gloo ranks, and the rank pool's
handling of a failing or hanging job. Inputs
are made with numpy from a seed; the ranks import torch and never jax
(``test_torch_rank_jobs``). All fp32.

Tolerances: ring attention's output to 2e-5 absolute (the reference's own
ring test against dense attention) and its gradients to 1e-4 absolute
(entries of order 1, summed over four hops); GPipe to 1e-5 (the
reference's test); MoE output to 1e-5 and aux loss to 1e-5 (the
reference's expert-parallel test).
"""

import functools
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from ray_tpu.models import moe as jmoe  # noqa: E402
from ray_tpu.ops.attention import make_context_parallel_attention  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from ray_tpu.parallel.pipeline import make_pipeline_fn  # noqa: E402
from ray_tpu.parallel.sharding import DEFAULT_LM_RULES, infer_param_sharding  # noqa: E402
from ray_tpu_torch.entry import dryrun_multichip  # noqa: E402
from ray_tpu_torch.models.moe import MoEConfig  # noqa: E402
from test_torch_rank_jobs import WORLD, gpipe, moe, ranks, ring  # noqa: E402,F401

RING_ATOL, RING_GRAD_ATOL = 2e-5, 1e-4


def _mesh(**sizes):
    return create_mesh(MeshConfig(**sizes), devices=jax.devices()[:WORLD])


@pytest.mark.parametrize("causal,kv_heads", [(True, 4), (False, 4), (True, 2)],
                         ids=["causal", "full", "gqa_causal"])
def test_ring_attention_matches_jax(ranks, causal, kv_heads):
    b, s, h, d = 2, 32, 4, 16
    rs = np.random.RandomState(3)
    q = rs.randn(b, s, h, d).astype(np.float32)
    k, v = (rs.randn(b, s, kv_heads, d).astype(np.float32) for _ in range(2))
    d_out = rs.randn(b, s, h, d).astype(np.float32)
    mesh = _mesh(context=WORLD)
    spec = NamedSharding(mesh, P(None, "context", None, None))
    attend = make_context_parallel_attention(mesh, causal=causal)

    def objective(q, k, v):
        return jnp.sum(attend(q, k, v) * d_out)

    args = [jax.device_put(x, spec) for x in (q, k, v)]
    want_out = np.asarray(jax.jit(attend)(*args))
    want_grads = [np.asarray(g) for g in jax.jit(jax.grad(objective, argnums=(0, 1, 2)))(*args)]
    got = ranks.run(ring, q, k, v, d_out, causal)
    out, dq, dk, dv = (np.concatenate([r[i] for r in got], axis=1) for i in range(4))
    np.testing.assert_allclose(out, want_out, atol=RING_ATOL)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want_grads):
        np.testing.assert_allclose(g, w, atol=RING_GRAD_ATOL, err_msg=name)


def test_gpipe_matches_jax_and_sequential(ranks):
    stages, m, mb, d = WORLD, 6, 4, 16
    rs = np.random.RandomState(5)
    w = (rs.randn(stages, d, d) * 0.5).astype(np.float32)
    b = (rs.randn(stages, d) * 0.1).astype(np.float32)
    micro = rs.randn(m, mb, d).astype(np.float32)
    ref = micro
    for i in range(stages):
        ref = np.tanh(ref @ w[i] + b[i])
    mesh = _mesh(pipeline=WORLD)

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    want = np.asarray(jax.jit(make_pipeline_fn(stage_fn, mesh))(
        jax.device_put({"w": w, "b": b}, NamedSharding(mesh, P("pipeline"))), micro))
    np.testing.assert_allclose(want, ref, atol=1e-5)
    for out in ranks.run(gpipe, w, b, micro):
        np.testing.assert_allclose(out, want, atol=1e-5)
        np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5], ids=["roomy", "drops"])
def test_moe_expert_parallel_matches_jax(ranks, capacity_factor):
    jcfg = jmoe.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                          capacity_factor=capacity_factor)
    rs = np.random.RandomState(7)
    params = {
        "router": (rs.randn(32, 8) / np.sqrt(32)).astype(np.float32),
        "w_in": (rs.randn(8, 32, 64) / np.sqrt(32)).astype(np.float32),
        "w_out": (rs.randn(8, 64, 32) / np.sqrt(64)).astype(np.float32),
    }
    x = rs.randn(4, 8, 32).astype(np.float32)
    mesh = _mesh(expert=WORLD)
    shardings = infer_param_sharding(jmoe.moe_param_logical_axes(), DEFAULT_LM_RULES, mesh)
    sharded = jax.tree.map(lambda p, s: jax.device_put(p, s), params, shardings)
    want_y, want_aux = jax.jit(functools.partial(jmoe.moe_mlp, cfg=jcfg))(sharded, x)
    cfg = MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2, capacity_factor=capacity_factor)
    got = ranks.run(moe, cfg, params, x)
    assert [r[2] for r in got] == [2] * WORLD  # two experts per rank
    np.testing.assert_allclose(np.concatenate([r[0] for r in got]), np.asarray(want_y), atol=1e-5)
    for r in got:
        assert abs(r[1] - float(want_aux)) < 1e-5


def test_dryrun_multichip_on_gloo_ranks():
    """The reference's factoring of 4: pipeline=2, tensor=2; one sharded
    step of the tiny flagship and the GPipe segment, verified."""
    summary = dryrun_multichip(WORLD, device="cpu")
    assert summary["mesh"] == {"pipeline": 2, "data": 1, "fsdp": 1, "expert": 1,
                               "context": 1, "tensor": 2}
    assert summary["processes"] == WORLD and summary["step"] == 1
    assert summary["gpipe"] == "verified" and np.isfinite(summary["loss"])


@pytest.mark.parametrize("causal,kv_heads", [(True, 4), (False, 2)], ids=["causal", "gqa_full"])
def test_ring_schedule_matches_whole_sequence(causal, kv_heads):
    """The single-process schedule (the card's ``ring_schedule`` phase) on
    the CPU, fp32: out, lse and gradients against the plain versions over
    the whole sequence, to fp32 rounding (1e-5)."""
    from ray_tpu_torch.kernels.flash_attention import (
        flash_attention_backward_reference,
        flash_attention_reference,
    )
    from ray_tpu_torch.ops.attention import ring_schedule_backward, ring_schedule_forward

    rs = np.random.RandomState(9)
    q, d_out = (torch.from_numpy(rs.randn(2, 64, 4, 16).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rs.randn(2, 64, kv_heads, 16).astype(np.float32)) for _ in range(2))
    qs, ks, vs, dos = ([c.contiguous() for c in x.chunk(4, dim=1)] for x in (q, k, v, d_out))
    fwd = ring_schedule_forward(qs, ks, vs, causal=causal)
    outs, lses = [o for o, _ in fwd], [lse for _, lse in fwd]
    grads = ring_schedule_backward(qs, ks, vs, outs, lses, dos, causal=causal)
    out, lse = flash_attention_reference(q, k, v, causal=causal)
    want = flash_attention_backward_reference(q, k, v, out, lse, d_out, causal=causal)
    np.testing.assert_allclose(torch.cat(outs, 1), out, atol=1e-5)
    np.testing.assert_allclose(torch.cat(lses, 2), lse, atol=1e-5)
    for i in range(3):
        np.testing.assert_allclose(torch.cat([g[i] for g in grads], 1), want[i], atol=1e-5)


@pytest.mark.parametrize("sizes", [dict(fsdp=2, tensor=2), dict(pipeline=2, context=2)],
                         ids=["fsdp2_tensor2", "pipeline2_context2"])
def test_mesh_layout_matches_jax(ranks, sizes):
    """Rank r sits where JAX's mesh of the same shape puts device r, with
    the same axes kept by ``drop_trivial_axes``; a mesh of the wrong size
    raises the reference's error."""
    from test_torch_rank_jobs import mesh_layout, wrong_size_mesh

    jm = create_mesh(MeshConfig(**sizes), devices=jax.devices()[:WORLD], drop_trivial_axes=True)
    got = ranks.run(mesh_layout, sizes, True)
    for rank, (names, shape, coords) in enumerate(got):
        assert names == jm.axis_names and shape == dict(jm.shape)
        where = np.argwhere(np.vectorize(lambda dev: dev.id)(jm.devices) == rank)[0]
        assert tuple(coords[a] for a in names) == tuple(where)
    assert ranks.run(mesh_layout, sizes, False)[0][0] == (
        "pipeline", "data", "fsdp", "expert", "context", "tensor")
    assert ranks.run(wrong_size_mesh)[0] == "mesh axes product 6 != device count 4"


def test_context_axis_needs_context_parallel(ranks):
    """A context axis shards the sequence, and the port's only attention
    over sequence shards is the ring: ``context_parallel=False`` there
    raises instead of being ignored."""
    from test_torch_rank_jobs import context_without_ring

    for msg in ranks.run(context_without_ring):
        assert msg is not None and "pass context_parallel=True" in msg


def test_rank_pool_defaults_to_the_card(monkeypatch):
    """``RankPool`` starts NCCL ranks on the card unless asked for the CPU,
    and raises where there is no card, as every entry point of the port
    does."""
    from ray_tpu_torch.parallel.launch import RankPool

    assert RankPool(2, device="cpu").device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RankPool(2)


def test_rank_pool_fails_fast_and_restarts(tmp_path):
    """A rank that raises while the others wait in a collective, and a job
    past its deadline, each fail their call at once and kill the ranks;
    the next call starts fresh ones."""
    from ray_tpu_torch.parallel.launch import RankFailure, RankPool
    from test_torch_rank_jobs import fail_on, sleep_for

    with RankPool(2, device="cpu", store_dir=str(tmp_path), timeout_s=30.0) as pool:
        with pytest.raises(RankFailure, match="rank 1 raised"):
            pool.run(fail_on, 1)
        assert pool.run(sleep_for, 0) == [None, None]
        t0 = time.monotonic()
        with pytest.raises(RankFailure, match="did not answer in time"):
            pool.run(sleep_for, 60, timeout_s=1.0)
        assert time.monotonic() - t0 < 20
        assert pool.run(sleep_for, 0) == [None, None]
