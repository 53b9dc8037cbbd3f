"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked ``gpu`` and skips where there is no card: the
kernels have no CPU mode. This file imports only torch, so it runs on the
card's machine as it is:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
)
from ray_tpu_torch.kernels.paged_attention import paged_attention, paged_attention_reference


def _paged_case(seed, b, mb, bs, kv, h, d):
    """Shuffled block tables, ragged positions, and an inactive last slot
    (null table, position 0)."""
    rs = np.random.RandomState(seed)
    num_blocks = 1 + b * mb
    kpool = rs.randn(num_blocks * bs, kv, d).astype(np.float32)
    vpool = rs.randn(num_blocks * bs, kv, d).astype(np.float32)
    tables = np.zeros((b, mb), np.int32)
    perm = rs.permutation(np.arange(1, num_blocks)).astype(np.int32)
    positions = rs.randint(0, mb * bs, size=b).astype(np.int32)
    positions[0] = mb * bs - 1
    positions[-1] = 0
    for i in range(b - 1):
        n = positions[i] // bs + 1
        tables[i, :n] = perm[i * mb: i * mb + n]
    q = rs.randn(b, h, d).astype(np.float32)
    return q, kpool, vpool, tables, positions


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# both sides round the bf16 output; the plain version also rounds its
# probabilities to bf16: about one bf16 step of the output
KERNEL_TOL = dict(atol=1e-2, rtol=1e-2)


# Shapes on the kernels' tile edges (64-row warpgroups, 128-query CTAs,
# 32/64/128-key tiles, 64-column TMA boxes), each head_dim, causal and not,
# with grouped-query pairs; then Sq != Sk and query groups of 4 and 8.
# (b, sq, sk, h, kv, d, causal).
EDGE_SHAPES = [
    (1, s, s, 4, 2, d, causal)
    for s in (1, 63, 65, 127, 129, 2049)
    for d in (64, 128, 256)
    for causal in (True, False)
] + [
    (1, 100, 300, 4, 4, 128, False),
    (1, 100, 300, 4, 2, 128, True),  # causal: keys past the last query get no gradient
    (2, 300, 100, 4, 2, 64, False),
    (1, 65, 2049, 2, 2, 256, False),
    (1, 129, 129, 8, 2, 128, True),  # group of 4
    (2, 257, 257, 8, 2, 64, False),
    (1, 129, 129, 8, 1, 256, True),  # group of 8
    (1, 300, 300, 16, 2, 128, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,d,causal",
    [(1, 1000, 1000, 8, 8, 128, True), (2, 257, 257, 4, 2, 64, False),
     (1, 130, 130, 4, 4, 256, True)] + EDGE_SHAPES,
)
def test_flash_kernel_matches_plain_on_card(cuda, b, sq, sk, h, kv, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, h, d), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, kv, d), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, sk, kv, d), generator=gen, device=cuda).bfloat16()
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        flash_attention(q[..., :64].float(), q[..., :64].float(), q[..., :64].float())


@pytest.mark.gpu
def test_paged_kernel_matches_plain_on_card(cuda):
    bs = 16
    q, kpool, vpool, tables, positions = _paged_case(seed=2, b=5, mb=64, bs=bs, kv=2, h=8, d=128)
    tq, tk, tv = (torch.from_numpy(x).to(cuda).bfloat16() for x in (q, kpool, vpool))
    tt, tp = (torch.from_numpy(x).to(cuda) for x in (tables, positions))
    before = paged_attention.launches
    out = paged_attention(tq, tk, tv, tt, tp, bs)
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(tq, tk, tv, tt, tp, bs)
    torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)


@pytest.mark.gpu
def test_paged_kernel_rows_do_not_depend_on_neighbours(cuda):
    """Batch invariance on the card: each sequence's output is bitwise the
    same alone as in the batch."""
    bs = 16
    q, kpool, vpool, tables, positions = _paged_case(seed=3, b=4, mb=80, bs=bs, kv=4, h=4, d=64)
    tq, tk, tv = (torch.from_numpy(x).to(cuda).bfloat16() for x in (q, kpool, vpool))
    tt, tp = (torch.from_numpy(x).to(cuda) for x in (tables, positions))
    full = paged_attention(tq, tk, tv, tt, tp, bs)
    for i in range(len(q)):
        alone = paged_attention(tq[i:i + 1], tk, tv, tt[i:i + 1], tp[i:i + 1], bs)
        assert torch.equal(full[i], alone[0])


@pytest.mark.gpu
def test_engine_continuous_matches_isolated_on_card(cuda):
    """Continuous batching through both kernels is tokenwise identical to
    decoding each request alone."""
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.serve.llm.engine import EngineConfig, InferenceEngine

    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2, d_ff=512,
                            max_seq_len=512)
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    ecfg = EngineConfig(block_size=16, num_blocks=128, max_batch=4, max_blocks_per_seq=16)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(1, 512, size=n).tolist() for n in (5, 70, 33, 150, 9, 100)]
    eng = InferenceEngine(params, cfg, ecfg, device=cuda)
    try:
        before = (flash_attention.launches, paged_attention.launches)
        alone = [eng.submit(p, max_new_tokens=12).tokens() for p in prompts]
        streams = [eng.submit(p, max_new_tokens=12) for p in prompts]
        together = [s.tokens() for s in streams]
        assert flash_attention.launches > before[0] and paged_attention.launches > before[1]
    finally:
        eng.shutdown()
    assert together == alone


# The backward kernel rounds P and dS to bf16 before its products; the
# plain backward keeps them in fp32. Per gradient, in relative Frobenius
# norm: the kernel may stray from an fp32 run no further than BWD_NOISE
# times the plain backward does (FlashAttention-2's convention), and from
# the plain backward no further than BWD_CAP (the roundings give ~0.003;
# a wrong index or mask gives O(1)). chip_smoke.py holds the same rule.
BWD_NOISE, BWD_CAP = 2.0, 1e-2


def _rel(x, ref):
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def _bwd_case(cuda, b, s, h, kv, d, causal, seed=0, sk=None):
    sk = s if sk is None else sk
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, kv, d), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, sk, kv, d), generator=gen, device=cuda).bfloat16()
    d_out = torch.randn((b, s, h, d), generator=gen, device=cuda).bfloat16()
    out, lse = flash_attention(q, k, v, causal=causal)
    return q, k, v, out, lse, d_out


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,d,causal",
    [
        (1, 2048, 2048, 16, 16, 256, True),  # GPT-J
        (1, 2048, 2048, 32, 32, 128, True),  # Llama-2-7B
        (1, 1000, 1000, 32, 8, 128, True),  # grouped-query, ragged
        (2, 300, 300, 4, 4, 64, True),
        (1, 2048, 2048, 32, 32, 128, False),
        (2, 130, 130, 4, 2, 256, False),
    ] + EDGE_SHAPES,
)
def test_flash_backward_kernel_matches_plain_on_card(cuda, b, sq, sk, h, kv, d, causal):
    args = _bwd_case(cuda, b, sq, h, kv, d, causal, sk=sk)
    before = flash_attention_backward.launches
    grads = flash_attention_backward(*args, causal=causal)
    assert flash_attention_backward.launches == before + 1
    plain = flash_attention_backward_reference(*args, causal=causal)
    q, k, v, _, _, d_out = args
    f32 = [x.float() for x in (q, k, v)]
    out32, lse32 = flash_attention_reference(*f32, causal=causal)
    exact = flash_attention_backward_reference(*f32, out32, lse32, d_out.float(), causal=causal)
    for name, g, p, e in zip(("dq", "dk", "dv"), grads, plain, exact):
        assert g.shape == p.shape and g.dtype == torch.bfloat16, name
        assert torch.isfinite(g).all(), name
        if sk == 1 and name != "dv":
            # one key: P = 1 and dS = P * (dP - D) = 0 exactly, so dQ and dK
            # are 0 and every implementation returns only the rounding of
            # dP - D (the plain and fp32 paths the same rounding, hence no
            # ratio to hold): held to the kernel tolerance's atol instead
            assert g.float().abs().max().item() <= KERNEL_TOL["atol"], name
            continue
        assert _rel(g, e) <= BWD_NOISE * _rel(p, e), name
        assert _rel(g, p) <= BWD_CAP, name


@pytest.mark.gpu
def test_flash_backward_kernel_is_deterministic(cuda):
    args = _bwd_case(cuda, 1, 1000, 32, 8, 128, True, seed=1)
    first = flash_attention_backward(*args)
    second = flash_attention_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_flash_backward_rejects_what_it_does_not_take(cuda):
    q, k, v, out, lse, d_out = _bwd_case(cuda, 1, 64, 2, 2, 64, True)
    with pytest.raises(ValueError):  # fp32
        flash_attention_backward(q.float(), k.float(), v.float(), out.float(), lse, d_out.float())
    x = torch.zeros((1, 8, 2, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head_dim 96
        flash_attention_backward(x, x, x, x, torch.zeros((1, 2, 8), device=cuda), x)
    with pytest.raises(ValueError):  # d_out on the CPU
        flash_attention_backward(q, k, v, out, lse, d_out.cpu())


@pytest.mark.gpu
def test_train_step_flash_matches_plain_on_card(cuda, monkeypatch):
    """One step_fn step of a small bf16 config through the kernels, against
    the same step with attention on the plain path and an fp32 step: the
    flash gradients stray from fp32 no further than 1.5x the plain ones
    (chip_smoke.py's TRAIN_NOISE), over all parameters together."""
    import dataclasses

    import ray_tpu_torch.ops.attention as attention_mod
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.parallel.spmd import build_lm_train_step, flat_leaves

    cfg = TransformerConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4, d_ff=1024,
                            max_seq_len=512, parallel_block=True, use_swiglu=False)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 512))).to(cuda)
    targets = torch.roll(tokens, -1, 1)

    def step_grads(dtype, flash):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = init_params(torch.Generator(device=cuda).manual_seed(0), c, device=cuda)
        bundle = build_lm_train_step(c, device=cuda)
        state = bundle.state_from_params(params)
        with monkeypatch.context() as m:
            if not flash:
                m.setattr(attention_mod, "flash_eligible", lambda *a: False)
            before = flash_attention_backward.launches
            state, metrics = bundle.step_fn(state, tokens, targets)
            launched = flash_attention_backward.launches - before
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
        grads = torch.cat([p.grad.float().flatten() for p in flat_leaves(state["opt"].leaves)])
        return grads, launched

    g_flash, launched = step_grads(torch.bfloat16, True)
    assert launched == cfg.n_layers
    g_plain, launched = step_grads(torch.bfloat16, False)
    assert launched == 0
    g_32, _ = step_grads(torch.float32, True)
    assert _rel(g_flash, g_32) <= 1.5 * _rel(g_plain, g_32)


@pytest.mark.gpu
def test_remat_modes_through_the_kernels_give_identical_gradients(cuda):
    """remat False, True and "dots" (selective checkpointing around the
    flash autograd function) give the same gradients on the card: the
    recomputed forward repeats the same kernels on the same inputs."""
    import dataclasses

    from ray_tpu_torch.models.transformer import TransformerConfig, init_params, loss_fn

    cfg = TransformerConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4, d_ff=1024,
                            max_seq_len=256, parallel_block=True, use_swiglu=False)
    params = init_params(torch.Generator(device=cuda).manual_seed(1), cfg, device=cuda)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 512, (2, 256))).to(cuda)
    results = []
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        before = flash_attention.launches
        loss = loss_fn(leaves, tokens, torch.roll(tokens, -1, 1),
                       dataclasses.replace(cfg, remat=remat, remat_policy=policy))
        loss.backward()
        # the forward runs again in the backward pass whenever a block is checkpointed
        assert flash_attention.launches - before == cfg.n_layers * (2 if remat else 1)
        results.append({k: v.grad for k, v in leaves.items() if v.grad is not None})
    for grads in results[1:]:
        for k in results[0]:
            assert torch.equal(grads[k], results[0][k]), k


@pytest.mark.gpu
def test_entry_runs_on_card(cuda):
    from ray_tpu_torch.entry import entry

    fn, (params, tokens) = entry()
    assert tokens.device.type == "cuda"
    with torch.inference_mode():
        logits = fn(params, tokens)
    assert logits.shape == (2, 256, 50432) and torch.isfinite(logits.float()).all()
