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
from ray_tpu_torch.kernels.paged_attention import (
    PARTITION,
    paged_attention,
    paged_attention_reference,
)


def _paged_case(seed, b, mb, bs, kv, h, d, contexts=None):
    """Shuffled block tables and an inactive last slot (null table,
    position 0); the other contexts are ``contexts`` or ragged at random,
    the first filling the table."""
    rs = np.random.RandomState(seed)
    num_blocks = 1 + b * mb
    kpool = rs.randn(num_blocks * bs, kv, d).astype(np.float32)
    vpool = rs.randn(num_blocks * bs, kv, d).astype(np.float32)
    tables = np.zeros((b, mb), np.int32)
    perm = rs.permutation(np.arange(1, num_blocks)).astype(np.int32)
    if contexts is None:
        positions = rs.randint(0, mb * bs, size=b).astype(np.int32)
        positions[0] = mb * bs - 1
    else:
        assert len(contexts) == b - 1
        positions = np.array([c - 1 for c in contexts] + [0], np.int32)
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
# ViT-L/16: 197 tokens (196 patches and the class token), 16 heads of 64,
# bidirectional
VIT_L16_SHAPE = (4, 197, 197, 16, 16, 64, False)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,d,causal",
    [(1, 1000, 1000, 8, 8, 128, True), (2, 257, 257, 4, 2, 64, False),
     (1, 130, 130, 4, 4, 256, True), VIT_L16_SHAPE] + EDGE_SHAPES,
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


def _to_card(cuda, q, kpool, vpool, tables, positions):
    tq, tk, tv = (torch.from_numpy(x).to(cuda).bfloat16() for x in (q, kpool, vpool))
    tt, tp = (torch.from_numpy(x).to(cuda) for x in (tables, positions))
    return tq, tk, tv, tt, tp


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_kernel_matches_plain_on_card(cuda, d, group, bs):
    """Contexts on the kernel's partition edges (one token, one partition
    less one, exactly one, one more, two, the whole table), query groups of
    1, 4 and 8 heads per KV head, and an inactive slot."""
    mb = 2 * PARTITION // bs + 3
    contexts = [1, PARTITION - 1, PARTITION, PARTITION + 1, 2 * PARTITION, mb * bs]
    case = _paged_case(seed=2, b=len(contexts) + 1, mb=mb, bs=bs, kv=2, h=2 * group, d=d,
                       contexts=contexts)
    tq, tk, tv, tt, tp = _to_card(cuda, *case)
    before = paged_attention.launches
    out = paged_attention(tq, tk, tv, tt, tp, bs)
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(tq, tk, tv, tt, tp, bs)
    torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,contexts,kv,h,d", [
    (544, [512, 544, 1, 300, 257, 543, 256], 32, 32, 128),  # Llama-2-7B's dense decode
    (544, [512, 1, 300], 2, 8, 64),
    (37, [37, 1, 20, 36], 2, 4, 256),
    (37, [30, 37, 2], 4, 4, 128),
])
def test_paged_kernel_over_a_dense_cache_on_card(cuda, bs, contexts, kv, h, d):
    """The dense cache's layout: one block of ``bs`` slots per sequence
    (``block_size`` = the cache's length, past the 256-token partition or
    odd), table ``arange(B)``, ragged contexts inside the block."""
    b = len(contexts)
    rs = np.random.RandomState(bs + d)
    kpool, vpool = (rs.randn(b * bs, kv, d).astype(np.float32) for _ in range(2))
    q = rs.randn(b, h, d).astype(np.float32)
    tables = np.arange(b, dtype=np.int32)[:, None]
    positions = np.array([c - 1 for c in contexts], np.int32)
    tq, tk, tv, tt, tp = _to_card(cuda, q, kpool, vpool, tables, positions)
    before = paged_attention.launches
    out = paged_attention(tq, tk, tv, tt, tp, bs)
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(tq, tk, tv, tt, tp, bs)
    torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kv,h,d", [(4, 4, 64), (2, 8, 128)])
def test_paged_kernel_rows_do_not_depend_on_neighbours(cuda, kv, h, d):
    """Batch invariance on the card: each sequence's output is bitwise the
    same alone as in the batch; contexts span up to 5 partitions."""
    bs = 16
    case = _paged_case(seed=3, b=4, mb=80, bs=bs, kv=kv, h=h, d=d)
    assert case[4][0] + 1 > 4 * PARTITION
    tq, tk, tv, tt, tp = _to_card(cuda, *case)
    full = paged_attention(tq, tk, tv, tt, tp, bs)
    for i in range(len(tq)):
        alone = paged_attention(tq[i:i + 1], tk, tv, tt[i:i + 1], tp[i:i + 1], bs)
        assert torch.equal(full[i], alone[0])


@pytest.mark.gpu
def test_paged_kernel_rejects_what_it_does_not_take(cuda):
    bs = 16
    tq, tk, tv, tt, tp = _to_card(cuda, *_paged_case(seed=4, b=2, mb=4, bs=bs, kv=2, h=4, d=64))
    for dtype in (torch.float16, torch.float32):  # the kernel takes bf16 only
        with pytest.raises(ValueError):
            paged_attention(tq.to(dtype), tk.to(dtype), tv.to(dtype), tt, tp, bs)
    x = torch.zeros((tk.shape[0], 2, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head_dim 96
        paged_attention(torch.zeros((2, 4, 96), device=cuda, dtype=torch.bfloat16), x, x, tt,
                        tp, bs)
    wide = torch.zeros((tk.shape[0], 2, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a pool slice that is not contiguous
        paged_attention(tq, wide[..., :64], tv, tt, tp, bs)
    with pytest.raises(ValueError):  # int64 block tables
        paged_attention(tq, tk, tv, tt.long(), tp, bs)


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
        VIT_L16_SHAPE,
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


# Whole-model logits through the kernels against the plain path, both bf16
# on the card (chip_smoke.py's decode rule): max and mean absolute
# differences on O(1) logits.
LOGIT_MAX, LOGIT_MEAN = 0.25, 0.03


@pytest.mark.gpu
def test_dense_generate_through_the_kernels_matches_plain_on_card(cuda):
    """generate over a dense cache: prefill launches the flash forward once
    per layer and each decode step the paged kernel once per layer; the
    prefill and first decode step's logits agree with the plain path."""
    from ray_tpu_torch.models import generation as G
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=1024, max_seq_len=256)
    params = init_params(torch.Generator(device=cuda).manual_seed(2), cfg, device=cuda)
    prompt = torch.from_numpy(np.random.RandomState(2).randint(0, 512, (3, 70))).to(cuda)
    before = (flash_attention.launches, paged_attention.launches)
    toks = G.generate(params, prompt, cfg, max_new_tokens=6)
    assert toks.shape == (3, 6) and toks.device.type == "cuda"
    assert flash_attention.launches - before[0] == cfg.n_layers
    assert paged_attention.launches - before[1] == cfg.n_layers * 5
    max_len = 70 + 2
    results = []
    for use_kernels in (True, False):
        prefill, decode = G.make_decode_fns(cfg, max_len, use_kernels=use_kernels)
        first, cache = prefill(params, prompt, G.init_kv_cache(cfg, 3, max_len, device=cuda))
        step, cache = decode(params, toks[:, :1], cache)
        results.append((first, step))
    for got, want in zip(*results):
        diff = (got - want).abs()
        assert diff.max().item() <= LOGIT_MAX and diff.mean().item() <= LOGIT_MEAN


@pytest.mark.gpu
def test_vit_forward_through_the_kernels_matches_plain_on_card(cuda):
    """A small ViT at head_dim 64 in bf16: one flash launch per layer (one
    backward launch per layer under autograd), and logits that stray from an
    fp32 run no further than 1.2x the plain path's do (chip_smoke.py's
    forward rule)."""
    import dataclasses

    from ray_tpu_torch.models import vit

    cfg = vit.ViTConfig(image_size=64, patch_size=8, num_classes=100, d_model=256, n_layers=2,
                        n_heads=4, d_ff=512)
    params = vit.init_params(torch.Generator(device=cuda).manual_seed(3), cfg, device=cuda)
    images = torch.randn((8, 64, 64, 3), generator=torch.Generator(device=cuda).manual_seed(4),
                         device=cuda)
    with torch.no_grad():
        before = flash_attention.launches
        flash = vit.forward(cfg, params, images)
        assert flash_attention.launches - before == cfg.n_layers
        plain = vit.forward(cfg, params, images, use_flash=False)
        exact = vit.forward(dataclasses.replace(cfg, dtype=torch.float32),
                            {k: v.float() for k, v in params.items()}, images)
    assert flash.shape == (8, 100) and torch.isfinite(flash).all()
    assert (flash - exact).abs().mean() <= 1.2 * (plain - exact).abs().mean()
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    before = flash_attention_backward.launches
    loss, _ = vit.loss_fn(cfg, leaves, images, torch.arange(8, device=cuda))
    loss.backward()
    assert flash_attention_backward.launches - before == cfg.n_layers
    assert all(torch.isfinite(v.grad).all() for v in leaves.values())


# the RL learners launch no kernel of the port: their updates on the card
# against the same update on the CPU, from the same parameters and batch,
# fp32 (TF32 off, torch's default): losses, metrics and parameters to 1e-5


def _rl_pair(cfg, cuda):
    cpu_algo = cfg.build(device="cpu")
    card_algo = cfg.build(device=cuda)
    card_algo.set_state(cpu_algo.get_state())
    return cpu_algo, card_algo


def _assert_rl_update_alike(cpu_algo, card_algo, cpu_metrics, card_metrics):
    from ray_tpu_torch.rl.models import tree_leaves

    assert sorted(cpu_metrics) == sorted(card_metrics)
    for k in cpu_metrics:
        torch.testing.assert_close(card_metrics[k].cpu(), cpu_metrics[k], atol=1e-5, rtol=1e-5)
    for a, b in zip(tree_leaves(card_algo.params), tree_leaves(cpu_algo.params)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_ppo_update_on_card_matches_cpu(cuda):
    from ray_tpu_torch.rl import PPOConfig

    cpu_algo, card_algo = _rl_pair(PPOConfig(), cuda)
    rng = np.random.default_rng(0)
    batch = {"obs": rng.normal(size=(512, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, 512).astype(np.int32),
             "logp_old": np.full(512, np.log(0.5), np.float32),
             "advantages": rng.normal(size=512).astype(np.float32),
             "returns": rng.normal(scale=5.0, size=512).astype(np.float32)}
    outs = [a._update(a.params, a.opt_state, a._to_device(batch))[2]
            for a in (cpu_algo, card_algo)]
    _assert_rl_update_alike(cpu_algo, card_algo, *outs)


@pytest.mark.gpu
def test_impala_update_on_card_matches_cpu(cuda):
    from ray_tpu_torch.rl import IMPALAConfig

    cpu_algo, card_algo = _rl_pair(IMPALAConfig(), cuda)
    rng = np.random.default_rng(1)
    T, N = 128, 16
    batch = {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
             "logp": np.full((T, N), np.log(0.5), np.float32),
             "rewards": np.ones((T, N), np.float32),
             "dones": (rng.random((T, N)) < 0.05).astype(np.float32),
             "last_values": rng.normal(size=N).astype(np.float32),
             "mask": np.r_[np.ones(N - 1), 0.0].astype(np.float32)}
    outs = [a._update(a.params, a.opt_state, a._to_device(batch))[2]
            for a in (cpu_algo, card_algo)]
    _assert_rl_update_alike(cpu_algo, card_algo, *outs)
