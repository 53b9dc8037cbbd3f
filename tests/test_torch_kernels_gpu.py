"""The port's CUDA kernels against their plain versions, on a CUDA card, and
the paths that exist only there (the data library's CUDA feed,
``compile_torch_pipeline``'s CUDA graphs).

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


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv,d", [(8, 8, 128), (8, 2, 64), (4, 4, 256)])
def test_ring_schedule_matches_whole_sequence_kernels_on_card(cuda, causal, h, kv, d):
    """Ring attention's per-hop schedule over 4 shards of 256 tokens through
    the flash kernels against the same kernels over all 1024 tokens: out
    and lse, and the gradients (kernel 1b per hop, from the merged out and
    lse, summed in fp32)."""
    from ray_tpu_torch.ops.attention import ring_schedule_backward, ring_schedule_forward

    gen = torch.Generator(device=cuda).manual_seed(4)
    q, d_out = (torch.randn((1, 1024, h, d), generator=gen, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn((1, 1024, kv, d), generator=gen, device=cuda).bfloat16() for _ in range(2))
    qs, ks, vs, dos = ([c.contiguous() for c in x.chunk(4, dim=1)] for x in (q, k, v, d_out))
    before = (flash_attention.launches, flash_attention_backward.launches)
    fwd = ring_schedule_forward(qs, ks, vs, causal=causal)
    outs, lses = [o for o, _ in fwd], [lse for _, lse in fwd]
    grads = ring_schedule_backward(qs, ks, vs, outs, lses, dos, causal=causal)
    hops = 10 if causal else 16  # no launch for a block in the future
    assert (flash_attention.launches - before[0], flash_attention_backward.launches - before[1]) == (hops, hops)
    out, lse = flash_attention(q, k, v, causal=causal)
    want = flash_attention_backward(q, k, v, out, lse, d_out, causal=causal)
    torch.testing.assert_close(torch.cat(outs, 1).float(), out.float(), **KERNEL_TOL)
    torch.testing.assert_close(torch.cat(lses, 2), lse, atol=1e-3, rtol=0)
    for i, name in enumerate(("dq", "dk", "dv")):
        got = torch.cat([g[i] for g in grads], 1).float()
        torch.testing.assert_close(got, want[i].float(), **KERNEL_TOL, msg=name)
        assert ((got - want[i].float()).norm() / want[i].float().norm()).item() <= 1e-2, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 96), (torch.float32, 128)])
def test_ring_attention_raises_where_the_kernels_do_not_take_the_tensors(cuda, dtype, d):
    """Ring attention on CUDA tensors the flash kernels do not take (a
    head_dim outside HEAD_DIMS, fp32) raises; it never runs its hops
    through the plain versions on the card."""
    from ray_tpu_torch.ops.attention import ring_attention

    q, k, v = (torch.randn((1, 256, 4, d), device=cuda).to(dtype) for _ in range(3))
    before = (flash_attention.launches, flash_attention_backward.launches)
    with pytest.raises(ValueError, match="flash_attention kernel takes"):
        ring_attention(q, k, v, group=None)
    assert (flash_attention.launches, flash_attention_backward.launches) == before


# -- the data library's CUDA feed and compile_torch_pipeline's graphs ----------


@pytest.fixture(scope="module")
def port_runtime():
    """The port's runtime (two CPUs) for the data library's tasks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the feed copies to it")
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2, _system_config={"prestart_workers": False})
    yield
    ray_tpu_torch.shutdown()


def _image_rows(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)


@pytest.mark.gpu
def test_torch_batches_copy_beside_a_busy_consumer_stream(port_runtime, cuda):
    """``iter_torch_batches`` on the card (its default device): each batch
    is copied on the iterator's own stream, so a batch pulled while the
    consumer's stream is busy (a ~200 ms spin queued before the pull) is on
    the card before the spin ends; the consumer reads the batches in order,
    equal to the dataset's rows."""
    from ray_tpu_torch import data
    from ray_tpu_torch.data import DataIterator

    rows = _image_rows(256)
    it = DataIterator(data.from_numpy(rows, column="image", num_blocks=4))
    batches = it.iter_torch_batches(batch_size=64)
    got, overlapped = [next(batches)["image"]], []
    for _ in range(3):
        spun = torch.cuda.Event()
        torch.cuda._sleep(400_000_000)  # on the consumer's (current) stream
        spun.record()
        batch = next(batches)  # its copy is enqueued after the spin
        it.copy_stats()  # waits for the copy stream's events only
        overlapped.append(not spun.query())
        assert batch["image"].device.type == "cuda"
        got.append(batch["image"])
    with pytest.raises(StopIteration):
        next(batches)
    assert overlapped == [True] * 3
    assert torch.equal(torch.cat(got).cpu(), torch.from_numpy(rows))
    stats = it.copy_stats()
    assert stats["batches"] == 4 and stats["bytes"] == rows.nbytes and stats["copy_ms"] > 0


@pytest.mark.gpu
def test_torch_batches_survive_a_slow_consumer(port_runtime, cuda):
    """Sixteen distinct batches, each read on the consumer's stream only
    after a spin and dropped by Python before that read has run: the pinned
    staging buffers and the batches' device memory must not be handed out
    again before the copy or the read that uses them has completed
    (``record_stream``), or a later batch would overwrite an earlier one."""
    from ray_tpu_torch import data

    rows = _image_rows(16 * 32, seed=1)
    ds = data.from_numpy(rows, column="image", num_blocks=16)
    sums = []
    for batch in ds.iter_torch_batches(batch_size=32, dtypes={"image": torch.int64}):
        torch.cuda._sleep(50_000_000)
        sums.append(batch["image"].sum(dim=(1, 2, 3)))
    want = rows.reshape(16 * 32, -1).astype(np.int64).sum(1)
    np.testing.assert_array_equal(torch.cat(sums).cpu().numpy(), want)


def _bf16_lm():
    from ray_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4, d_ff=512,
                             max_seq_len=256, dtype=torch.bfloat16)


@pytest.mark.gpu
def test_compiled_pipeline_replays_the_forward_on_card(cuda):
    """``compile_torch_pipeline(forward_stages(...))`` on a 2-layer bf16
    model at head_dim 64: one graph per signature, captured with one flash
    launch per layer; replays tick no counter and equal eager ``forward``
    bit for bit, for a second input of the same shape too."""
    from ray_tpu_torch.dag import compile_torch_pipeline
    from ray_tpu_torch.models.transformer import forward, forward_stages, init_params

    cfg = _bf16_lm()
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    fused = compile_torch_pipeline(forward_stages(params, cfg))
    gen = torch.Generator(device=cuda).manual_seed(1)
    with torch.inference_mode():
        for s in (128, 64):
            toks = [torch.randint(0, cfg.vocab_size, (2, s), generator=gen, device=cuda)
                    for _ in range(2)]
            before = flash_attention.launches
            first = fused(toks[0])
            # one eager warm-up pass and the capture
            assert flash_attention.launches - before == 2 * cfg.n_layers
            before = flash_attention.launches
            again = [fused(t) for t in toks]
            assert flash_attention.launches == before
            for got, t in zip([first] + again, toks[:1] + toks):
                assert torch.equal(got, forward(params, t, cfg))
    assert len(fused.capture_s) == 2 and fused.replays == 6


@pytest.mark.gpu
def test_compiled_pipeline_names_the_stage_it_cannot_capture(cuda):
    """A stage that synchronises with the host (``.item()``) cannot be
    captured: the pipeline raises with its index and does not run eagerly;
    the card stays usable."""
    from ray_tpu_torch.dag import PipelineCaptureError, compile_torch_pipeline

    x = torch.arange(8.0, device=cuda)
    fused = compile_torch_pipeline([lambda t: t * 2, lambda t: t + t.sum().item(), torch.sum])
    with pytest.raises(PipelineCaptureError) as err:
        fused(x)
    assert err.value.stage == 1 and fused.replays == 0
    ok = compile_torch_pipeline([lambda t: t * 2, torch.sum])
    assert ok(x).item() == 56.0 and ok.replays == 1


# -- the mesh path across four cards (NCCL), where a machine has them --------

# bf16 model parallelism against one card: each rank rounds its partial
# sums (tensor), hop outputs (context) or gathered shards' gradients to
# bf16 before the collective adds them, where one card adds in fp32 and
# rounds once. On four H100s the ranks' losses came within 9.8e-5 and their
# grad norms within 5.1e-5 of one card's (both cases, 3 steps); the limits,
# per step and relative to the single-card value, are about 10x those
FOUR_CARD_LOSS_RTOL, FOUR_CARD_NORM_RTOL = 1e-3, 5e-4
FOUR_CARD_CASES = {
    # mesh, global batch, sequence, layers
    "fsdp2_tensor2": (dict(fsdp=2, tensor=2), 2, 2048, 2),
    "context4": (dict(context=4), 1, 8192, 2),
}


def _gptj_steps(bundle, batch, seq, steps):
    """``steps`` AdamW steps from seed 0 on a seeded global batch: losses,
    grad norms, step ms and flash launches (forward, backward) per step."""
    import time

    state = bundle.init_state(0)
    tokens = np.random.default_rng(0).integers(0, bundle.config.vocab_size - 1, (batch, seq),
                                               dtype=np.int32)
    tok, tgt = bundle.shard_batch(tokens, np.roll(tokens, -1, axis=1))
    out = {"losses": [], "grad_norms": [], "step_ms": [], "launches": []}
    for _ in range(steps):
        flash_attention.launches = flash_attention_backward.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = bundle.step_fn(state, tok, tgt)
        out["losses"].append(metrics["loss"].item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["grad_norms"].append(metrics["grad_norm"].item())
        out["launches"].append((flash_attention.launches, flash_attention_backward.launches))
    return out


def _gptj_config(seq, layers):
    import dataclasses

    from ray_tpu_torch.models.transformer import GPTJ_6B

    return dataclasses.replace(GPTJ_6B, n_layers=layers, max_seq_len=max(seq, GPTJ_6B.max_seq_len))


def _sharded_gptj_rank(sizes, batch, seq, layers, steps):
    """A rank of ``RankPool(4, device="cuda")``: the mesh path."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    mesh = create_mesh(MeshConfig(**sizes))
    bundle = build_lm_train_step(_gptj_config(seq, layers), mesh, learning_rate=1e-4,
                                 context_parallel=True)
    out = _gptj_steps(bundle, batch, seq, steps)
    out["context_index"] = mesh.axis_index("context")
    return out


@pytest.fixture
def four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (one NCCL rank each)")
    return cuda


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FOUR_CARD_CASES))
def test_sharded_gptj_steps_on_four_cards_match_one(four_cards, case):
    """GPT-J's width at 2 layers: 3 steps over a four-rank NCCL mesh
    against the single-card step from the same seed and batch. Context=4
    runs the ring through the flash kernels, K/V moving between cards by
    NCCL send and receive: rank r launches its r + 1 visible hops."""
    from ray_tpu_torch.parallel.launch import RankPool
    from ray_tpu_torch.parallel.spmd import build_lm_train_step

    sizes, batch, seq, layers = FOUR_CARD_CASES[case]
    steps = 3
    single = _gptj_steps(build_lm_train_step(_gptj_config(seq, layers), device=four_cards,
                                             learning_rate=1e-4), batch, seq, steps)
    torch.cuda.empty_cache()
    with RankPool(4, device="cuda", timeout_s=300.0) as pool:
        ranks = pool.run(_sharded_gptj_rank, sizes, batch, seq, layers, steps)
    print(f"\n{case}: single card {single}\n{case}: ranks {ranks}")
    for r in ranks:
        hops = r["context_index"] + 1
        assert r["launches"] == [(2 * layers * hops, layers * hops)] * steps
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=FOUR_CARD_LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"], single["grad_norms"], rtol=FOUR_CARD_NORM_RTOL)
        assert r["losses"] == ranks[0]["losses"] and r["grad_norms"] == ranks[0]["grad_norms"]


@pytest.mark.gpu
def test_dryrun_multichip_on_four_cards(four_cards):
    """The reference's dry run over four NCCL ranks (pipeline=2, tensor=2):
    one sharded step of the tiny flagship and a GPipe segment whose hops
    go between cards."""
    from ray_tpu_torch.entry import dryrun_multichip

    summary = dryrun_multichip(4, device="cuda")
    assert summary["gpipe"] == "verified" and summary["step"] == 1
    assert np.isfinite(summary["loss"])
