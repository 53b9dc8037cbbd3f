"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked ``gpu`` and skips where there is no card: the
kernels have no CPU mode. This file imports only torch, so it runs on the
card's machine as it is:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_reference
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


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,s,h,kv,d,causal",
    [(1, 1000, 8, 8, 128, True), (2, 257, 4, 2, 64, False), (1, 130, 4, 4, 256, True)],
)
def test_flash_kernel_matches_plain_on_card(cuda, b, s, h, kv, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, s, kv, d), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, s, kv, d), generator=gen, device=cuda).bfloat16()
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
