"""The port's attention and its two kernels' plain versions against the JAX
package, on the CPU. The kernels themselves are held against their plain
versions on the card in ``test_torch_kernels_gpu.py``.

fp32 tolerances are 1e-5 absolute and relative: both sides compute fp32
scores and softmax, in another summation order.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference  # noqa: E402

from ray_tpu.models import generation as JG  # noqa: E402
from ray_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_reference,
)
from ray_tpu_torch.kernels.paged_attention import (  # noqa: E402
    PARTITION,
    _paged_attention,
    gather_rows,
    paged_attention,
    paged_attention_reference,
)
from ray_tpu_torch.ops import attention as PA  # noqa: E402

# ray_tpu.ops re-exports the function ``attention`` under the module's name
JA = importlib.import_module("ray_tpu.ops.attention")

F32 = dict(atol=1e-5, rtol=1e-5)


def _qkv(b=2, s=12, h=4, kv=4, d=16, seed=0, sk=None):
    rs = np.random.RandomState(seed)
    sk = sk or s
    return (
        rs.randn(b, s, h, d).astype(np.float32),
        rs.randn(b, sk, kv, d).astype(np.float32),
        rs.randn(b, sk, kv, d).astype(np.float32),
    )


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [4, 2, 1])
def test_einsum_attention_matches_jax(causal, kv):
    q, k, v = _qkv(kv=kv)
    ref = JA.attention(q, k, v, causal=causal)  # the einsum path on the CPU
    out = PA.attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_attention_explicit_positions_and_mask():
    q, k, v = _qkv(s=8, kv=2, seed=1)
    qpos = np.array([4, 5, 6, 7, 8, 9, 10, 11], np.int32)
    kpos = np.arange(8, dtype=np.int32) * 2
    mask = np.random.RandomState(2).rand(2, 1, 8, 8) > 0.3
    mask[..., 0] = True  # every row keeps one key
    ref = JA.attention(q, k, v, causal=True, q_positions=qpos, kv_positions=kpos, mask=mask)
    tq, tk, tv, tqp, tkp, tm = _t(q, k, v, qpos, kpos, mask)
    out = PA.attention(tq, tk, tv, causal=True, q_positions=tqp.long(), kv_positions=tkp.long(), mask=tm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_attention_bf16_matches_jax():
    q, k, v = _qkv(kv=2, seed=3)
    ref = JA.attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True)
    out = PA.attention(*(x.to(torch.bfloat16) for x in _t(q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    # one bf16 step of outputs bounded by max|v| ~ 3
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2e-2, rtol=2**-7
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [4, 2])
def test_flash_plain_version_matches_library_reference(causal, kv):
    """The flash kernel's plain version against the Pallas kernel's own
    reference (BHSD, no GQA: kv heads repeated for it) and its LSE against
    logsumexp of the scaled scores."""
    q, k, v = _qkv(b=2, s=20, h=4, kv=kv, d=32, seed=4)
    n_rep = 4 // kv
    kr, vr = (np.repeat(x, n_rep, axis=2) for x in (k, v))
    bhsd = [jnp.asarray(np.swapaxes(x, 1, 2)) for x in (q, kr, vr)]
    scale = 1.0 / np.sqrt(32)
    ref = np.swapaxes(
        np.asarray(mha_reference(*bhsd, None, causal=causal, sm_scale=scale)), 1, 2
    )
    out, lse = flash_attention(*_t(q, k, v), causal=causal)  # CPU: the plain version
    # mha_reference runs its einsums at bfloat16 matmul precision
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2, rtol=2e-2)
    scores = np.einsum("bqhd,bkhd->bhqk", q, kr) * scale
    if causal:
        scores = np.where(np.tril(np.ones((20, 20), bool)), scores, -1e30)
    ref_lse = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    np.testing.assert_allclose(lse.numpy(), ref_lse, **F32)
    exact, _ = flash_attention_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(
        exact.numpy(), np.asarray(JA._einsum_attention(q, kr, vr, causal=causal)), **F32
    )


def test_flash_gqa_equals_repeat_then_attend():
    q, k, v = _qkv(h=8, kv=2, seed=5)
    tq, tk, tv = _t(q, k, v)
    out, _ = flash_attention(tq, tk, tv, causal=True)
    rep, _ = flash_attention(tq, tk.repeat_interleave(4, 2), tv.repeat_interleave(4, 2))
    assert torch.equal(out, rep)


def test_cpu_dispatch_takes_einsum_path():
    """On the CPU the flash kernel is never launched: the dispatch rule
    sends CPU tensors to the einsum path."""
    q, k, v = _t(*_qkv())
    before = flash_attention.launches
    assert not PA.flash_eligible(q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16))
    PA.attention(q, k, v)
    flash_attention(q, k, v)
    assert flash_attention.launches == before


def _paged_case(seed=0, contexts=(24, 6, 0), mb=6, bs=4, kv=2, h=4, d=16):
    """Shuffled block tables for the given context lengths; a context of 0
    is an inactive slot (null table, position 0)."""
    rs = np.random.RandomState(seed)
    b = len(contexts)
    num_blocks = 1 + b * mb
    kpool = rs.randn(num_blocks * bs, kv, d).astype(np.float32)
    vpool = rs.randn(num_blocks * bs, kv, d).astype(np.float32)
    tables = np.zeros((b, mb), np.int32)
    perm = rs.permutation(np.arange(1, num_blocks)).astype(np.int32)
    positions = np.array([max(c - 1, 0) for c in contexts], np.int32)
    for i, c in enumerate(contexts):
        n = -(-c // bs)
        tables[i, :n] = perm[i * mb: i * mb + n]
    q = rs.randn(b, h, d).astype(np.float32)
    return q, kpool, vpool, tables, positions, bs


# the kernel's partition edges: contexts of one token, one partition less
# one, exactly one, one more, two, and the whole block table
EDGE_MB, EDGE_BS = 2 * PARTITION // 4 + 3, 4
EDGE_CONTEXTS = (1, PARTITION - 1, PARTITION, PARTITION + 1, 2 * PARTITION, EDGE_MB * EDGE_BS)


@pytest.mark.parametrize(
    "contexts,mb,kv,h",
    [((24, 6, 0), 6, 2, 4)]
    + [((ctx, 6, 0), EDGE_MB, 2, 2 * group) for ctx in EDGE_CONTEXTS for group in (1, 4)],
)
def test_paged_plain_version_matches_jax(contexts, mb, kv, h):
    q, kpool, vpool, tables, positions, bs = _paged_case(
        contexts=contexts, mb=mb, bs=EDGE_BS, kv=kv, h=h)
    b, mb = tables.shape
    idx = (tables[:, :, None] * bs + np.arange(bs)[None, None, :]).reshape(b, mb * bs)
    ref = JG._paged_attention(q[:, None], kpool[idx], vpool[idx], positions[:, None])[:, 0]
    tq, tk, tv, tt, tp = _t(q, kpool, vpool, tables, positions)
    out = paged_attention(tq, tk, tv, tt, tp, bs)  # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    gk = gather_rows(tk, tt, bs)
    assert torch.equal(gk, torch.from_numpy(kpool[idx]))
    direct = _paged_attention(tq[:, None], gk, gather_rows(tv, tt, bs), tp[:, None].long())
    np.testing.assert_allclose(direct[:, 0].numpy(), np.asarray(ref), **F32)


def test_paged_rows_are_independent():
    """A sequence's output does not depend on its batch neighbours."""
    q, kpool, vpool, tables, positions, bs = _paged_case(seed=1)
    tq, tk, tv, tt, tp = _t(q, kpool, vpool, tables, positions)
    full = paged_attention_reference(tq, tk, tv, tt, tp, bs)
    for i in range(len(q)):
        alone = paged_attention_reference(tq[i:i + 1], tk, tv, tt[i:i + 1], tp[i:i + 1], bs)
        assert torch.equal(full[i], alone[0])
