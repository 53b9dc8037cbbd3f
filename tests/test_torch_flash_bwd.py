"""The flash-attention backward's plain version and the port's
``FlashAttention`` autograd function against the Pallas module's own
references, on the CPU. The CUDA kernel itself is held against the plain
version on the card in ``test_torch_kernels_gpu.py``.

Inputs are made with numpy. fp32 gradients agree with the references at
1e-5 absolute and relative (measured below 1e-6: the same fp32 arithmetic
in another order, and another masking constant on the reference's side);
the float64 gradient check uses torch's default tolerances.
"""

import functools
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import (  # noqa: E402
    mha_reference_bwd,
    mha_reference_no_custom_vjp,
)

from ray_tpu_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
)
from ray_tpu_torch.ops import attention as PA  # noqa: E402

# ray_tpu.ops re-exports the function ``attention`` under the module's name
JA = importlib.import_module("ray_tpu.ops.attention")

F32 = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, sq, h, kv, d, seed, sk=None):
    rs = np.random.RandomState(seed)
    sk = sk or sq
    return (
        rs.randn(b, sq, h, d).astype(np.float32),
        rs.randn(b, sk, kv, d).astype(np.float32),
        rs.randn(b, sk, kv, d).astype(np.float32),
        rs.randn(b, sq, h, d).astype(np.float32),  # d_out
    )


def _bhsd(x):
    return jnp.asarray(np.swapaxes(x, 1, 2))


def _port_grads(q, k, v, d_out, causal):
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, d_out))
    out, lse = flash_attention(tq, tk, tv, causal=causal)  # CPU: the plain version
    return flash_attention_backward(tq, tk, tv, out, lse, tdo, causal=causal)


@functools.partial(jax.jit, static_argnums=4)
def _jax_vjp(q, k, v, d_out, causal):
    """vjp of the Pallas module's reference (no custom vjp), through the
    JAX package's ``_repeat_kv`` for grouped-query attention."""
    n_rep = q.shape[2] // k.shape[2]
    scale = 1.0 / np.sqrt(q.shape[-1])

    def f(q, k, v):
        kr, vr = JA._repeat_kv(k, n_rep), JA._repeat_kv(v, n_rep)
        out = mha_reference_no_custom_vjp(
            *(jnp.swapaxes(x, 1, 2) for x in (q, kr, vr)), causal=causal, sm_scale=scale
        )
        return jnp.swapaxes(out, 1, 2)

    return jax.vjp(f, q, k, v)[1](d_out)



@pytest.mark.parametrize(
    "b,sq,sk,h,kv,d,causal",
    [
        (2, 20, 20, 4, 4, 16, True),  # ragged: no tile size divides 20
        (2, 20, 20, 4, 4, 16, False),
        (1, 12, 20, 2, 2, 32, True),  # more keys than queries, top-left causal
        (1, 33, 17, 2, 2, 8, False),
        (2, 24, 24, 8, 2, 16, True),  # grouped-query attention
        (1, 19, 19, 6, 1, 16, False),  # multi-query
    ],
)
def test_plain_backward_matches_pallas_reference_vjp(b, sq, sk, h, kv, d, causal):
    q, k, v, d_out = _inputs(b, sq, h, kv, d, seed=sq + h, sk=sk)
    ref = [np.asarray(g) for g in _jax_vjp(q, k, v, d_out, causal)]
    got = _port_grads(q, k, v, d_out, causal)
    for name, g, r in zip("qkv", got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, **F32, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_mha_reference_bwd(causal):
    """Against the Pallas kernel's own reference backward, which takes the
    forward's l and m and only ``sm_scale == 1``: q is pre-scaled for it and
    its dq scaled back."""
    b, s, h, d = 2, 20, 4, 32
    q, k, v, d_out = _inputs(b, s, h, h, d, seed=7)
    scale = 1.0 / np.sqrt(d)
    qs, kt, vt, dot = (_bhsd(x) for x in (q * scale, k, v, d_out))
    out, l, m = mha_reference_no_custom_vjp(qs, kt, vt, causal=causal, save_residuals=True)
    dq, dk, dv, _ = mha_reference_bwd(qs, kt, vt, None, None, out, l, m, dot, causal=causal)
    ref = [np.swapaxes(np.asarray(g), 1, 2) for g in (dq * scale, dk, dv)]
    got = _port_grads(q, k, v, d_out, causal)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), r, **F32, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [2, 1])
def test_flash_attention_function_gradcheck(causal, kv):
    rs = np.random.RandomState(11)
    sk = 5 if causal else 7
    q, k, v = (
        torch.from_numpy(rs.randn(*shape)).requires_grad_()
        for shape in ((1, 5, 2, 8), (1, sk, kv, 8), (1, sk, kv, 8))
    )
    fn = lambda q, k, v: FlashAttention.apply(q, k, v, causal)[0]  # noqa: E731
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_attention_flash_branch_gradient_equals_einsum_branch():
    """``attention``'s two branches give the same gradients; on the CPU the
    flash branch is never taken, so the autograd function is applied
    directly beside it."""
    q, k, v, d_out = (torch.from_numpy(x) for x in _inputs(2, 16, 4, 2, 16, seed=3))
    grads = []
    for fn in (
        lambda q, k, v: PA.attention(q, k, v, causal=True),
        lambda q, k, v: FlashAttention.apply(q, k, v, True)[0],
    ):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, d_out))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **F32)


def test_cpu_backward_takes_the_plain_version():
    q, k, v, d_out = (torch.from_numpy(x) for x in _inputs(1, 8, 2, 2, 16, seed=4))
    out, lse = flash_attention(q, k, v)
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, lse, d_out)
    ref = flash_attention_backward_reference(q, k, v, out, lse, d_out)
    assert flash_attention_backward.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_plain_backward_bf16_sums_the_group_in_fp32():
    """bf16 inputs: the gradients come back in bf16, and a kv head's dK/dV
    equal the fp32 group sum rounded once."""
    q, k, v, d_out = (torch.from_numpy(x).bfloat16() for x in _inputs(1, 12, 4, 1, 16, seed=5))
    out, lse = flash_attention(q, k, v)
    dq, dk, dv = flash_attention_backward_reference(q, k, v, out, lse, d_out)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    rep = [x.repeat_interleave(4, dim=2) for x in (k, v)]
    _, dk_rep, dv_rep = flash_attention_backward_reference(
        q.float(), rep[0].float(), rep[1].float(), out.float(), lse, d_out.float()
    )
    assert torch.equal(dk, dk_rep.sum(2, keepdim=True).bfloat16())
    assert torch.equal(dv, dv_rep.sum(2, keepdim=True).bfloat16())
