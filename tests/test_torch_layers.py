"""The port's layer primitives and weight carrying against the JAX package.

Inputs are made with numpy from a seed and go through both sides; the port
runs on the CPU (``device="cpu"``). Tolerances: fp32 1e-5 absolute and
relative (both sides do the same fp32 arithmetic, in another order); bf16
cases allow one bf16 step (2**-8 relative) where the two frameworks round
at different points.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.ops import layers as JL  # noqa: E402
from ray_tpu_torch.ops import layers as PL  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_fp32_and_bf16():
    x, w = _rand(3, 5, 64), _rand(64, seed=1)
    np.testing.assert_allclose(
        PL.rms_norm(_t(x), _t(w)).numpy(), np.asarray(JL.rms_norm(x, w)), **F32
    )
    xb = jnp.asarray(x, jnp.bfloat16)
    out = PL.rms_norm(_t(x).to(torch.bfloat16), _t(w))
    assert out.dtype == torch.bfloat16  # cast back to the input dtype
    ref = np.asarray(JL.rms_norm(xb, w).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=2**-8)


def test_layer_norm():
    x, w, b = _rand(2, 7, 32), _rand(32, seed=1), _rand(32, seed=2)
    np.testing.assert_allclose(
        PL.layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(JL.layer_norm(x, w, b)),
        **F32,
    )


@pytest.mark.parametrize("head_dim,max_len", [(16, 64), (128, 4096)])
def test_rope_frequencies(head_dim, max_len):
    cos, sin = PL.rope_frequencies(head_dim, max_len, device="cpu")
    jcos, jsin = JL.rope_frequencies(head_dim, max_len)
    assert cos.shape == (max_len, head_dim // 2)
    # angles up to max_len rad: fp32 sin/cos of large arguments differ by a
    # few ulps of the angle between libm and XLA
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-4, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-4, rtol=0)


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope(with_positions):
    x = _rand(2, 6, 4, 16)
    cos, sin = JL.rope_frequencies(16, 32)
    pos = np.array([[3, 1, 4, 1, 5, 9], [2, 6, 5, 3, 5, 8]], np.int32) if with_positions else None
    ref = JL.apply_rope(x, cos, sin, None if pos is None else jnp.asarray(pos))
    out = PL.apply_rope(
        _t(x), _t(cos), _t(sin), None if pos is None else torch.from_numpy(pos).long()
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_apply_rope_bf16_casts_tables_first():
    x = _rand(1, 5, 2, 8)
    cos, sin = JL.rope_frequencies(8, 16)
    ref = JL.apply_rope(jnp.asarray(x, jnp.bfloat16), cos, sin)
    out = PL.apply_rope(_t(x).to(torch.bfloat16), _t(cos), _t(sin))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2e-2, rtol=2**-7
    )


def test_swiglu_and_gelu():
    a, b = _rand(4, 33), _rand(4, 33, seed=1)
    np.testing.assert_allclose(
        PL.swiglu(_t(a), _t(b)).numpy(), np.asarray(JL.swiglu(a, b)), **F32
    )
    np.testing.assert_allclose(PL.gelu(_t(a)).numpy(), np.asarray(JL.gelu(a)), **F32)


def test_params_from_jax_is_bit_exact():
    rs = np.random.RandomState(3)
    params = {
        "w_bf16": np.asarray(jnp.asarray(rs.randn(4, 3, 5), jnp.bfloat16)),
        "n_f32": rs.randn(7).astype(np.float32),
    }
    out = params_from_jax(params, device="cpu")
    assert out["w_bf16"].dtype == torch.bfloat16 and out["n_f32"].dtype == torch.float32
    assert (
        out["w_bf16"].view(torch.int16).numpy() == params["w_bf16"].view(np.int16)
    ).all()
    assert (out["n_f32"].numpy().view(np.int32) == params["n_f32"].view(np.int32)).all()
