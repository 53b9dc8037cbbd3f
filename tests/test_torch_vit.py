"""The port's ViT against the JAX package's, on the CPU, with the JAX
weights carried over (``VIT_TINY_TEST`` in fp32). Tolerances are those of
``test_torch_train.py``: logits to 1e-4 absolute and relative, the loss to
1e-4 relative, each gradient to 5e-4 in relative Frobenius norm (the same
fp32 arithmetic in another order).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import vit as JV  # noqa: E402
from ray_tpu_torch.models import vit as PV  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402
from test_torch_train import GRAD_RTOL, LOSS_RTOL, rel_frobenius  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
JCFG = dataclasses.replace(JV.VIT_TINY_TEST, dtype=jnp.float32)
PCFG = dataclasses.replace(PV.VIT_TINY_TEST, dtype=torch.float32)


def numpy_params(seed=0):
    """Weights in the reference's shapes and dtypes at 1/sqrt(fan-in)
    (0.02 for the embeddings); norms perturbed from one so that they
    matter."""
    shapes = jax.eval_shape(lambda: JV.init_params(jax.random.PRNGKey(0), JCFG))
    d, f = JCFG.d_model, JCFG.d_ff
    fan_in = {"patch_embed": JCFG.patch_dim, "wq": d, "wk": d, "wv": d, "wo": d, "w_up": d,
              "w_down": f, "head": d}
    rs = np.random.RandomState(seed)
    out = {}
    for name, sd in sorted(shapes.items()):
        if "norm" in name:
            a = 1.0 + 0.1 * rs.randn(*sd.shape)
        else:
            a = rs.randn(*sd.shape) * (fan_in[name] ** -0.5 if name in fan_in else 0.02)
        out[name] = a.astype(sd.dtype)
    return out


def _batch(b=4, seed=1):
    rs = np.random.RandomState(seed)
    images = rs.randn(b, 32, 32, 3).astype(np.float32)
    labels = rs.randint(0, 10, size=b).astype(np.int32)
    return images, labels


def test_presets_and_init_params_match_reference():
    for name in ("VIT_TINY_TEST", "VIT_B_16", "VIT_L_16"):
        jcfg, pcfg = getattr(JV, name), getattr(PV, name)
        for f in ("num_patches", "patch_dim", "head_dim", "d_ff", "n_layers", "num_classes"):
            assert getattr(jcfg, f) == getattr(pcfg, f), (name, f)
    cfg = JV.VIT_TINY_TEST
    jp = jax.eval_shape(lambda: JV.init_params(jax.random.PRNGKey(0), cfg))
    tp = PV.init_params(torch.Generator().manual_seed(0), PV.VIT_TINY_TEST, device="cpu")
    assert sorted(jp) == sorted(tp) == sorted(PV.param_logical_axes(PV.VIT_TINY_TEST))
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        assert str(jp[k].dtype) == str(tp[k].dtype).replace("torch.", ""), k
        assert len(PV.param_logical_axes(PV.VIT_TINY_TEST)[k]) == tp[k].dim(), k


def test_patchify_roundtrip():
    """The reference's case: the first patch is the top-left 2x2 block in
    row-major order; and patchify matches JAX's on a random batch."""
    cfg = PV.ViTConfig(image_size=4, patch_size=2, num_channels=1, d_model=8, n_layers=1,
                       n_heads=1, d_ff=8)
    img = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    patches = PV.patchify(cfg, img)
    assert patches.shape == (1, 4, 4)
    assert patches[0, 0].tolist() == [0, 1, 4, 5]
    images, _ = _batch()
    np.testing.assert_array_equal(PV.patchify(PCFG, torch.from_numpy(images)).numpy(),
                                  np.asarray(JV.patchify(JCFG, jnp.asarray(images))))


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_matches_jax(use_flash):
    jp = numpy_params()
    images, _ = _batch()
    ref = np.asarray(jax.jit(lambda p, x: JV.forward(JCFG, p, x))(jp, images))
    out = PV.forward(PCFG, params_from_jax(jp, device="cpu"), torch.from_numpy(images),
                     use_flash=use_flash)
    assert out.dtype == torch.float32 and out.shape == (4, 10)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jp = numpy_params(seed=2)
    images, labels = _batch(seed=3)
    jcfg, pcfg = (dataclasses.replace(c, remat=remat) for c in (JCFG, PCFG))
    (ref_loss, ref_acc), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: JV.loss_fn(jcfg, p, images, labels), has_aux=True))(jp)
    leaves = {k: v.requires_grad_() for k, v in params_from_jax(jp, device="cpu").items()}
    loss, acc = PV.loss_fn(pcfg, leaves, torch.from_numpy(images), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    assert acc.item() == float(ref_acc)
    assert sorted(leaves) == sorted(ref_grads)
    for k, v in leaves.items():
        assert rel_frobenius(v.grad.numpy(), np.asarray(ref_grads[k])) <= GRAD_RTOL, k


def test_bf16_forward_runs_in_the_model_dtype():
    tp = PV.init_params(torch.Generator().manual_seed(3), PV.VIT_TINY_TEST, device="cpu")
    assert tp["wq"].dtype == torch.bfloat16 and tp["pos_embed"].dtype == torch.float32
    images, labels = _batch()
    logits = PV.forward(PV.VIT_TINY_TEST, tp, torch.from_numpy(images))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    loss, _ = PV.loss_fn(PV.VIT_TINY_TEST, tp, torch.from_numpy(images), labels)
    assert torch.isfinite(loss)
