"""The port's MNIST nets and single-device MoE MLP against the JAX
package's, on the CPU, with the JAX weights carried over by
``params_from_jax`` (nested pytrees). fp32 throughout: MNIST logits to 1e-4
absolute and relative; MoE outputs and aux loss to 1e-5 absolute (the
reference's own expert-parallel tolerance).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import mnist as JM  # noqa: E402
from ray_tpu.models import moe as JMoE  # noqa: E402
from ray_tpu_torch.models import mnist as PM  # noqa: E402
from ray_tpu_torch.models import moe as PMoE  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402
from test_torch_transformer import ROOT, _port_sources  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_params_from_jax_carries_nested_trees_bit_exact():
    tree = {"layers": [{"w": np.random.RandomState(0).randn(3, 2).astype(np.float32),
                        "b": np.asarray(jnp.arange(2, dtype=jnp.bfloat16) / 3)}],
            "fc1": {"w": np.float32(np.pi) * np.ones((2, 2), np.float32)}}
    out = params_from_jax(tree, device="cpu")
    assert isinstance(out["layers"], list) and sorted(out["layers"][0]) == ["b", "w"]
    assert out["layers"][0]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["layers"][0]["w"].numpy(), tree["layers"][0]["w"])
    np.testing.assert_array_equal(out["layers"][0]["b"].view(torch.int16).numpy(),
                                  tree["layers"][0]["b"].view(np.int16))
    np.testing.assert_array_equal(out["fc1"]["w"].numpy(), tree["fc1"]["w"])


def test_mlp_logits_match_jax():
    jp = _numpy_tree(jax.jit(lambda k: JM.init_mlp(k, hidden=(64, 32)))(jax.random.PRNGKey(0)))
    x = np.random.RandomState(1).randn(8, 28, 28, 1).astype(np.float32)
    ref = np.asarray(jax.jit(JM.apply_mlp)(jp, x))
    out = PM.apply_mlp(params_from_jax(jp, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def test_cnn_logits_match_jax():
    jp = _numpy_tree(jax.jit(JM.init_cnn)(jax.random.PRNGKey(2)))
    x = np.random.RandomState(3).randn(4, 28, 28, 1).astype(np.float32)
    ref = np.asarray(jax.jit(JM.apply_cnn)(jp, x))
    out = PM.apply_cnn(params_from_jax(jp, device="cpu"), torch.from_numpy(x))
    assert out.shape == (4, 10)
    np.testing.assert_allclose(out.numpy(), ref, **F32)
    labels = np.arange(4, dtype=np.int32)
    np.testing.assert_allclose(PM.cross_entropy_loss(out, torch.from_numpy(labels)).item(),
                               float(jax.jit(JM.cross_entropy_loss)(ref, labels)), rtol=1e-5)
    assert PM.accuracy(out, labels).item() == float(jax.jit(JM.accuracy)(ref, labels))


def test_init_shapes_match_reference():
    for jinit, pinit in ((JM.init_mlp, PM.init_mlp), (JM.init_cnn, PM.init_cnn)):
        jp = jax.eval_shape(lambda init=jinit: init(jax.random.PRNGKey(0)))
        tp = pinit(torch.Generator().manual_seed(0), device="cpu")
        tp = jax.tree.map(lambda t: t.numpy(), tp)
        assert jax.tree.structure(jp) == jax.tree.structure(tp)
        for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            assert tuple(j.shape) == t.shape and str(j.dtype) == str(t.dtype)
    assert PM.apply_cnn(PM.init_cnn(torch.Generator().manual_seed(0), device="cpu"),
                        torch.ones(2, 28, 28, 1)).shape == (2, 10)


def synthetic_mnist():
    """``test_mnist_mlp_learns_synthetic``'s data: class = argmax of 10
    fixed projections."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(784, 10))
    xs = rng.normal(size=(512, 784)).astype(np.float32)
    ys = np.argmax(xs @ w_true, axis=1).astype(np.int64)
    return xs, ys


def test_mlp_learns_synthetic():
    """30 Adam steps at lr 1e-3: the loss falls below 0.6x its first value
    and accuracy passes 0.5, as in the reference's test."""
    xs, ys = (torch.from_numpy(a) for a in synthetic_mnist())
    params = PM.init_mlp(torch.Generator().manual_seed(0), hidden=(64,), device="cpu")
    leaves = [t.requires_grad_() for layer in params["layers"] for t in layer.values()]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    losses = []
    for _ in range(30):
        opt.zero_grad()
        loss = PM.cross_entropy_loss(PM.apply_mlp(params, xs), ys)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < 0.6 * losses[0]
    with torch.no_grad():
        assert PM.accuracy(PM.apply_mlp(params, xs), ys).item() > 0.5


MOE_CASES = {
    # the reference's expert-parallel case
    "ep": (JMoE.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2, capacity_factor=2.0),
           (2, 16, 32)),
    "default": (JMoE.MoEConfig(), (2, 24, 128)),
    # capacity far below demand: most tokens dropped
    "drops": (JMoE.MoEConfig(d_model=16, d_ff=32, num_experts=2, top_k=1,
                             capacity_factor=0.25), (1, 32, 16)),
}


def _port_moe_cfg(cfg):
    return PMoE.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=cfg.num_experts,
                          top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_matches_jax(name):
    cfg, shape = MOE_CASES[name]
    jp = _numpy_tree(jax.jit(lambda k: JMoE.init_moe_params(k, cfg))(jax.random.PRNGKey(0)))
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    y_ref, aux_ref = jax.jit(lambda p, xx: JMoE.moe_mlp(p, xx, cfg))(jp, x)
    y, aux = PMoE.moe_mlp(params_from_jax(jp, device="cpu"), torch.from_numpy(x),
                          _port_moe_cfg(cfg))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    assert abs(aux.item() - float(aux_ref)) < 1e-5
    if name == "drops":
        # capacity 4 of 32 tokens per expert: the dropped tokens' rows are 0
        dropped = np.all(y.numpy()[0] == 0.0, axis=-1)
        assert dropped.sum() >= 32 - 2 * 4 and np.isfinite(y.numpy()).all()


def test_moe_init_and_axes_match_reference():
    cfg = JMoE.MoEConfig()
    jp = jax.eval_shape(lambda: JMoE.init_moe_params(jax.random.PRNGKey(0), cfg))
    tp = PMoE.init_moe_params(torch.Generator().manual_seed(0), PMoE.MoEConfig(), device="cpu")
    assert {k: tuple(v.shape) for k, v in jp.items()} == {k: tuple(v.shape) for k, v in tp.items()}
    assert PMoE.moe_param_logical_axes() == JMoE.moe_param_logical_axes()


def test_new_modules_are_walked_by_the_isolation_test():
    """The modules of this slice are among the sources that
    ``test_port_imports_neither_jax_nor_ray_tpu`` walks (and ``import
    ray_tpu_torch``, which ``test_import_leaves_jax_and_ray_tpu_out`` runs,
    imports each of them)."""
    new = ["models/vit.py", "models/mnist.py", "models/moe.py", "serve/llm/deployment.py",
           "train/torch_utils.py"]
    port = ROOT / "ray_tpu_torch"
    sources = {p.relative_to(port).as_posix() for p in _port_sources() if port in p.parents}
    assert set(new) <= sources
    import ray_tpu_torch

    assert all(m in dir(ray_tpu_torch) for m in ("vit", "mnist", "moe", "LLMServer", "save_pytree"))
