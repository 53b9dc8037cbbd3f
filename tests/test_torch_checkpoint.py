"""The port's pytree checkpoints (``ray_tpu_torch.train``): a train state
saved and restored gives a bitwise-equal next step (TINY through
``build_lm_train_step``, and an MNIST MLP under Adam); a tree round-trips
to the same values as through the JAX package's ``save_pytree`` and
``load_pytree``."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ray_tpu.train.jax_utils import load_pytree as j_load  # noqa: E402
from ray_tpu.train.jax_utils import save_pytree as j_save  # noqa: E402
from ray_tpu_torch.models import mnist as PM  # noqa: E402
from ray_tpu_torch.models import transformer as PT  # noqa: E402
from ray_tpu_torch.parallel.spmd import build_lm_train_step  # noqa: E402
from ray_tpu_torch.train import load_pytree, save_pytree  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_state_round_trip_gives_a_bitwise_equal_next_step(tmp_path, dtype):
    cfg = dataclasses.replace(PT.TINY, dtype=dtype)
    bundle = build_lm_train_step(cfg, device="cpu", learning_rate=1e-2)
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(2, 16)))
    targets = torch.roll(tokens, -1, 1)
    state = bundle.init_state(0)
    state, _ = bundle.step_fn(state, tokens, targets)  # moments are non-zero now
    save_pytree(state, str(tmp_path / "ckpt"))
    want_state, want = bundle.step_fn(state, tokens, targets)

    other = bundle.init_state(1)  # other weights, zero moments
    restored = load_pytree(str(tmp_path / "ckpt"), target=other)
    assert restored["step"] == 1 and restored["opt"] is other["opt"]
    got_state, got = bundle.step_fn(restored, tokens, targets)
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    for k, v in want_state["params"].items():
        assert torch.equal(got_state["params"][k], v), k


def test_mnist_state_round_trip_gives_a_bitwise_equal_next_step(tmp_path):
    rs = np.random.RandomState(1)
    xs = torch.from_numpy(rs.randn(64, 784).astype(np.float32))
    ys = torch.from_numpy(rs.randint(0, 10, size=64))

    def make(seed):
        params = PM.init_mlp(torch.Generator().manual_seed(seed), hidden=(32,), device="cpu")
        leaves = [t.requires_grad_() for layer in params["layers"] for t in layer.values()]
        return {"params": params, "opt": torch.optim.Adam(leaves, lr=1e-3)}

    def step(state):
        state["opt"].zero_grad()
        loss = PM.cross_entropy_loss(PM.apply_mlp(state["params"], xs), ys)
        loss.backward()
        state["opt"].step()
        return loss.detach()

    state = make(0)
    step(state)
    save_pytree(state, str(tmp_path / "mnist"))
    want = [step(state) for _ in range(2)]
    restored = load_pytree(str(tmp_path / "mnist"), target=make(5))
    got = [step(restored) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_round_trip_matches_jax_package(tmp_path):
    tree = {"layers": [{"w": np.random.RandomState(2).randn(4, 3).astype(np.float32),
                        "b": np.arange(3, dtype=np.float32)}],
            "scale": np.float32(0.5) * np.ones((2,), np.float32)}
    j_save(tree, str(tmp_path / "jax"))
    ref = j_load(str(tmp_path / "jax"), target=tree)
    save_pytree(params_from_jax(tree, device="cpu"), str(tmp_path / "port"))
    got = load_pytree(str(tmp_path / "port"))
    assert jax.tree.structure(jax.tree.map(np.asarray, ref)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), got))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_load_rejects_a_target_of_another_shape(tmp_path):
    save_pytree({"w": torch.zeros(3)}, str(tmp_path / "c"))
    with pytest.raises(ValueError):
        load_pytree(str(tmp_path / "c"), target={"w": torch.zeros(4)})
    with pytest.raises(ValueError):
        load_pytree(str(tmp_path / "c"), target={"w": torch.zeros(3, dtype=torch.bfloat16)})
    with pytest.raises(ValueError):
        load_pytree(str(tmp_path / "c"), target={"v": torch.zeros(3)})
    target = {"w": torch.ones(3)}
    assert load_pytree(str(tmp_path / "c"), target=target)["w"] is target["w"]
    assert torch.equal(target["w"], torch.zeros(3))
