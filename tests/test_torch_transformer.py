"""The port's transformer forward against the JAX package's, with the JAX
weights carried over; and the port's isolation from JAX and ``ray_tpu``.

Weights are made with numpy in the reference's shapes and carried into
both. Logit parity runs in fp32 at 1e-4 absolute and relative (measured
~2e-6: the same fp32 arithmetic in another order); the bf16 case is held
to bf16 rounding noise, as its docstring states.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import transformer as JT  # noqa: E402
from ray_tpu.serve.llm.deployment import TINY_MODEL  # noqa: E402
from ray_tpu_torch.models import transformer as PT  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
F32 = dict(atol=1e-4, rtol=1e-4)


def port_cfg(cfg):
    """The port's TransformerConfig with the JAX one's fields."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JT.TransformerConfig)}
    fields["dtype"] = torch.float32 if jnp.dtype(cfg.dtype) == jnp.float32 else torch.bfloat16
    return PT.TransformerConfig(**fields)


def numpy_params(cfg, seed=0):
    """Weights made with numpy in the reference's shapes, dtypes and init
    scales; norm weights are perturbed from one so that they matter."""
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg))
    rs = np.random.RandomState(seed)
    out = {}
    for name, sd in sorted(shapes.items()):
        if "norm" in name:
            a = 1.0 + 0.1 * rs.randn(*sd.shape)
        else:
            fan_in = cfg.vocab_size if name == "embed" else int(np.prod(sd.shape[-3:-1] if name == "wo" else sd.shape[-2:-1]))
            a = rs.randn(*sd.shape) / np.sqrt(fan_in)
        out[name] = a.astype(sd.dtype)
    return out


def carried(cfg, seed=0):
    params = numpy_params(cfg, seed)
    return params, params_from_jax(params, device="cpu")


jax_forward = jax.jit(JT.forward, static_argnums=2)


CONFIGS = {
    "tiny_f32": dataclasses.replace(JT.TINY, dtype=jnp.float32),
    "gptj_parallel_gelu": JT.TransformerConfig(
        vocab_size=101, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64,
        parallel_block=True, use_swiglu=False, dtype=jnp.float32, remat=False,
    ),
    "tiny_model_gqa": dataclasses.replace(
        JT.TransformerConfig(**{**TINY_MODEL, "dtype": jnp.float32}), remat=False
    ),
    "tied_embeddings": JT.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=2, d_ff=64, max_seq_len=32,
        tie_embeddings=True, dtype=jnp.float32, remat=False,
    ),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax_fp32(name):
    cfg = CONFIGS[name]
    jp, tp = carried(cfg)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    ref = np.asarray(jax_forward(jp, jnp.asarray(toks), cfg))
    out = PT.forward(tp, torch.from_numpy(toks).long(), port_cfg(cfg))
    np.testing.assert_allclose(out.numpy(), ref, **F32)
    assert (out.numpy().argmax(-1) == ref.argmax(-1)).all()


def test_forward_matches_jax_bf16_tiny():
    """bf16 dtype handling: the port's bf16 logits sit within bf16 rounding
    noise of JAX's. The noise floor is each side's distance from an fp32 run
    of the same weights (measured ~0.03 mean on O(1) logits); the port must
    be closer to JAX than half that floor, and no further from fp32 than
    1.25 times JAX is."""
    jp, tp = carried(JT.TINY)
    toks = np.random.RandomState(2).randint(0, 256, size=(2, 24)).astype(np.int32)
    ref = np.asarray(jax_forward(jp, jnp.asarray(toks), JT.TINY).astype(jnp.float32))
    out = PT.forward(tp, torch.from_numpy(toks).long(), port_cfg(JT.TINY))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    cfg32 = dataclasses.replace(JT.TINY, dtype=jnp.float32)
    exact = np.asarray(jax_forward({k: np.asarray(v, np.float32) for k, v in jp.items()},
                                   jnp.asarray(toks), cfg32))
    floor = np.abs(ref - exact).mean()
    assert np.abs(out - ref).mean() <= 0.5 * floor
    assert np.abs(out - exact).mean() <= 1.25 * floor


def test_forward_explicit_positions():
    cfg = CONFIGS["tiny_f32"]
    jp, tp = carried(cfg, seed=3)
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, size=(1, 10)).astype(np.int32)
    pos = (np.arange(10, dtype=np.int32) + 7)[None]
    ref = np.asarray(jax_forward(jp, jnp.asarray(toks), cfg, positions=jnp.asarray(pos)))
    out = PT.forward(tp, torch.from_numpy(toks).long(), port_cfg(cfg),
                     positions=torch.from_numpy(pos).long())
    np.testing.assert_allclose(out.numpy(), ref, **F32)


@pytest.mark.parametrize("preset", ["GPTJ_6B", "LLAMA2_7B", "TINY"])
def test_presets_and_init_params_shapes(preset):
    jcfg, pcfg = getattr(JT, preset), getattr(PT, preset)
    assert pcfg.head_dim == jcfg.head_dim and pcfg.kv_heads == jcfg.kv_heads
    assert pcfg.num_params() == jcfg.num_params()
    if preset == "TINY":
        jp = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
        tp = PT.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert tuple(jp[k].shape) == tuple(tp[k].shape), k
            assert str(jp[k].dtype) == str(tp[k].dtype).replace("torch.", ""), k
        # the reference's scale for wq is 1/sqrt(d_model)
        assert abs(tp["wq"].float().std().item() - 128 ** -0.5) < 0.01


# -- isolation --------------------------------------------------------------


def _port_sources():
    return sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_ray_tpu():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "flax", "optax"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_import_leaves_jax_and_ray_tpu_out():
    code = (
        "import sys, ray_tpu_torch, ray_tpu_torch.serve.llm.engine,"
        " ray_tpu_torch.parallel.spmd, ray_tpu_torch.entry, ray_tpu_torch.rl;"
        "bad=[m for m in sys.modules if m.split('.')[0] in ('jax','ray_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cuda_requested_without_gpu_raises(monkeypatch):
    from ray_tpu_torch import init_paged_pool, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        PT.init_params(torch.Generator(), PT.TINY)  # default device is cuda
    with pytest.raises(RuntimeError):
        init_paged_pool(PT.TINY, 4, 4)
    assert resolve_device("cpu") == torch.device("cpu")
