"""``ray_tpu_torch.dag.compile_torch_pipeline`` against the JAX package's
``compile_jax_pipeline``, on the CPU (where the chain runs eagerly; the CUDA
graph path runs on the card: ``tests/test_torch_kernels_gpu.py`` and
``chip_smoke.py`` phase ``dag_pipeline``).

- ``tests/test_util_apis.py``'s chain and a few more through both packages
  on the same seeded numpy inputs, with and without ``donate``: equal to
  float32 rounding, 1e-6 relative and absolute (the two libraries order the
  sums of ``sum``, ``cumsum``, the matmul and the mean differently; the
  mean of tanh values of order one can cancel to a small result, so its
  error is absolute).
- ``forward_stages`` of a 2-layer model (TINY and GPT-J's block) compiled
  into one pipeline: equal to the eager ``forward`` bit for bit (the same
  ops in the same order), and to the JAX ``forward`` on carried weights to
  ``tests/test_torch_transformer.py``'s fp32 rule (1e-4).
- A graph capture feeds the step plane's compile stage and its recompile
  detector (``cuda_graph_capture`` marks a new executable).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.dag import compile_jax_pipeline  # noqa: E402
from ray_tpu.models import transformer as JT  # noqa: E402
from ray_tpu_torch.dag import compile_torch_pipeline  # noqa: E402
from ray_tpu_torch.models import transformer as PT  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

CHAIN_RTOL = CHAIN_ATOL = 1e-6
F32 = dict(atol=1e-4, rtol=1e-4)

# (jax stages, torch stages, input shape): the reference's case first
CHAINS = {
    "add_mul_sum": ([lambda x: x + 1, lambda x: x * 2, jnp.sum],
                    [lambda x: x + 1, lambda x: x * 2, torch.sum], (4,)),
    "sin_scale_cumsum": ([jnp.sin, lambda x: x * 3, lambda x: jnp.cumsum(x, axis=-1)],
                         [torch.sin, lambda x: x * 3, lambda x: torch.cumsum(x, dim=-1)],
                         (3, 5)),
    "matmul_chain": ([lambda x: x @ x.T, jnp.tanh, lambda x: x.mean(axis=0)],
                     [lambda x: x @ x.T, torch.tanh, lambda x: x.mean(dim=0)], (6, 4)),
}


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_matches_compile_jax_pipeline(name, donate):
    jstages, tstages, shape = CHAINS[name]
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    if name == "add_mul_sum":
        x = np.ones(shape, np.float32)
    want = np.asarray(compile_jax_pipeline(jstages, donate=donate)(jnp.asarray(x)))
    fused = compile_torch_pipeline(tstages, donate=donate)
    got = fused(torch.from_numpy(x.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    if name == "add_mul_sum":
        assert float(got) == 16.0
    # on the CPU the chain runs eagerly: no capture, no replay
    assert fused.replays == 0 and fused.capture_s == []


def test_cpu_chain_runs_host_synchronising_stages_eagerly():
    fused = compile_torch_pipeline([lambda t: t * 2, lambda t: t + t.sum().item()])
    assert fused(torch.arange(4.0)).tolist() == [12.0, 14.0, 16.0, 18.0]


def _jax_cfg(name):
    if name == "tiny":
        return dataclasses.replace(JT.TINY, dtype=jnp.float32)
    return JT.TransformerConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                                max_seq_len=64, parallel_block=True, use_swiglu=False,
                                dtype=jnp.float32, remat=False)


def _port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JT.TransformerConfig)}
    fields["dtype"] = torch.float32
    return PT.TransformerConfig(**fields)


@pytest.mark.parametrize("name", ["tiny", "gptj_block"])
def test_forward_stages_pipeline_equals_forward(name):
    jcfg = _jax_cfg(name)
    cfg = _port_cfg(jcfg)
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(0)
    jp = {k: (1.0 + 0.1 * rs.randn(*sd.shape) if "norm" in k else
              rs.randn(*sd.shape) / np.sqrt(sd.shape[-2] if len(sd.shape) > 1 else 1))
          .astype(np.float32) for k, sd in sorted(shapes.items())}
    tp = params_from_jax(jp, device="cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 24)).astype(np.int64)
    stages = PT.forward_stages(tp, cfg)
    assert len(stages) == cfg.n_layers + 2
    got = compile_torch_pipeline(stages)(torch.from_numpy(toks))
    assert torch.equal(got, PT.forward(tp, torch.from_numpy(toks), cfg))
    want = np.asarray(JT.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_graph_capture_is_a_compile_event_of_the_step_plane():
    from ray_tpu_torch._private import stepplane

    timer = stepplane.StepTimer("capture", 0, 1, warmup=0)
    timer.note_compile("cuda_graph_capture", 0.25)
    assert timer._compile == 0.25
    assert timer._compile_events == 1 and timer._recompiled
