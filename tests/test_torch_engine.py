"""The port's continuous-batching engine, on the CPU: the cases of
``tests/test_llm_engine.py`` against the port, and greedy tokens against
the JAX ``InferenceEngine`` on the same carried weights (fp32 config).
"""

import dataclasses
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import transformer as JT  # noqa: E402
from ray_tpu.serve.llm.engine import EngineConfig as JEngineConfig  # noqa: E402
from ray_tpu.serve.llm.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from ray_tpu_torch.models import transformer as PT  # noqa: E402
from ray_tpu_torch.serve.exceptions import DeploymentOverloadedError  # noqa: E402
from ray_tpu_torch.serve.llm.engine import EngineConfig, InferenceEngine  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

CFG = JT.TransformerConfig(
    vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
    max_seq_len=128, dtype=jnp.float32,
)
PCFG = PT.TransformerConfig(
    **{f.name: getattr(CFG, f.name) for f in dataclasses.fields(JT.TransformerConfig)
       if f.name != "dtype"},
    dtype=torch.float32,
)
ECFG_KW = dict(block_size=4, num_blocks=64, max_batch=3, max_blocks_per_seq=16,
               max_waiting=16, stream_timeout_s=60.0)
ECFG = EngineConfig(**ECFG_KW)


@pytest.fixture(scope="module")
def jax_params():
    """Weights made with numpy in the reference's shapes (norms perturbed
    from one so that they matter)."""
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), CFG))
    rs = np.random.RandomState(0)
    return {
        k: (1.0 + 0.1 * rs.randn(*s.shape) if "norm" in k else 0.2 * rs.randn(*s.shape))
        .astype(np.float32)
        for k, s in sorted(shapes.items())
    }


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params, device="cpu")


@pytest.fixture
def engine(params):
    eng = InferenceEngine(params, PCFG, ECFG, deployment="test-llm", device="cpu")
    yield eng
    eng.shutdown()


def _prompts(n, lo=3, hi=13, seed=2):
    rs = np.random.RandomState(seed)
    return [list(rs.randint(1, CFG.vocab_size, size=rs.randint(lo, hi))) for _ in range(n)]


def test_continuous_matches_isolated_and_jax_engine(jax_params, params, engine):
    """Staggered arrivals + mixed lengths through the shared engine emit the
    same greedy tokens as each prompt decoded alone, and as the JAX engine
    on the same weights."""
    prompts = _prompts(7)
    solo = InferenceEngine(params, PCFG, ECFG, deployment="solo", device="cpu")
    try:
        alone = [solo.submit(p, max_new_tokens=9).tokens() for p in prompts]
    finally:
        solo.shutdown()
    streams = []
    for i, p in enumerate(prompts):
        streams.append(engine.submit(p, max_new_tokens=9))
        time.sleep(0.01 * (i % 3))  # stagger so cohorts genuinely mix
    assert [s.tokens() for s in streams] == alone
    jeng = JInferenceEngine(jax_params, CFG, JEngineConfig(**ECFG_KW), deployment="jax-ref")
    try:
        jstreams = [jeng.submit(p, max_new_tokens=9) for p in prompts]
        assert [s.tokens() for s in jstreams] == alone
    finally:
        jeng.shutdown()


def test_sampling_seeded_and_batch_invariant(engine):
    prompt = _prompts(1, seed=5)[0]
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=5, seed=123)
    alone = engine.submit(prompt, **kw).tokens()
    neighbours = [engine.submit(p, max_new_tokens=12) for p in _prompts(2, seed=6)]
    again = engine.submit(prompt, **kw).tokens()
    for s in neighbours:
        s.tokens()
    assert again == alone
    other = engine.submit(prompt, **dict(kw, seed=124)).tokens()
    assert other != alone or len(alone) <= 2


def test_greedy_default_unchanged_by_sampling_params(engine):
    prompt = _prompts(1, seed=9)[0]
    a = engine.submit(prompt, max_new_tokens=6).tokens()
    b = engine.submit(prompt, max_new_tokens=6, top_k=3, seed=77).tokens()
    assert a == b


def test_blocks_free_immediately_on_finish(engine):
    long_s = engine.submit(_prompts(1, seed=11)[0], max_new_tokens=40)
    short_s = engine.submit(_prompts(1, seed=12)[0], max_new_tokens=2)
    short_s.tokens()
    deadline = time.time() + 10
    saw_reclaim = False
    while time.time() < deadline:
        st = engine.kv_stats()
        if st["running"] == 1 and st["blocks_committed"] > 0:
            saw_reclaim = True
            break
        time.sleep(0.005)
    long_s.tokens()
    assert saw_reclaim, "short sequence's finish did not free its slot early"
    st = engine.kv_stats()
    assert st["blocks_free"] == st["blocks_total"]
    assert st["blocks_committed"] == 0


def test_kv_exhaustion_sheds_typed_never_hangs(params):
    eng = InferenceEngine(
        params, PCFG,
        EngineConfig(block_size=4, num_blocks=9, max_batch=2, max_blocks_per_seq=8,
                     max_waiting=1, stream_timeout_s=30.0),
        deployment="test-llm-tiny", device="cpu",
    )
    try:
        prompt = _prompts(1, seed=3)[0][:6]
        admitted, shed = [], []
        t0 = time.perf_counter()
        for _ in range(10):
            try:
                admitted.append(eng.submit(prompt, max_new_tokens=8))
            except DeploymentOverloadedError as e:
                shed.append(e)
        elapsed = time.perf_counter() - t0
        assert shed and admitted
        assert elapsed < 5.0, f"shedding took {elapsed:.1f}s — queued, not shed"
        for e in shed:
            assert e.retry_after_s > 0 and e.capacity == 8
        for s in admitted:
            assert len(s.tokens()) == 8
        st = eng.kv_stats()
        assert st["blocks_free"] == st["blocks_total"]
    finally:
        eng.shutdown()


def test_submit_rejects_bad_requests(engine):
    with pytest.raises(ValueError):
        engine.submit([1] * 100, max_new_tokens=1000)  # beyond the context
    with pytest.raises(ValueError):
        engine.submit([1, CFG.vocab_size], max_new_tokens=2)  # token outside the vocab
    with pytest.raises(ValueError):
        engine.submit([], max_new_tokens=2)


def test_eos_token_stops_early(engine):
    prompt = _prompts(1, seed=4)[0]
    first = engine.submit(prompt, max_new_tokens=5).tokens()[0]
    s = engine.submit(prompt, max_new_tokens=5, eos_token=first)
    assert s.tokens() == [first]
    assert s.finish_reason == "stop"


def test_shutdown_fails_streams_typed(params):
    eng = InferenceEngine(params, PCFG, ECFG, deployment="test-llm-down", device="cpu")
    streams = [eng.submit(p, max_new_tokens=50) for p in _prompts(3, seed=8)]
    eng.shutdown()
    outcomes = []
    for s in streams:
        try:
            s.tokens()
            outcomes.append("done")
        except RuntimeError:
            outcomes.append("typed")
        except TimeoutError:
            outcomes.append("hang")
    assert "hang" not in outcomes
    with pytest.raises(RuntimeError):
        eng.submit([1, 2], max_new_tokens=2)


def test_engine_params_must_lie_on_its_device(params):
    with pytest.raises(ValueError):
        InferenceEngine(params, PCFG, ECFG, device="meta", start=False)


def test_prefill_bucket_past_max_seq_len_matches_jax_engine(jax_params):
    """A prompt whose power-of-two prefill bucket (128) runs past a
    ``max_seq_len`` of 100: the padded rows' rotary positions lie beyond
    the tables. JAX clamps that gather; the port clamps the positions, and
    both emit the same tokens."""
    jcfg = dataclasses.replace(CFG, max_seq_len=100)
    pcfg = dataclasses.replace(PCFG, max_seq_len=100)
    kw = dict(ECFG_KW, max_blocks_per_seq=32)
    prompt = list(np.random.RandomState(1).randint(1, CFG.vocab_size, size=70))
    eng = InferenceEngine(params_from_jax(jax_params, device="cpu"), pcfg, EngineConfig(**kw),
                          deployment="bucket", device="cpu")
    try:
        got = eng.submit(prompt, max_new_tokens=5).tokens()
    finally:
        eng.shutdown()
    jeng = JInferenceEngine(jax_params, jcfg, JEngineConfig(**kw), deployment="jax-bucket")
    try:
        want = jeng.submit(prompt, max_new_tokens=5).tokens()
    finally:
        jeng.shutdown()
    assert want == [76, 86, 86, 3, 65]
    assert got == want
