"""The port's ``LLMServer`` on ``TINY_MODEL``, on the CPU: its streams
against the port's engine on the same seeded weights and against the JAX
``LLMServer`` on carried weights, the proxy's dict convention, a typed shed
before the first token, health and KV stats."""

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ray_tpu.serve.llm.deployment import LLMServer as JLLMServer  # noqa: E402
from ray_tpu.serve.llm.deployment import _resolve_model_cfg as j_resolve  # noqa: E402
from ray_tpu_torch.models.transformer import init_params  # noqa: E402
from ray_tpu_torch.serve.exceptions import DeploymentOverloadedError  # noqa: E402
from ray_tpu_torch.serve.llm import (  # noqa: E402
    TINY_MODEL,
    EngineConfig,
    InferenceEngine,
    LLMServer,
)
from ray_tpu_torch.serve.llm.deployment import _resolve_engine_cfg, _resolve_model_cfg  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402
from test_torch_transformer import numpy_params  # noqa: E402

# tests/test_llm_serve.py's engine
SMALL_ENGINE = dict(block_size=4, num_blocks=128, max_batch=3, max_blocks_per_seq=16,
                    max_waiting=16)
PROMPTS = [[5, 11, 23, 42], [7, 3, 300, 2, 9, 81, 5], [1, 2, 3]]


@pytest.fixture
def server():
    srv = LLMServer(TINY_MODEL, SMALL_ENGINE, deployment="tiny", device="cpu")
    yield srv
    srv.engine.shutdown()


def test_resolve_configs():
    cfg = _resolve_model_cfg(TINY_MODEL)
    assert cfg.dtype == torch.float32 and cfg.kv_heads == 2 and cfg.vocab_size == 512
    assert _resolve_model_cfg(None) == cfg and _resolve_model_cfg(cfg) is cfg
    assert _resolve_model_cfg({**TINY_MODEL, "dtype": "bfloat16"}).dtype == torch.bfloat16
    for bad in ("Tensor", "no_such_dtype"):  # an attribute of torch that is no dtype, none
        with pytest.raises(ValueError):
            _resolve_model_cfg({**TINY_MODEL, "dtype": bad})
    assert _resolve_engine_cfg(SMALL_ENGINE) == EngineConfig(**SMALL_ENGINE)
    assert _resolve_engine_cfg(None) == EngineConfig()


def test_stream_matches_port_engine_on_seeded_weights(server):
    cfg = _resolve_model_cfg(TINY_MODEL)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    local = InferenceEngine(params, cfg, EngineConfig(**SMALL_ENGINE), device="cpu")
    try:
        want = [local.submit(p, max_new_tokens=8).tokens() for p in PROMPTS]
    finally:
        local.shutdown()
    streams = [server.generate(p, max_new_tokens=8) for p in PROMPTS]
    assert [list(s) for s in streams] == want
    assert all(isinstance(t, int) for t in want[0])


def test_stream_matches_jax_llm_server():
    jp = numpy_params(j_resolve(TINY_MODEL), seed=3)
    jsrv = JLLMServer(TINY_MODEL, SMALL_ENGINE, params_loader=lambda cfg: jp)
    srv = LLMServer(TINY_MODEL, SMALL_ENGINE, device="cpu",
                    params_loader=lambda cfg: params_from_jax(jp, device="cpu"))
    try:
        for p in PROMPTS:
            assert list(srv.generate(p, max_new_tokens=8)) == list(
                jsrv.generate(p, max_new_tokens=8))
    finally:
        srv.engine.shutdown()
        jsrv._engine.shutdown()


def test_dict_convention_and_kv_stats(server):
    prompt = PROMPTS[1]
    want = list(server.generate(prompt, max_new_tokens=6))
    assert server({"prompt": prompt, "max_new_tokens": 6}) == want
    assert server(prompt, max_new_tokens=6) == want
    sampled = dict(prompt=prompt, max_new_tokens=6, temperature=0.9, top_k=5, seed=4)
    assert server(dict(sampled)) == server(dict(sampled))
    stats = server.kv_stats()
    assert stats["deployment"] == "tiny" and stats["blocks_total"] == 127
    assert stats["blocks_free"] == stats["blocks_total"]


def test_shed_is_typed_and_before_the_first_token():
    srv = LLMServer(TINY_MODEL, dict(block_size=4, num_blocks=9, max_batch=1,
                                     max_blocks_per_seq=8, max_waiting=0), device="cpu")
    try:
        held = srv.generate([1] * 6, max_new_tokens=20)  # reserves 7 of the 8 blocks
        with pytest.raises(DeploymentOverloadedError) as shed:
            srv.generate([2] * 6, max_new_tokens=20)  # raises at the call, nothing streamed
        assert shed.value.retry_after_s > 0 and shed.value.capacity == 8
        assert len(list(held)) == 20
    finally:
        srv.engine.shutdown()


def test_check_health(server):
    assert server.check_health() is True
    server.engine.shutdown()
    with pytest.raises(RuntimeError):
        server.check_health()


def test_cuda_server_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMServer(TINY_MODEL, SMALL_ENGINE)
