"""The port's ``llm_deployment`` on its own serve library, on the CPU, at
``TINY_MODEL`` and ``tests/test_llm_serve.py``'s ``SMALL_ENGINE``: streamed
and unary tokens against a local port engine, a replica on JAX's weights
against JAX's ``LLMServer`` run in this process (fp32, exact tokens), typed
KV sheds through the handle and as 503s over HTTP, the telemetry series, the
TTFT fold in ``serve.status()``, and the engines' counters held against the
reference engine's on one request sequence.

Only the port's runtime starts; no reference replica runs. The HTTP proxy is
made on port 0. Deployment classes and weight loaders are defined inside
functions, so replicas unpickle them by value and never import this module
(which imports JAX). Every wait is bounded by ``T``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.serve.llm.deployment import LLMServer as JLLMServer  # noqa: E402
from ray_tpu.serve.llm.deployment import _resolve_model_cfg as j_resolve  # noqa: E402
from ray_tpu.serve.llm.engine import EngineConfig as JEngineConfig  # noqa: E402
from ray_tpu.serve.llm.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch.models.transformer import init_params  # noqa: E402
from ray_tpu_torch.serve.llm import (  # noqa: E402
    TINY_MODEL,
    EngineConfig,
    InferenceEngine,
    LLMServer,
    llm_deployment,
)
from ray_tpu_torch.serve.llm.deployment import _resolve_model_cfg  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402
from test_torch_transformer import numpy_params  # noqa: E402

T = 30  # every wait's timeout, in seconds
SMALL_ENGINE = dict(block_size=4, num_blocks=128, max_batch=3, max_blocks_per_seq=16,
                    max_waiting=16)
# a pool of 8 usable blocks, one decode slot, no waiting room: sheds early
TINY_POOL = dict(block_size=4, num_blocks=9, max_batch=1, max_blocks_per_seq=8,
                 max_waiting=0, retry_after_s=3.0)
PROMPTS = [[5, 11, 23, 42], [7, 3, 300, 2, 9, 81, 5], [1, 2, 3]]


def _jax_weights_server(jp):
    """An ``LLMServer`` on carried JAX weights that also reports which
    modules its process imported."""

    class Server(LLMServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, params_loader=lambda cfg: params_from_jax(jp, device="cpu"),
                             **kw)

        def foreign_modules(self):
            import sys

            return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))

    return Server


@pytest.fixture(scope="module")
def llm():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, _system_config={"prestart_workers": False})
    try:
        from ray_tpu_torch.serve._proxy import _PROXY_NAME, HTTPProxy

        proxy = HTTPProxy.options(name=_PROXY_NAME, num_cpus=0).remote(0)
        jp = numpy_params(j_resolve(TINY_MODEL), seed=3)
        serve.run(llm_deployment(TINY_MODEL, SMALL_ENGINE, device="cpu",
                                 health_check_period_s=0.5), name="llm")
        serve.run(serve.deployment(_jax_weights_server(jp), name="jw").bind(
            TINY_MODEL, SMALL_ENGINE, device="cpu"), name="jw")
        serve.run(llm_deployment(TINY_MODEL, TINY_POOL, device="cpu", deployment_name="tiny",
                                 max_ongoing_requests=32), name="tiny", route_prefix="/tiny")
        yield {"jp": jp, "http": tuple(ray_tpu_torch.get(proxy.address.remote(), timeout=T))}
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_stream_and_unary_equal_a_local_port_engine(llm):
    h = serve.get_app_handle("llm")
    stream = h.options(stream=True, stream_item_timeout_s=T)
    streamed = [list(stream.generate.remote(p, max_new_tokens=8)) for p in PROMPTS]
    cfg = _resolve_model_cfg(TINY_MODEL)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    local = InferenceEngine(params, cfg, EngineConfig(**SMALL_ENGINE), device="cpu")
    try:
        want = [local.submit(p, max_new_tokens=8).tokens() for p in PROMPTS]
    finally:
        local.shutdown()
    assert streamed == want and all(len(s) == 8 for s in want)
    assert h.remote(PROMPTS[0], max_new_tokens=8).result(timeout_s=T) == want[0]
    stats = h.kv_stats.remote().result(timeout_s=T)
    assert stats["blocks_total"] == 127 and stats["blocks_free"] == 127


def test_jax_weights_stream_equals_jax_llm_server(llm):
    """fp32, exact token equality with JAX's ``LLMServer`` in this process."""
    jsrv = JLLMServer(TINY_MODEL, SMALL_ENGINE, params_loader=lambda cfg: llm["jp"])
    h = serve.get_app_handle("jw").options(stream=True, stream_item_timeout_s=T)
    try:
        for p in PROMPTS:
            want = list(jsrv.generate(p, max_new_tokens=8))
            assert list(h.generate.remote(p, max_new_tokens=8)) == want
    finally:
        jsrv._engine.shutdown()


def test_replica_imports_no_jax(llm):
    assert serve.get_app_handle("jw").foreign_modules.remote().result(timeout_s=T) == []


def test_kv_exhaustion_sheds_typed_through_the_handle(llm):
    h = serve.get_app_handle("tiny").options(stream=True, stream_item_timeout_s=T)
    ok, shed, other = [], [], []
    lock = threading.Lock()

    def client():
        try:
            out = list(h.generate.remote([7, 9, 2, 4, 6, 8], max_new_tokens=8))
            with lock:
                ok.append(len(out))
        except serve.DeploymentOverloadedError as e:
            with lock:
                shed.append(e.retry_after_s)
        except Exception as e:  # noqa: BLE001 — any other failure is the finding
            with lock:
                other.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=client) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
    assert not any(t.is_alive() for t in threads), "a client hung"
    assert not other, other[:3]
    assert shed and ok and set(ok) == {8} and set(shed) == {3.0}
    assert time.monotonic() - t0 < 25


def test_kv_exhaustion_is_503_with_retry_after_over_http(llm):
    host, port = llm["http"]
    body = json.dumps({"prompt": [5, 3, 1, 2, 4, 6], "max_new_tokens": 6}).encode()
    results = []
    lock = threading.Lock()

    def post():
        req = urllib.request.Request(f"http://{host}:{port}/tiny", data=body,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=T) as r:
                got = (r.status, None, len(json.loads(r.read())["result"]))
        except urllib.error.HTTPError as e:
            got = (e.code, e.headers.get("Retry-After"), None)
        with lock:
            results.append(got)

    threads = [threading.Thread(target=post) for _ in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
    assert len(results) == 10
    assert {s for s, _, _ in results} == {200, 503}, results
    assert {n for s, _, n in results if s == 200} == {6}
    assert {ra for s, ra, _ in results if s == 503} == {"3"}


def test_series_and_ttft_fold(llm):
    h = serve.get_app_handle("llm").options(stream=True, stream_item_timeout_s=T)
    for _ in range(3):
        list(h.generate.remote([3, 1, 4], max_new_tokens=4))
    deadline = time.monotonic() + T
    snap = None
    while time.monotonic() < deadline:
        snap = serve.status()["llm"]["llm"]["ttft"]
        if snap and snap.get("count", 0) >= 1 and snap.get("p99") is not None:
            break
        time.sleep(0.25)
    assert snap and 0 < snap["p99"] < 60_000, snap
    from ray_tpu_torch.util.metrics import prometheus_text

    text = prometheus_text()
    for series in ("ray_tpu_torch_kv_blocks_total", "ray_tpu_torch_kv_blocks_free",
                   "ray_tpu_torch_kv_occupancy_ratio", "ray_tpu_torch_llm_running_seqs",
                   "ray_tpu_torch_llm_waiting_requests", "ray_tpu_torch_llm_tokens_total",
                   "ray_tpu_torch_llm_shed_total", "ray_tpu_torch_llm_decode_step_ms",
                   "ray_tpu_torch_serve_ttft_ms", "ray_tpu_torch_serve_requests_total"):
        assert series in text, f"{series} missing"


def _counter(metrics_module, name, **tags):
    key = json.dumps(tags, sort_keys=True)
    return metrics_module._local.get(name, {}).get(key, 0.0)


def test_engine_counters_equal_the_reference_engine():
    """One request sequence through both engines in this process (a shed, a
    long request, a short one): equal tokens per phase, sheds and kv_stats."""
    import ray_tpu.util.metrics as jm
    import ray_tpu_torch.util.metrics as pm
    from ray_tpu.serve.exceptions import DeploymentOverloadedError as JShed
    from ray_tpu_torch.serve.exceptions import DeploymentOverloadedError as PShed

    jp = numpy_params(j_resolve(TINY_MODEL), seed=5)
    engines = {
        "ref": (JInferenceEngine(jp, j_resolve(TINY_MODEL), JEngineConfig(**TINY_POOL),
                                 deployment="counters"), JShed, jm, "ray_tpu_"),
        "port": (InferenceEngine(params_from_jax(jp, device="cpu"), _resolve_model_cfg(TINY_MODEL),
                                 EngineConfig(**TINY_POOL), deployment="counters",
                                 device="cpu"), PShed, pm, "ray_tpu_torch_"),
    }
    out = {}
    for key, (eng, shed_cls, metrics, prefix) in engines.items():
        try:
            tokens, sheds = [], 0
            held = eng.submit([1] * 6, max_new_tokens=20)  # reserves 7 of 8 blocks
            for prompt in ([2] * 6, [3] * 2):
                try:
                    eng.submit(prompt, max_new_tokens=20)
                except shed_cls:
                    sheds += 1
            tokens.append(held.tokens())
            tokens.append(eng.submit([4, 5, 6], max_new_tokens=5).tokens())
            counts = {phase: _counter(metrics, prefix + "llm_tokens_total",
                                      deployment="counters", phase=phase)
                      for phase in ("prefill", "decode")}
            out[key] = (tokens, sheds, counts,
                        _counter(metrics, prefix + "llm_shed_total", deployment="counters"),
                        eng.kv_stats())
        finally:
            eng.shutdown()
    assert out["port"] == out["ref"]
    tokens, sheds, counts, shed_total, _ = out["port"]
    assert sheds == shed_total == 2 and counts == {"prefill": 9.0, "decode": 25.0}


def test_memplane_registry_lets_a_shut_down_engine_go():
    """The memplane's KV registry holds an engine's ``kv_stats`` weakly: a
    shut-down, dropped engine frees its weights and pool, and the next sweep
    forgets it (a strong reference kept a 7B driver engine alive on the card)."""
    import gc
    import weakref

    from ray_tpu_torch._private import memplane

    cfg = _resolve_model_cfg(TINY_MODEL)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = InferenceEngine(params, cfg, EngineConfig(**SMALL_ENGINE), deployment="gone",
                          device="cpu")
    assert memplane.collect_device_metrics() and "gone" in memplane._kv_providers
    eng.shutdown()
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None
    memplane.collect_device_metrics()
    assert "gone" not in memplane._kv_providers
