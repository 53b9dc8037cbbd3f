"""The LLM deployment class: one :class:`InferenceEngine` per replica.

Port of ``LLMServer`` in ``ray_tpu/serve/llm/deployment.py``.
``LLMServer.generate`` streams token ids; admission (and so any
``DeploymentOverloadedError`` shed) happens when it is called, before the
first token. Weights come from ``weight_seed`` through a seeded
``torch.Generator`` on the replica's device (their values differ from
JAX's for the same seed), or from ``params_loader``.

``llm_deployment`` binds ``LLMServer`` into the port's serve library
(``ray_tpu_torch.serve``): ``serve.run(llm_deployment(...))``. A replica on
the card asks for it with ``ray_actor_options={"num_gpus": 1}``; without the
resource a ``device="cuda"`` replica raises in its constructor, and
``serve.run`` with it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Union

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig, init_params
from ray_tpu_torch.serve.llm.engine import EngineConfig, InferenceEngine

__all__ = ["LLMServer", "TINY_MODEL", "llm_deployment"]

# small-but-real geometry (GQA + swiglu exercised) usable on the CPU: the
# reference's default deployment
TINY_MODEL: Dict[str, Any] = {
    "vocab_size": 512,
    "d_model": 64,
    "n_layers": 2,
    "n_heads": 4,
    "n_kv_heads": 2,
    "d_ff": 128,
    "max_seq_len": 256,
    "dtype": "float32",
}


def _resolve_model_cfg(model_cfg) -> TransformerConfig:
    if model_cfg is None:
        model_cfg = TINY_MODEL
    if isinstance(model_cfg, TransformerConfig):
        return model_cfg
    cfg = dict(model_cfg)
    if isinstance(cfg.get("dtype"), str):
        dtype = getattr(torch, cfg["dtype"], None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {cfg['dtype']!r}")
        cfg["dtype"] = dtype
    return TransformerConfig(**cfg)


def _resolve_engine_cfg(engine_cfg) -> EngineConfig:
    if engine_cfg is None:
        return EngineConfig()
    if isinstance(engine_cfg, EngineConfig):
        return engine_cfg
    return EngineConfig(**dict(engine_cfg))


class LLMServer:
    """Deployment class wrapping the continuous-batching engine.

    Configs arrive as plain dicts (``dtype`` as a string) or as the
    dataclasses themselves. ``params_loader(cfg)`` returns the parameter
    dict on ``device``."""

    def __init__(
        self,
        model_cfg: Optional[Union[Dict, TransformerConfig]] = None,
        engine_cfg: Optional[Union[Dict, EngineConfig]] = None,
        *,
        weight_seed: int = 0,
        deployment: str = "llm",
        params_loader: Optional[Callable[[TransformerConfig], Any]] = None,
        device="cuda",
    ):
        dev = resolve_device(device)
        cfg = _resolve_model_cfg(model_cfg)
        if params_loader is not None:
            params = params_loader(cfg)
        else:
            gen = torch.Generator(device=dev).manual_seed(int(weight_seed))
            params = init_params(gen, cfg, device=dev)
        self._engine = InferenceEngine(
            params, cfg, _resolve_engine_cfg(engine_cfg), deployment=deployment, device=dev
        )

    @property
    def engine(self) -> InferenceEngine:
        """The replica's engine (its ``submit`` returns the token stream
        itself, with its TTFT)."""
        return self._engine

    def generate(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        eos_token: Optional[int] = None,
    ) -> Iterator[int]:
        """Stream generated token ids. Admission, and so any
        ``DeploymentOverloadedError`` shed, happens at call time, before the
        first yield."""
        stream = self._engine.submit(
            prompt,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            seed=seed,
            eos_token=eos_token,
        )

        def _iter():
            for tok in stream:
                yield int(tok)

        return _iter()

    def __call__(self, prompt, max_new_tokens: int = 16, **kw) -> list:
        """Unary convenience: the full completion as a token list. Takes a
        token sequence or the HTTP proxy's JSON convention
        (``{"prompt": [...], "max_new_tokens": ..., ...}`` as one arg)."""
        if isinstance(prompt, dict):
            payload = dict(prompt)
            tokens = payload.pop("prompt")
            max_new_tokens = payload.pop("max_new_tokens", max_new_tokens)
            kw = {**payload, **kw}
            prompt = tokens
        return list(self.generate(prompt, max_new_tokens, **kw))

    def kv_stats(self) -> Dict[str, Any]:
        return self._engine.kv_stats()

    def check_health(self) -> bool:
        thread = self._engine._thread
        if thread is None or not thread.is_alive():
            raise RuntimeError("inference engine loop is not running")
        return True

    def __del__(self):
        engine = getattr(self, "_engine", None)
        if engine is not None:
            engine.shutdown(timeout_s=1.0)


def llm_deployment(
    model_cfg: Optional[Dict] = None,
    engine_cfg: Optional[Dict] = None,
    *,
    deployment_name: str = "llm",
    device: str = "cuda",
    **serve_options,
):
    """Bound LLM application: ``serve.run(llm_deployment(...))``.

    ``device`` reaches each replica's ``LLMServer`` (whose weights come
    from seed 0, as in the reference); ``serve_options`` pass straight
    through to ``@serve.deployment`` (num_replicas, max_ongoing_requests,
    ray_actor_options, ...).
    ``max_ongoing_requests`` defaults to the engine's admission width
    (decode slots + waiting bound) so the replica gate and the KV-aware
    admission agree about capacity.
    """
    from ray_tpu_torch import serve

    ecfg = _resolve_engine_cfg(engine_cfg)
    serve_options.setdefault("name", deployment_name)
    serve_options.setdefault("max_ongoing_requests", ecfg.max_batch + ecfg.max_waiting)
    dep = serve.deployment(LLMServer, **serve_options)
    return dep.bind(model_cfg, engine_cfg, deployment=deployment_name, device=device)
