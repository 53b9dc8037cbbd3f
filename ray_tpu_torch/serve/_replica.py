"""Replica actor: wraps the user's deployment callable.

Parity: ``python/ray/serve/_private/replica.py`` — executes requests against
the user class/function; threaded so concurrent requests overlap, with an
internal gate at ``max_ongoing_requests`` so the entered-thread count is a
true queued+running depth (the autoscaling metric,
``_private/autoscaling_state.py``); streaming responses via generator
methods (``_private/proxy_response_generator.py``); model multiplexing via a
per-replica LRU (``python/ray/serve/multiplex.py:1``).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List

import cloudpickle

import ray_tpu_torch

_request_ctx = threading.local()

# replica-side telemetry (parity: serve's autoscaling/latency metrics,
# ray_serve_replica_processing_queries / ray_serve_deployment_processing_
# latency_ms). Lazy module-level singletons: records are local dict updates
# batched by the telemetry plane — cheap enough for the request hot path.
_metrics: dict = {}


def _replica_metrics() -> dict:
    if not _metrics:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        _metrics["queue_depth"] = Gauge(
            "ray_tpu_torch_serve_replica_queue_depth",
            "queued + running requests on one replica (autoscaling metric)",
            tag_keys=("deployment",),
        )
        _metrics["latency"] = Histogram(
            "ray_tpu_torch_serve_request_latency_ms",
            "end-to-end request execution latency per deployment",
            # default sub-ms..10s grid (metrics.DEFAULT_HISTOGRAM_BOUNDARIES)
            # so fast direct-path requests resolve; override per metric via
            # configure_histogram_boundaries or RAY_TPU_TORCH_HIST_BUCKETS_*
            tag_keys=("deployment", "method"),
        )
        _metrics["requests"] = Counter(
            "ray_tpu_torch_serve_requests_total",
            "requests executed per deployment",
            tag_keys=("deployment", "method"),
        )
        _metrics["ttft"] = Histogram(
            "ray_tpu_torch_serve_ttft_ms",
            "streaming time-to-first-token per deployment (request "
            "admitted -> first item yielded) — the stream-TTFT SLO input",
            tag_keys=("deployment", "method"),
        )
    return _metrics


def get_multiplexed_model_id() -> str:
    """Parity: ``serve.get_multiplexed_model_id`` — valid inside a request."""
    return getattr(_request_ctx, "multiplexed_model_id", "")


class _MultiplexCache:
    """Per-replica LRU of loaded models (parity: _ModelMultiplexWrapper)."""

    def __init__(self, loader, max_models: int):
        self._loader = loader
        self._max = max_models
        self._models: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, model_id: str):
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
        model = self._loader(model_id)
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            while len(self._models) > self._max:
                self._models.popitem(last=False)
        return model

    def model_ids(self) -> List[str]:
        with self._lock:
            return list(self._models)


def multiplexed(func=None, *, max_num_models_per_replica: int = 3):
    """Decorator wrapping a model-loader method with a per-replica LRU
    (parity: ``serve.multiplexed``): ``self.get_model(model_id)`` loads at
    most once per cached model and evicts beyond the limit."""

    def wrap(f):
        import functools

        @functools.wraps(f)
        def wrapper(owner, model_id):
            caches = getattr(owner, "__serve_mux_caches__", None)
            if caches is None:
                caches = {}
                object.__setattr__(owner, "__serve_mux_caches__", caches)
            cache = caches.get(f.__name__)
            if cache is None:
                cache = caches[f.__name__] = _MultiplexCache(
                    lambda mid: f(owner, mid), max_num_models_per_replica
                )
            return cache.get(model_id)

        wrapper.__serve_multiplexed__ = True
        wrapper.__serve_multiplex_max__ = max_num_models_per_replica
        return wrapper

    return wrap(func) if func is not None else wrap


@ray_tpu_torch.remote
class Replica:
    def __init__(self, callable_blob: bytes, init_args, init_kwargs,
                 max_ongoing: int = 8, user_config=None, deployment: str = ""):
        self._deployment = deployment
        # nested DeploymentHandles (model composition) arrive pre-resolved
        # inside init_args/kwargs
        target = cloudpickle.loads(callable_blob)
        if isinstance(target, type):
            self._callable = target(*init_args, **init_kwargs)
        elif init_args or init_kwargs:
            import functools

            self._callable = functools.partial(target, *init_args, **init_kwargs)
        else:
            self._callable = target
        self._gate = threading.Semaphore(max_ongoing)
        self._ongoing = 0
        self._ongoing_lock = threading.Lock()
        self._direct_lock = threading.Lock()
        # DRAINING: set once by prepare_drain(); new dispatches are rejected
        # with ReplicaDrainingError BEFORE entering the gate (so they never
        # count as accepted work), while in-flight requests — including open
        # streams and websocket sessions — run to completion
        self._draining = False
        self._replica_id_hex = ""
        if user_config is not None:
            self.reconfigure(user_config)

    def _replica_id(self) -> str:
        if not self._replica_id_hex:
            try:
                from ray_tpu_torch._private.worker import get_runtime

                rid = getattr(get_runtime(), "_actor_id", None)
                self._replica_id_hex = rid.hex() if rid else ""
            except Exception:
                pass
        return self._replica_id_hex

    def _reject_if_draining(self):
        if self._draining:
            from ray_tpu_torch.serve.exceptions import ReplicaDrainingError

            raise ReplicaDrainingError(self._deployment, self._replica_id())

    def prepare_drain(self) -> int:
        """Enter DRAINING: reject new dispatches, finish in-flight work.
        Returns the current ongoing count so the controller can log how
        much work the drain is waiting on. Idempotent. The flag flips under
        the ongoing lock: after this returns, every dispatch either already
        counts in ``num_ongoing`` or will be rejected — the controller's
        (draining AND idle) check is race-free."""
        with self._ongoing_lock:
            self._draining = True
            return self._ongoing

    def is_draining(self) -> bool:
        return self._draining

    def drain_status(self):
        """(draining, ongoing) read atomically — the drain loop's idle-kill
        predicate."""
        with self._ongoing_lock:
            return (self._draining, self._ongoing)

    def reconfigure(self, user_config) -> bool:
        """Apply a user_config without restarting the replica (parity: the
        deployment ``reconfigure`` contract, serve deployment docs /
        ``deployment_state.py`` lightweight-update path)."""
        fn = getattr(self._callable, "reconfigure", None)
        if callable(fn):
            fn(user_config)
        return True

    def _enter(self, model_id: str) -> float:
        """Admit one request; returns the replica-queue wait in ms (time
        spent gated behind max_ongoing — the serve span's queue stage)."""
        import time as _time

        with self._ongoing_lock:
            # checked under the SAME lock prepare_drain flips the flag
            # under: a request either counts in num_ongoing before the
            # drain begins, or is rejected — never a silent in-between the
            # drain loop's idle-kill could tear
            if self._draining:
                from ray_tpu_torch.serve.exceptions import ReplicaDrainingError

                raise ReplicaDrainingError(self._deployment, self._replica_id_hex)
            self._ongoing += 1
            depth = self._ongoing
        self._record_depth(depth)
        t0 = _time.perf_counter()
        self._gate.acquire()
        queue_wait_ms = (_time.perf_counter() - t0) * 1e3
        _request_ctx.multiplexed_model_id = model_id
        return queue_wait_ms

    def _exit(self):
        self._gate.release()
        _request_ctx.multiplexed_model_id = ""
        with self._ongoing_lock:
            self._ongoing -= 1
            depth = self._ongoing
        self._record_depth(depth)

    def _record_depth(self, depth: int) -> None:
        try:
            _replica_metrics()["queue_depth"].set(
                float(depth), tags={"deployment": self._deployment}
            )
        except Exception:
            pass  # metrics never fail a request

    def _record_latency(self, method: str, seconds: float) -> None:
        try:
            tags = {"deployment": self._deployment, "method": method}
            m = _replica_metrics()
            m["latency"].observe(seconds * 1e3, tags=tags)
            m["requests"].inc(tags=tags)
        except Exception:
            pass
        try:
            # sliding-window sample with the request's trace id as exemplar
            # (aggregated per-deployment by the controller)
            from ray_tpu_torch.util.tracing import current_trace_id

            win = getattr(self, "_latency_win", None)
            if win is None:
                from ray_tpu_torch._private.telemetry import LatencyWindow
                from ray_tpu_torch._private.worker import get_runtime

                window_s = float(
                    getattr(get_runtime().config, "latency_window_s", 60.0)
                )
                win = self._latency_win = LatencyWindow(window_s=window_s)
            win.observe(seconds * 1e3, current_trace_id())
        except Exception:
            pass

    def latency_samples(self, max_n: int = 512):
        """Raw in-window (ts, latency_ms, trace_id) samples — the
        controller folds every replica's into the per-deployment
        p50/p95/p99 series surfaced by serve.status()."""
        win = getattr(self, "_latency_win", None)
        if win is None:
            return []
        return win.raw()[-int(max_n):]

    def _record_ttft(self, ttft_ms: float) -> None:
        """Sliding-window TTFT sample (streaming responses only) — folded
        per-deployment by the controller, where it doubles as the
        TTFT-driven autoscaling signal (``target_ttft_ms``)."""
        try:
            from ray_tpu_torch.util.tracing import current_trace_id

            win = getattr(self, "_ttft_win", None)
            if win is None:
                from ray_tpu_torch._private.telemetry import LatencyWindow
                from ray_tpu_torch._private.worker import get_runtime

                window_s = float(
                    getattr(get_runtime().config, "latency_window_s", 60.0)
                )
                win = self._ttft_win = LatencyWindow(window_s=window_s)
            win.observe(ttft_ms, current_trace_id())
        except Exception:
            pass

    def ttft_samples(self, max_n: int = 512):
        """Raw in-window (ts, ttft_ms, trace_id) stream-TTFT samples."""
        win = getattr(self, "_ttft_win", None)
        if win is None:
            return []
        return win.raw()[-int(max_n):]

    def _record_failure(self, method: str, error: BaseException) -> None:
        """Ship a request failure into the cluster event log (forensics
        plane) so ``list_cluster_events`` covers the serving path, not just
        core tasks. Rides the telemetry batch pipeline; never fails (or
        delays) the request path."""
        try:
            from ray_tpu_torch._private.telemetry import record_cluster_event
            from ray_tpu_torch._private.worker import get_runtime

            rt = get_runtime()
            replica_id = getattr(rt, "_actor_id", None)
            record_cluster_event(
                "REPLICA_REQUEST_FAILED",
                f"deployment {self._deployment or '?'}.{method} raised "
                f"{type(error).__name__}: {error}",
                severity="ERROR",
                source="SERVE",
                deployment=self._deployment,
                method=method,
                error_type=type(error).__name__,
                replica_id=replica_id.hex() if replica_id else None,
            )
        except Exception:
            pass

    def is_asgi(self) -> bool:
        """Whether this deployment mounts an ASGI app (serve.ingress)."""
        return getattr(self._callable, "__serve_asgi_app__", None) is not None

    def direct_address(self):
        """Start (once) and return the direct data-plane endpoint: proxies
        dial it and keep the connection for every subsequent request
        (parity: the proxy->replica gRPC channel, bypassing the control
        plane per request)."""
        with self._direct_lock:  # threaded actor: one listener, one port
            srv = getattr(self, "_direct_server", None)
            if srv is None:
                from ray_tpu_torch._private.worker import get_runtime
                from ray_tpu_torch.serve._direct import DirectReplicaServer

                key = get_runtime().config.auth_key.encode()
                srv = self._direct_server = DirectReplicaServer(self, key)
            # one node: proxies dial the replica on loopback
            return ("127.0.0.1", srv.port)

    def handle_request(self, method: str, args: List, kwargs: Dict, model_id: str = ""):
        import time as _time

        from ray_tpu_torch._private.profiling import traced_section

        self._reject_if_draining()
        queue_wait_ms = self._enter(model_id)
        t0 = _time.perf_counter()
        try:
            with traced_section(
                f"serve:replica:{self._deployment}.{method}",
                {
                    "deployment": self._deployment,
                    "method": method,
                    "replica_id": self._replica_id(),
                    "queue_wait_ms": round(queue_wait_ms, 3),
                },
            ):
                if method == "__call__":
                    return self._callable(*args, **kwargs)
                return getattr(self._callable, method)(*args, **kwargs)
        except BaseException as e:
            self._record_failure(method, e)
            raise
        finally:
            self._record_latency(method, _time.perf_counter() - t0)
            self._exit()

    def handle_request_streaming(self, method: str, args: List, kwargs: Dict, model_id: str = ""):
        """Generator execution: items stream back as they are yielded
        (parity: streaming responses, _private/proxy_response_generator.py).
        The reserved ``__asgi__`` method drives the mounted ASGI app and
        streams its response events."""
        import time as _time

        from ray_tpu_torch._private.profiling import traced_section

        self._reject_if_draining()
        queue_wait_ms = self._enter(model_id)
        t0 = _time.perf_counter()
        try:
            with traced_section(
                f"serve:replica:{self._deployment}.{method}",
                {
                    "deployment": self._deployment,
                    "method": method,
                    "replica_id": self._replica_id(),
                    "queue_wait_ms": round(queue_wait_ms, 3),
                },
            ) as span_extras:
                items = 0
                if method == "__asgi__":
                    from ray_tpu_torch.serve._asgi import run_asgi_request

                    app = getattr(self._callable, "__serve_asgi_app__")
                    scope, body = args
                    gen = run_asgi_request(
                        app, scope, body, instance=self._callable
                    )
                else:
                    fn = (
                        self._callable
                        if method == "__call__"
                        else getattr(self._callable, method)
                    )
                    gen = fn(*args, **kwargs)
                for item in gen:
                    if items == 0:
                        # TTFT: request admitted -> first item yielded (the
                        # streaming span's headline stage)
                        ttft_ms = round((_time.perf_counter() - t0) * 1e3, 3)
                        span_extras["ttft_ms"] = ttft_ms
                        try:
                            _replica_metrics()["ttft"].observe(
                                ttft_ms,
                                tags={
                                    "deployment": self._deployment,
                                    "method": method,
                                },
                            )
                        except Exception:
                            pass
                        self._record_ttft(ttft_ms)
                    items += 1
                    yield item
                span_extras["stream_items"] = items
        except GeneratorExit:
            raise  # consumer stopped early: not a request failure
        except BaseException as e:
            self._record_failure(method, e)
            raise
        finally:
            # stream duration: entry to last yield (parity: serve counts a
            # streaming response until its generator finishes)
            self._record_latency(method, _time.perf_counter() - t0)
            self._exit()

    def handle_websocket(self, conn, scope) -> None:
        """One websocket session over a dedicated direct-plane connection
        (parity: the reference proxies websocket ASGI scopes through
        uvicorn, ``python/ray/serve/_private/proxy.py``). Counts toward
        ongoing-request depth for its whole lifetime, so autoscaling sees
        live sessions as load."""
        app = getattr(self._callable, "__serve_asgi_app__", None)
        if app is None:
            raise TypeError("deployment does not mount an ASGI app")
        self._reject_if_draining()
        from ray_tpu_torch.serve._ws import run_asgi_websocket

        self._enter("")
        try:
            run_asgi_websocket(app, scope, conn, instance=self._callable)
        except BaseException as e:
            self._record_failure("__websocket__", e)
            raise
        finally:
            self._exit()

    def num_ongoing(self) -> int:
        """Queued + running requests (autoscaling metric)."""
        with self._ongoing_lock:
            return self._ongoing

    def multiplexed_model_ids(self) -> List[str]:
        out: List[str] = []
        caches = getattr(self._callable, "__serve_mux_caches__", None) or {}
        for cache in caches.values():
            out.extend(cache.model_ids())
        return out

    def check_health(self) -> bool:
        user_check = getattr(self._callable, "check_health", None)
        if callable(user_check):
            user_check()
        return True


# Expose the raw class under an importable name so cloudpickle serializes it
# by reference (the module attribute ``Replica`` is the ActorClass wrapper;
# without this the class pickles by value and drags module globals — e.g.
# the request-context threading.local — into the pickle).
_ReplicaImpl = Replica._cls
_ReplicaImpl.__qualname__ = "_ReplicaImpl"
