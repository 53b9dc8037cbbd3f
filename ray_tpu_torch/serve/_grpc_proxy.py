"""gRPC ingress proxy actor.

Parity: the reference's gRPC proxy (``python/ray/serve/_private/proxy.py``
gRPCProxy + ``serve/grpc_util.py``): a second ingress protocol next to HTTP.
The service is defined with a generic handler (no protoc step): one unary
method ``/ray_tpu_torch.serve.ServeAPI/Predict`` whose request/response are pickled
payloads, with the target application selected by the ``application``
metadata key (the reference routes gRPC by application metadata the same
way).
"""

from __future__ import annotations

import hmac
import hashlib
import pickle
from typing import Dict, Optional

import ray_tpu_torch

_GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"
SERVICE_METHOD = "/ray_tpu_torch.serve.ServeAPI/Predict"
_SIG_LEN = 32


def _cluster_key() -> bytes:
    from ray_tpu_torch._private.worker import get_runtime

    return get_runtime().config.auth_key.encode()


def _sign(key: bytes, blob: bytes) -> bytes:
    return hmac.new(key, blob, hashlib.sha256).digest()


def _frame(key: bytes, obj) -> bytes:
    blob = pickle.dumps(obj)
    return _sign(key, blob) + blob


def _unframe(key: bytes, framed: bytes):
    """Verify the HMAC prefix before unpickling — pickles execute code, so
    an unauthenticated local process must never reach ``pickle.loads`` (the
    same reason every other socket in this codebase does challenge auth)."""
    sig, blob = framed[:_SIG_LEN], framed[_SIG_LEN:]
    if len(sig) != _SIG_LEN or not hmac.compare_digest(_sign(key, blob), sig):
        raise PermissionError("bad or missing cluster auth signature")
    return pickle.loads(blob)


@ray_tpu_torch.remote(max_concurrency=16)
class GRPCProxy:
    def __init__(self, port: int = 0):
        import grpc
        from concurrent import futures

        self._handles: Dict[str, object] = {}
        self._key = _cluster_key()
        proxy = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method != SERVICE_METHOD:
                    return None
                meta = dict(handler_call_details.invocation_metadata)
                app = meta.get("application", "default")

                def unary(request_bytes, context):
                    try:
                        payload = _unframe(proxy._key, request_bytes)
                    except PermissionError as e:
                        context.abort(
                            grpc.StatusCode.UNAUTHENTICATED, str(e)
                        )
                    try:
                        result = proxy._call(app, payload)
                        return _frame(proxy._key, {"result": result})
                    except Exception as e:  # noqa: BLE001
                        return _frame(proxy._key, {"error": repr(e)})

                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=None,  # raw bytes in/out
                    response_serializer=None,
                )

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")
        self._server.start()

    def _call(self, app: str, payload):
        from ray_tpu_torch import serve

        handle = self._handles.get(app)
        if handle is None:
            handle = serve.get_app_handle(app)
            self._handles[app] = handle
        from ray_tpu_torch import exceptions as exc

        try:
            return handle.remote(payload).result(timeout_s=60)
        except (exc.ActorDiedError, exc.GetTimeoutError):
            # replica set changed (redeploy/autoscale): refresh and retry
            # once. Application exceptions propagate unretried — replaying a
            # failed request would double non-idempotent side effects.
            self._handles.pop(app, None)
            handle = serve.get_app_handle(app)
            self._handles[app] = handle
            return handle.remote(payload).result(timeout_s=60)

    def invalidate(self, app: str):
        self._handles.pop(app, None)
        return True

    def get_port(self) -> int:
        return self.port

    def check_health(self) -> bool:
        return True


def start_grpc_proxy(port: int = 0):
    """Start (or fetch) the cluster's gRPC ingress; returns its port."""
    try:
        proxy = ray_tpu_torch.get_actor(_GRPC_PROXY_NAME)
    except ValueError:
        try:
            proxy = GRPCProxy.options(
                name=_GRPC_PROXY_NAME, num_cpus=0, max_concurrency=32
            ).remote(port)
        except ValueError:  # racing creator won
            proxy = ray_tpu_torch.get_actor(_GRPC_PROXY_NAME)
    return ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)


def grpc_predict(address: str, payload, *, application: str = "default",
                 timeout_s: float = 60.0):
    """Client helper: call the Serve gRPC ingress (HMAC-framed pickled
    unary; the caller must share the cluster auth key)."""
    import grpc

    key = _cluster_key()
    channel = grpc.insecure_channel(address)
    try:
        fn = channel.unary_unary(SERVICE_METHOD)
        reply = _unframe(
            key,
            fn(
                _frame(key, payload),
                metadata=(("application", application),),
                timeout=timeout_s,
            ),
        )
    finally:
        channel.close()
    if "error" in reply:
        raise RuntimeError(f"serve grpc call failed: {reply['error']}")
    return reply["result"]
