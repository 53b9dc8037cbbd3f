"""Model serving library of the port (Ray Serve equivalent): a renamed copy
of ``ray_tpu/serve`` on the port's own runtime. Replicas ask for cards with
``ray_actor_options={"num_gpus": 1}``; the HTTP proxy's default port is not
the JAX package's, and a proxy that cannot bind its port raises.

Parity: ``python/ray/serve`` (SURVEY.md §2.4, §3.5) — control plane:
``ServeController`` actor reconciling deployments into replica actors
(``_private/controller.py:86``, ``deployment_state.py``); data plane:
``DeploymentHandle`` → power-of-two-choices replica routing
(``pow_2_scheduler.py:49``) → replica actors (threaded for concurrent
requests); HTTP proxy actor; dynamic batching (``batching.py``); model
composition via ``.bind()``.
"""

from ray_tpu_torch.serve._asgi import ASGIApp, ingress
from ray_tpu_torch.serve._replica import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.api import (
    delete,
    deployment,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    status,
)
from ray_tpu_torch.serve._grpc_proxy import grpc_predict, start_grpc_proxy
from ray_tpu_torch.serve._proxy import start_node_proxies
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.schema import (
    build,
    deploy_config,
    deploy_config_file,
    dump_config,
)
from ray_tpu_torch.serve.handle import (
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from ray_tpu_torch.serve.exceptions import (
    DeploymentOverloadedError,
    ReplicaDiedError,
    ReplicaDrainingError,
    RequestTimeoutError,
    ServeError,
)

__all__ = [
    "deployment",
    "run",
    "shutdown",
    "delete",
    "status",
    "get_app_handle",
    "get_deployment_handle",
    "batch",
    "build",
    "deploy_config",
    "deploy_config_file",
    "dump_config",
    "grpc_predict",
    "start_grpc_proxy",
    "start_node_proxies",
    "ingress",
    "ASGIApp",
    "multiplexed",
    "get_multiplexed_model_id",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "ServeError",
    "ReplicaDiedError",
    "ReplicaDrainingError",
    "DeploymentOverloadedError",
    "RequestTimeoutError",
    "llm",
]


def __getattr__(name):
    # the LLM plane imports the model family (torch, the kernels' wrappers);
    # load it only when asked for
    if name == "llm":
        import importlib

        mod = importlib.import_module("ray_tpu_torch.serve.llm")
        globals()["llm"] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

from ray_tpu_torch._private import usage as _usage

_usage.record_library_usage("serve")
del _usage
