"""Serve declarative config: build an app to a dict/YAML, deploy from it.

Parity: ``python/ray/serve/schema.py`` (ServeDeploySchema /
ServeApplicationSchema) and the ``serve build`` / ``serve deploy`` CLI flow —
an application is declared as an ``import_path`` (``module:bound_app``) plus
per-deployment overrides; deploying imports the bound graph, applies the
overrides, and hands it to ``serve.run``.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

_DEPLOYMENT_OVERRIDE_KEYS = (
    "num_replicas",
    "max_ongoing_requests",
    "ray_actor_options",
    "autoscaling_config",
    "health_check_period_s",
    "user_config",
    # resilience knobs (see Deployment docstring)
    "graceful_shutdown_timeout_s",
    "request_timeout_s",
    "request_retries",
    "shed_queue_factor",
    "shed_retry_after_s",
)


def build(app, *, import_path: str, name: str = "default",
          route_prefix: Optional[str] = None) -> Dict[str, Any]:
    """Produce the declarative config for a bound application (parity:
    ``serve build``). ``import_path`` must be "module:attr" pointing at the
    bound app — deploy re-imports it, so a config without one is undeployable."""
    from ray_tpu_torch.serve.api import Application, _flatten_graph

    if not isinstance(app, Application):
        raise TypeError("serve.build expects a bound deployment (use .bind())")
    if not import_path or ":" not in import_path:
        raise ValueError(
            f"import_path must be 'module:attribute', got {import_path!r}"
        )
    specs, _ = _flatten_graph(app)
    deployments: List[Dict[str, Any]] = []
    for spec in specs:
        d: Dict[str, Any] = {"name": spec["name"]}
        d["num_replicas"] = spec["num_replicas"]
        d["max_ongoing_requests"] = spec["max_ongoing_requests"]
        if spec.get("ray_actor_options"):
            d["ray_actor_options"] = spec["ray_actor_options"]
        if spec.get("autoscaling_config"):
            d["autoscaling_config"] = spec["autoscaling_config"]
        if spec.get("user_config") is not None:
            d["user_config"] = spec["user_config"]
        for knob, default in (
            ("graceful_shutdown_timeout_s", 20.0),
            ("request_timeout_s", 120.0),
            ("request_retries", 3),
            ("shed_queue_factor", 6.0),
            ("shed_retry_after_s", 1.0),
            ("health_check_period_s", 5.0),
        ):
            if spec.get(knob) is not None and spec[knob] != default:
                d[knob] = spec[knob]
        deployments.append(d)
    app_schema: Dict[str, Any] = {
        "name": name,
        "import_path": import_path,
        "deployments": deployments,
    }
    if route_prefix is not None:
        app_schema["route_prefix"] = route_prefix
    return {"applications": [app_schema]}


def _import_bound_app(import_path: str):
    if ":" not in import_path:
        raise ValueError(
            f"import_path must be 'module:attribute', got {import_path!r}"
        )
    module_name, attr = import_path.split(":", 1)
    module = importlib.import_module(module_name)
    app = module
    for part in attr.split("."):
        app = getattr(app, part)
    return app


def _apply_overrides(app, overrides: Dict[str, Dict[str, Any]]):
    """Rebuild the bound graph with per-deployment option overrides."""
    from ray_tpu_torch.serve.api import Application

    rebuilt: Dict[int, Application] = {}

    def visit(node):
        if not isinstance(node, Application):
            return node
        if id(node) in rebuilt:
            return rebuilt[id(node)]
        args = tuple(visit(a) for a in node.args)
        kwargs = {k: visit(v) for k, v in node.kwargs.items()}
        dep = node.deployment
        ov = overrides.get(dep.name)
        if ov:
            dep = dep.options(**{k: v for k, v in ov.items()
                                 if k in _DEPLOYMENT_OVERRIDE_KEYS})
        new = Application(dep, args, kwargs)
        rebuilt[id(node)] = new
        return new

    return visit(app)


def deploy_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Deploy every application in a config dict (parity: ``serve deploy`` /
    REST ``PUT /api/serve/applications``). Returns {app_name: handle}."""
    from ray_tpu_torch.serve import api as serve_api

    handles = {}
    for app_schema in config.get("applications", []):
        name = app_schema.get("name", "default")
        import_path = app_schema["import_path"]
        app = _import_bound_app(import_path)
        overrides = {
            d["name"]: d for d in app_schema.get("deployments", [])
        }
        app = _apply_overrides(app, overrides)
        handles[name] = serve_api.run(
            app, name=name, route_prefix=app_schema.get("route_prefix")
        )
    return handles


def deploy_config_file(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as fh:
        config = yaml.safe_load(fh)
    return deploy_config(config)


def dump_config(config: Dict[str, Any], path: Optional[str] = None) -> str:
    import yaml

    text = yaml.safe_dump(config, sort_keys=False)
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    return text
