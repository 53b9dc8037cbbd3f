"""ASGI app mounting for Serve deployments.

Parity: ``serve.ingress(app)`` (``python/ray/serve/api.py``) — the reference
mounts FastAPI/Starlette apps on deployments and drives them from uvicorn
inside the proxy/replica. Here the proxy forwards the raw HTTP exchange
(scope + body) to the replica, which drives the ASGI protocol itself: the
app's ``send`` events stream back through the handle's streaming path, so
chunked/streaming responses flow end-to-end without buffering.

Any ASGI-3 callable works — FastAPI/Starlette if installed, or a plain

    async def app(scope, receive, send): ...
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Tuple


def ingress(asgi_app):
    """Class decorator mounting an ASGI app on a deployment.

    The decorated class's replicas answer HTTP through the app; other
    methods remain callable through the handle as usual. If the app wants
    the replica instance, it can read ``scope["extensions"]["serve_replica"]``.
    """

    def decorator(cls):
        cls.__serve_asgi_app__ = staticmethod(asgi_app)
        return cls

    return decorator


class ASGIApp:
    """Bare-app deployment target: ``serve.run(serve.deployment(ASGIApp).bind(app))``
    — or use :func:`ingress` on your own class."""

    def __init__(self, asgi_app):
        self.__serve_asgi_app__ = asgi_app


def run_asgi_request(
    asgi_app,
    scope: Dict[str, Any],
    body: bytes,
    instance: Any = None,
) -> Iterator[Tuple]:
    """Drive one request through an ASGI app, yielding response events.

    Yields ``("start", status, headers)`` once, then ``("body", bytes,
    more_body)`` until the app completes. The app runs on a private event
    loop in a helper thread so events stream as they are sent (a
    StreamingResponse's chunks arrive incrementally, not buffered).
    """
    import asyncio

    # bounded: a slow consumer (ultimately the HTTP client) must
    # backpressure the app's send, not buffer its stream in replica memory
    q: "queue.Queue" = queue.Queue(maxsize=64)
    abandoned = threading.Event()
    # rebuild bytes-pair headers (they cross the wire as lists)
    scope = dict(scope)
    scope["headers"] = [
        (bytes(k), bytes(v)) for k, v in scope.get("headers", [])
    ]
    scope.setdefault("type", "http")
    scope.setdefault("asgi", {"version": "3.0", "spec_version": "2.3"})
    ext = dict(scope.get("extensions") or {})
    ext["serve_replica"] = instance
    scope["extensions"] = ext

    def runner():
        consumed = False

        async def receive():
            nonlocal consumed
            if not consumed:
                consumed = True
                return {"type": "http.request", "body": body, "more_body": False}
            return {"type": "http.disconnect"}

        def put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=1.0)
                    return True
                except queue.Full:
                    continue
            return False

        async def send(event):
            if not put(event):
                raise RuntimeError("ASGI response consumer went away")

        try:
            asyncio.run(asgi_app(scope, receive, send))
            put(None)
        except BaseException as e:  # noqa: BLE001
            put(e)

    t = threading.Thread(target=runner, daemon=True, name="asgi-request")
    t.start()

    started = False
    try:
        while True:
            event = q.get()
            if event is None:
                if not started:
                    raise RuntimeError("ASGI app completed without a response")
                return
            if isinstance(event, BaseException):
                # before start: a clean 500 for the proxy to render; after
                # start: propagate so the proxy TRUNCATES the chunked stream
                # (a crash must never masquerade as a complete 200)
                raise event
            kind = event.get("type")
            if kind == "http.response.start":
                started = True
                headers: List[Tuple[bytes, bytes]] = [
                    (bytes(k), bytes(v)) for k, v in event.get("headers", [])
                ]
                yield ("start", int(event.get("status", 200)), headers)
            elif kind == "http.response.body":
                yield (
                    "body",
                    bytes(event.get("body", b"")),
                    bool(event.get("more_body", False)),
                )
                if not event.get("more_body", False):
                    return
    finally:
        # consumer gone (client disconnect) or complete: unblock the app
        # thread's bounded put so it can exit instead of leaking
        abandoned.set()
