"""HTTP proxy actor: the Serve data-plane ingress.

Parity: ``python/ray/serve/_private/proxy.py`` — per-node HTTP ingress
routing requests to application handles. The reference embeds uvicorn; here
an asyncio HTTP/1.1 server runs inside the actor (no extra deps) with:

* persistent (keep-alive) client connections;
* raw-bytes request/response passthrough (JSON remains the convention for
  ``application/json`` bodies, matching the handle protocol);
* ASGI app deployments (``serve.ingress``): the full scope + body forward
  to the replica, whose response events stream back through the handle's
  streaming path — chunked transfer out when the app streams;
* the proxy→replica hop rides the cluster's persistent actor channels (one
  connection per worker, reused for every request — the keep-alive
  equivalent of the reference's cached gRPC channels).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Dict, Optional, Tuple
from urllib.parse import unquote, urlsplit

import ray_tpu_torch
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.serve.exceptions import (
    DeploymentOverloadedError,
    ReplicaDiedError,
    RequestTimeoutError,
)

_PROXY_NAME = "SERVE_PROXY"
# not the JAX package's 8700: both packages can serve on one machine
DEFAULT_PORT = 8710
_MAX_BODY = 512 * 1024 * 1024


class _HeaderMap(dict):
    """Lowercase-keyed last-value dict for the proxy's own lookups, plus
    ``raw``: the full ordered (name, value) pair list so repeated headers
    survive into the ASGI scope (the spec passes every pair through)."""

    def __init__(self):
        super().__init__()
        self.raw = []

    def add(self, name: str, value: str) -> None:
        self.raw.append((name, value))
        self[name.lower()] = value


def _error_body(status: int, message: str) -> Tuple[int, bytes, str]:
    return status, json.dumps({"error": message}).encode(), "application/json"




def _retry_after_headers(e: DeploymentOverloadedError) -> Dict[str, str]:
    import math

    # getattr: a replica-raised shed may cross the task boundary as a
    # reconstructed instance without the attribute
    after = getattr(e, "retry_after_s", 1.0) or 1.0
    return {"Retry-After": str(max(1, int(math.ceil(after))))}


@ray_tpu_torch.remote(max_concurrency=16)
class HTTPProxy:
    def __init__(self, port: int = DEFAULT_PORT, bind_host: str = "127.0.0.1"):
        self.routes: Dict[str, str] = {}  # route_prefix -> app name
        self._handles: Dict[str, object] = {}
        self._stream_handles: Dict[str, object] = {}
        self._is_asgi: Dict[str, bool] = {}
        self._direct: Dict[str, object] = {}  # app -> DirectPool
        self.port = port
        # the address peers dial: this runtime is one node, so loopback
        self.host = "127.0.0.1"
        # handle calls block on ray_tpu_torch.get: they run here, off the loop
        self._pool = ThreadPoolExecutor(max_workers=64, thread_name_prefix="serve-http")
        self._loop = asyncio.new_event_loop()
        started = threading.Event()
        failed: list = []

        async def _start():
            self._server = await asyncio.start_server(
                self._handle_conn, bind_host, port, backlog=256
            )
            self.port = self._server.sockets[0].getsockname()[1]

        def _run_loop():
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(_start())
            except BaseException as e:  # the bind failed: the constructor raises it
                failed.append(e)
                return
            finally:
                started.set()
            self._loop.run_forever()

        threading.Thread(target=_run_loop, daemon=True, name="serve-http-loop").start()
        # a proxy whose listener did not bind raises instead of living on
        # without a server
        if not started.wait(30):
            raise TimeoutError(f"HTTP proxy did not bind {bind_host}:{port} in 30 s")
        if failed:
            raise OSError(f"HTTP proxy could not bind {bind_host}:{port}: {failed[0]}")

    # -- HTTP/1.1 ----------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    return
                if req == "bad-request":
                    await self._write_simple(
                        writer, *_error_body(400, "malformed request"), False
                    )
                    return
                method, target, headers, body, http11 = req
                conn_hdr = headers.get("connection", "").lower()
                keep = (http11 and conn_hdr != "close") or conn_hdr == "keep-alive"
                try:
                    conn_ok = await self._respond(
                        writer, method, target, headers, body, keep, reader
                    )
                except (ConnectionError, BrokenPipeError):
                    return
                if not keep or conn_ok is False:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader):
        """Parse one HTTP/1.1 request. Headers keep BOTH views: the full
        ordered (name, value) pair list (``.raw`` — repeated Cookie/Accept/
        X-Forwarded-For headers must reach the ASGI scope intact, per spec)
        and a lowercase-keyed last-value dict for the proxy's own
        Content-Length/Connection/Transfer-Encoding lookups."""
        try:
            line = await reader.readline()
        except (ConnectionError, asyncio.LimitOverrunError):
            return None
        if not line:
            return None
        try:
            method, target, version = line.decode("latin1").strip().split(" ", 2)
        except ValueError:
            return None
        headers = _HeaderMap()
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin1").partition(":")
            headers.add(k.strip(), v.strip())
        # framing headers must be unambiguous: the proxy frames the body by
        # ONE value while the full raw pair list reaches the app — repeated
        # conflicting Content-Length (or CL alongside chunked TE) is the
        # classic request-smuggling desync; reject it outright (RFC 9112 §6)
        cls = {v for k, v in headers.raw if k.lower() == "content-length"}
        if len(cls) > 1:
            return "bad-request"
        if cls and "chunked" in headers.get("transfer-encoding", "").lower():
            return "bad-request"
        if "chunked" in headers.get("transfer-encoding", "").lower():
            # chunked request body: drain it fully or the unread chunk
            # framing would desync the next keep-alive request
            chunks = []
            total = 0
            while True:
                size_line = await reader.readline()
                try:
                    size = int(size_line.strip().split(b";")[0], 16)
                except ValueError:
                    return "bad-request"
                if size == 0:
                    # consume any trailer fields up to the final blank line,
                    # or the leftovers desync the next keep-alive request
                    while True:
                        trailer = await reader.readline()
                        if trailer in (b"\r\n", b"\n", b""):
                            break
                    break
                total += size
                if total > _MAX_BODY:
                    return "bad-request"
                chunks.append(await reader.readexactly(size))
                await reader.readexactly(2)  # chunk CRLF
            return method, target, headers, b"".join(chunks), version.endswith("1.1")
        try:
            length = int(headers.get("content-length") or 0)
        except ValueError:
            return "bad-request"
        if length > _MAX_BODY:
            return "bad-request"
        body = await reader.readexactly(length) if length else b""
        return method, target, headers, body, version.endswith("1.1")

    async def _respond(self, writer, method, target, headers, body, keep, reader=None):
        """Returns False when the connection must be dropped (a truncated
        chunked stream cannot be reused, or it was consumed by a websocket
        upgrade)."""
        split = urlsplit(target)
        path = unquote(split.path)
        app = self._match(path)
        if app is None:
            await self._write_simple(
                writer, *_error_body(404, f"no route for {path}"), keep
            )
            return True
        if (
            reader is not None
            and headers.get("upgrade", "").lower() == "websocket"
            and "upgrade" in headers.get("connection", "").lower()
        ):
            return await self._respond_websocket(
                reader, writer, app, path, split.query, headers, keep
            )
        if self._is_asgi.get(app):
            return await self._respond_asgi(
                writer, app, method, path, split.query, headers, body, keep
            )
        loop = asyncio.get_running_loop()
        extra_headers = None
        ctx = self._mint_trace()
        try:
            status, blob, ctype = await loop.run_in_executor(
                self._pool, self._call_plain_traced, app, path, headers, body,
                ctx,
            )
        except DeploymentOverloadedError as e:
            # load shedding: fast 503 + Retry-After instead of queueing the
            # request into a guaranteed timeout
            status, blob, ctype = _error_body(503, str(e))
            extra_headers = _retry_after_headers(e)
        except (RequestTimeoutError, GetTimeoutError) as e:
            status, blob, ctype = _error_body(504, str(e))
        except Exception as e:  # noqa: BLE001
            status, blob, ctype = _error_body(500, str(e))
        if ctx is not None:
            # the request's trace id rides the response so a slow call can
            # be inspected with `ray_tpu_torch.trace(<id>)` directly
            extra_headers = dict(extra_headers or {})
            extra_headers["x-raytpu-trace-id"] = ctx.trace_id
        await self._write_simple(writer, status, blob, ctype, keep, extra_headers)
        return True

    @staticmethod
    def _mint_trace():
        """Root trace context for one proxy request (the serve-plane entry
        point); None when tracing is off."""
        from ray_tpu_torch.util import tracing

        return tracing.new_root() if tracing.tracing_enabled() else None

    def _call_plain_traced(self, app, path, headers, body, ctx):
        """Pool-side wrapper: activate the request's root context and record
        the proxy span (status + handle/replica sections nest under it)."""
        if ctx is None:
            return self._call_plain(app, headers, body)
        from ray_tpu_torch._private.profiling import traced_section
        from ray_tpu_torch.util import tracing

        with tracing.scope(ctx):
            with traced_section(
                f"serve:proxy:{path}", {"app": app, "entry": "http"}
            ) as sx:
                status, blob, ctype = self._call_plain(app, headers, body)
                sx["status"] = status
                return status, blob, ctype

    def _match(self, path: str) -> Optional[str]:
        for prefix, app in sorted(self.routes.items(), key=lambda kv: -len(kv[0])):
            if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                return app
        return None

    # -- plain (handle-protocol) deployments ------------------------------

    def _call_plain(self, app, headers, body) -> Tuple[int, bytes, str]:
        """Runs on the pool: JSON convention for json bodies, raw bytes
        otherwise; responses map by type (bytes -> octet-stream, str ->
        text, else JSON). Dispatch rides the direct proxy->replica channel
        when available, else the handle path."""
        ctype = headers.get("content-type", "")
        if body and "json" not in ctype and ctype:
            args = (body,)
        else:
            payload = json.loads(body) if body else None
            args = (payload,) if payload is not None else ()
        result = self._dispatch(app, "__call__", args)
        if isinstance(result, (bytes, bytearray, memoryview)):
            return 200, bytes(result), "application/octet-stream"
        if isinstance(result, str):
            return 200, result.encode(), "text/plain; charset=utf-8"
        return 200, json.dumps({"result": result}, default=str).encode(), "application/json"

    def _dispatch(self, app, method, args):
        from ray_tpu_torch.serve._direct import _DirectUnavailable

        handle = self._handles[app]
        timeout_s = float(handle._cfg.get("request_timeout_s") or 120.0)
        pool = self._direct.get(app)
        if pool is not None:
            # admission control covers the direct path too: the handle only
            # sees its own in-flight count, so fold in the pool's
            handle._check_admission(extra_load=pool.total_outstanding())
            try:
                return pool.call(method, args, {}, timeout=timeout_s)
            except _DirectUnavailable:
                pass
            # ReplicaDiedError propagates: torn work must NOT silently
            # re-execute through the handle path
        return handle._call(method, args, {}).result(timeout_s=timeout_s)

    async def _write_simple(self, writer, status, blob, ctype, keep,
                            extra_headers=None):
        extra = "".join(
            f"{k}: {v}\r\n" for k, v in (extra_headers or {}).items()
        )
        writer.write(
            (
                f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(blob)}\r\n"
                + extra
                + f"Connection: {'keep-alive' if keep else 'close'}\r\n\r\n"
            ).encode("latin1")
        )
        writer.write(blob)
        await writer.drain()

    # -- ASGI deployments --------------------------------------------------

    def _check_admission(self, app):
        """Per-deployment admission bound, shared by every ingress path;
        raises DeploymentOverloadedError when the deployment should shed."""
        handle = self._handles.get(app)
        if handle is None:
            return
        pool = self._direct.get(app)
        handle._check_admission(
            extra_load=pool.total_outstanding() if pool is not None else 0
        )

    async def _respond_asgi(self, writer, app, method, path, query, headers, body, keep):
        """Returns False when the connection is no longer reusable (client
        vanished or the chunked stream was truncated by a replica error)."""
        try:
            self._check_admission(app)
        except DeploymentOverloadedError as e:
            await self._write_simple(
                writer, *_error_body(503, str(e)), keep, _retry_after_headers(e)
            )
            return True
        scope = {
            "type": "http",
            "http_version": "1.1",
            "method": method.upper(),
            "path": path,
            "raw_path": path.encode(),
            "query_string": query.encode("latin1"),
            "root_path": "",
            "headers": [
                (k.lower().encode("latin1"), v.encode("latin1"))
                for k, v in getattr(headers, "raw", list(headers.items()))
            ],
        }
        loop = asyncio.get_running_loop()
        # bounded: a slow/vanished client must backpressure the pump, not
        # buffer an SSE stream forever
        q: asyncio.Queue = asyncio.Queue(maxsize=64)
        cancelled = threading.Event()

        def put(event) -> bool:
            """Blocking put from the pump thread; False once cancelled."""
            while not cancelled.is_set():
                fut = asyncio.run_coroutine_threadsafe(q.put(event), loop)
                try:
                    fut.result(timeout=1.0)
                    return True
                except TimeoutError:
                    if not fut.cancel():
                        # completed in the cancel window: the event IS
                        # enqueued — re-submitting would duplicate a chunk
                        return True
                except Exception:
                    return False
            return False

        ctx = self._mint_trace()

        def pump():
            from ray_tpu_torch._private.profiling import traced_section
            from ray_tpu_torch.serve._direct import _DirectUnavailable
            from ray_tpu_torch.util import tracing

            try:
                with tracing.scope(ctx), traced_section(
                    f"serve:proxy:{path}", {"app": app, "entry": "asgi"}
                ) if ctx is not None else contextlib.nullcontext({}) as sx:
                    import time as _time

                    t0 = _time.perf_counter()
                    sent = 0

                    def fwd(event) -> bool:
                        nonlocal sent
                        if sent == 0 and ctx is not None:
                            # TTFT: request in -> first response event out
                            sx["ttft_ms"] = round(
                                (_time.perf_counter() - t0) * 1e3, 3
                            )
                        sent += 1
                        return put(event)

                    pool = self._direct.get(app)
                    if pool is not None:
                        forwarded = False
                        try:
                            for event in pool.call_streaming(
                                "__asgi__", (scope, body), {}
                            ):
                                forwarded = True
                                if not fwd(event):
                                    return  # client gone; channel cleans up
                            put(None)
                            return
                        except _DirectUnavailable:
                            if forwarded:
                                raise  # mid-stream break: don't replay chunks
                            # nothing sent yet: fall through to handle path
                    handle = self._stream_handles[app]
                    for event in handle._call("__asgi__", (scope, body), {}):
                        if not fwd(event):
                            return
                    put(None)
            except BaseException as e:  # noqa: BLE001
                put(e)

        self._pool.submit(pump)
        extra_headers = (
            {"x-raytpu-trace-id": ctx.trace_id} if ctx is not None else None
        )
        try:
            return await self._write_asgi_response(
                writer, q, keep, extra_headers
            )
        finally:
            cancelled.set()

    async def _write_asgi_response(self, writer, q, keep,
                                   extra_headers=None) -> bool:
        first = await q.get()
        if first is None or isinstance(first, BaseException):
            if isinstance(first, DeploymentOverloadedError):
                # replica-side shed (e.g. KV-aware admission in an LLM
                # engine) raised before the first response event: same
                # 503 + Retry-After surface as proxy-side admission
                hdrs = dict(extra_headers or {})
                hdrs.update(_retry_after_headers(first))
                await self._write_simple(
                    writer, *_error_body(503, str(first)), keep, hdrs
                )
                return True
            msg = str(first) if first is not None else "empty ASGI response"
            await self._write_simple(
                writer, *_error_body(500, msg), keep, extra_headers
            )
            return True
        _, status, hdr_pairs = first
        # peek the next event to choose Content-Length vs chunked
        second = await q.get()
        hdr_lines = [
            f"{k.decode('latin1')}: {v.decode('latin1')}\r\n"
            for k, v in hdr_pairs
            if k.lower() not in (b"content-length", b"transfer-encoding", b"connection")
        ]
        for k, v in (extra_headers or {}).items():
            hdr_lines.append(f"{k}: {v}\r\n")
        conn_line = f"Connection: {'keep-alive' if keep else 'close'}\r\n"
        head = f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n" + "".join(hdr_lines)
        bodiless = second is None  # start followed by end: 204/304 pattern
        if bodiless or (
            isinstance(second, tuple) and second[0] == "body" and not second[2]
        ):
            blob = b"" if bodiless else second[1]
            writer.write(
                (head + f"Content-Length: {len(blob)}\r\n" + conn_line + "\r\n").encode("latin1")
            )
            writer.write(blob)
            await writer.drain()
            return True
        # streaming: chunked transfer encoding
        writer.write((head + "Transfer-Encoding: chunked\r\n" + conn_line + "\r\n").encode("latin1"))
        event = second
        while True:
            if event is None:
                break
            if isinstance(event, BaseException):
                # replica died mid-stream: DROP the connection without the
                # terminal chunk so the client sees truncation, not success
                return False
            if event[0] == "body":
                chunk = event[1]
                if chunk:
                    writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                    await writer.drain()
                if not event[2]:
                    break
            event = await q.get()
        writer.write(b"0\r\n\r\n")
        await writer.drain()
        return True

    # -- websocket upgrades ------------------------------------------------

    async def _respond_websocket(self, reader, writer, app, path, query, headers, keep):
        """RFC 6455 upgrade + frame relay (parity: the reference proxies
        websocket ASGI scopes via uvicorn, ``serve/_private/proxy.py``).
        Client frames relay to the replica as ``websocket.receive`` events
        over a dedicated direct-plane connection; the app's ``websocket.send``
        events come back as frames. Returns False when the connection was
        consumed by the session (always, after a 101)."""
        from ray_tpu_torch.serve import _ws as ws
        from ray_tpu_torch.serve._direct import _DirectUnavailable

        key = headers.get("sec-websocket-key")
        if not key:
            await self._write_simple(writer, *_error_body(400, "missing Sec-WebSocket-Key"), keep)
            return True
        if headers.get("sec-websocket-version", "13") != "13":
            writer.write(
                b"HTTP/1.1 426 Upgrade Required\r\nSec-WebSocket-Version: 13\r\n"
                b"Content-Length: 0\r\nConnection: close\r\n\r\n"
            )
            await writer.drain()
            return False
        if not self._is_asgi.get(app):
            await self._write_simple(
                writer, *_error_body(400, "route does not mount an ASGI app"), keep
            )
            return True
        try:
            # new sessions are load too: shed before dedicating a replica
            # serving thread to the socket
            self._check_admission(app)
        except DeploymentOverloadedError as e:
            await self._write_simple(
                writer, *_error_body(503, str(e)), keep, _retry_after_headers(e)
            )
            return True
        pool = self._direct.get(app)
        loop = asyncio.get_running_loop()
        conn = None
        if pool is not None:
            try:
                conn = await loop.run_in_executor(self._pool, pool.open_dedicated)
            except _DirectUnavailable:
                conn = None
            except Exception:
                conn = None
        if conn is None:
            # websockets need the bidirectional direct plane; the handle
            # path is request->stream only
            await self._write_simple(
                writer, *_error_body(503, "no live replica channel for websocket"), keep
            )
            return True

        scope = {
            "type": "websocket",
            "http_version": "1.1",
            "scheme": "ws",
            "path": path,
            "raw_path": path.encode(),
            "query_string": query.encode("latin1"),
            "root_path": "",
            "headers": [
                (k.lower().encode("latin1"), v.encode("latin1"))
                for k, v in getattr(headers, "raw", list(headers.items()))
            ],
            "subprotocols": [
                s.strip()
                for s in headers.get("sec-websocket-protocol", "").split(",")
                if s.strip()
            ],
        }

        q: asyncio.Queue = asyncio.Queue(maxsize=64)
        cancelled = threading.Event()

        def put(event) -> bool:
            while not cancelled.is_set():
                fut = asyncio.run_coroutine_threadsafe(q.put(event), loop)
                try:
                    fut.result(timeout=1.0)
                    return True
                except _FuturesTimeout:
                    # NOT builtin TimeoutError: on Python 3.8-3.10 the
                    # futures timeout is a distinct class, and letting it
                    # fall into the generic handler killed the pump on a
                    # 1s backpressure stall
                    if not fut.cancel():
                        return True
                except Exception:
                    return False
            return False

        # session root span: minted here (not in the pump thread) so the 101
        # response can carry the trace id and the session span records below
        ws_ctx = self._mint_trace()
        ws_t0 = time.time()

        def pump_down():
            import pickle as _pickle

            try:
                conn.send(
                    ("__ws__", [scope], {}, "", True,
                     ws_ctx.to_dict() if ws_ctx is not None else None)
                )
                while True:
                    kind, payload = conn.recv()
                    if kind == "evt":
                        if not put(payload):
                            return
                    elif kind == "end":
                        put(None)
                        return
                    else:  # "err"
                        put(_pickle.loads(payload))
                        return
            except (EOFError, OSError, BrokenPipeError):
                put(ConnectionError("replica connection lost"))
            except BaseException as e:  # noqa: BLE001
                put(e)

        # sessions are long-lived: dedicated threads, NOT the shared request
        # pool — 64 idle websockets must not starve plain HTTP dispatch
        threading.Thread(target=pump_down, daemon=True, name="ws-down").start()
        up_q: "queue.Queue" = queue.Queue(maxsize=256)

        def pump_up():
            try:
                while True:
                    ev = up_q.get()
                    if ev is None:
                        return
                    conn.send(("msg", ev))
            except (OSError, EOFError, BrokenPipeError):
                pass

        up_thread = threading.Thread(target=pump_up, daemon=True, name="ws-up")
        up_thread.start()
        try:
            # bounded: an app that hangs before accept/close must not leak
            # the client socket, both pump threads, and a dedicated replica
            # serving thread per retried connection
            try:
                first = await asyncio.wait_for(q.get(), timeout=60.0)
            except asyncio.TimeoutError:
                await self._write_simple(
                    writer, *_error_body(500, "app never completed the handshake"), keep
                )
                return True
            if isinstance(first, dict) and first.get("type") == "websocket.accept":
                extra = [
                    f"{k.decode('latin1')}: {v.decode('latin1')}\r\n"
                    for k, v in first.get("headers", [])
                ]
                sub = first.get("subprotocol")
                if sub:
                    extra.append(f"Sec-WebSocket-Protocol: {sub}\r\n")
                if ws_ctx is not None:
                    # the session's trace id rides the upgrade response so
                    # a slow websocket can be fed to `ray_tpu_torch.trace(<id>)`
                    extra.append(f"x-raytpu-trace-id: {ws_ctx.trace_id}\r\n")
                writer.write(
                    (
                        "HTTP/1.1 101 Switching Protocols\r\n"
                        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                        f"Sec-WebSocket-Accept: {ws.accept_key(key)}\r\n"
                        + "".join(extra)
                        + "\r\n"
                    ).encode("latin1")
                )
                await writer.drain()
            elif isinstance(first, dict) and first.get("type") == "websocket.close":
                # rejected before accept -> 403, per the ASGI spec
                await self._write_simple(writer, 403, b"", "text/plain", keep)
                return True
            else:
                msg = str(first) if first is not None else "app closed without accepting"
                await self._write_simple(writer, *_error_body(500, msg), keep)
                return True

            # -- accepted: relay until either side closes ------------------
            async def send_up(event) -> None:
                # enqueue for the session's sender thread; an async retry
                # loop gives backpressure without parking a pool thread
                while True:
                    try:
                        up_q.put_nowait(event)
                        return
                    except queue.Full:
                        await asyncio.sleep(0.02)

            async def upstream():
                frames = ws.MessageReader(reader)
                try:
                    while True:
                        op, payload = await frames.next()
                        if op == ws.OP_CLOSE:
                            code, _reason = ws.parse_close(payload)
                            try:
                                writer.write(ws.encode_close(code))
                                await writer.drain()
                            except (ConnectionError, OSError):
                                pass
                            await send_up(
                                {"type": "websocket.disconnect", "code": code}
                            )
                            return
                        if op == ws.OP_PING:
                            writer.write(ws.encode_frame(ws.OP_PONG, payload))
                            await writer.drain()
                            continue
                        if op == ws.OP_PONG:
                            continue
                        ev = {"type": "websocket.receive"}
                        if op == ws.OP_TEXT:
                            ev["text"] = payload.decode("utf-8")
                        else:
                            ev["bytes"] = payload
                        await send_up(ev)
                except (ConnectionError, OSError, EOFError, ValueError,
                        asyncio.IncompleteReadError):
                    try:
                        up_q.put_nowait(
                            {"type": "websocket.disconnect", "code": 1006}
                        )
                    except queue.Full:
                        pass

            up_task = asyncio.ensure_future(upstream())
            try:
                while True:
                    event = await q.get()
                    if event is None:
                        # app returned without an explicit close
                        writer.write(ws.encode_close(1000))
                        await writer.drain()
                        return False
                    if isinstance(event, BaseException):
                        try:
                            writer.write(ws.encode_close(1011, "internal error"))
                            await writer.drain()
                        except (ConnectionError, OSError):
                            pass
                        return False
                    t = event.get("type")
                    if t == "websocket.send":
                        if event.get("text") is not None:
                            frame = ws.encode_frame(
                                ws.OP_TEXT, event["text"].encode("utf-8")
                            )
                        else:
                            frame = ws.encode_frame(
                                ws.OP_BINARY, bytes(event.get("bytes") or b"")
                            )
                        writer.write(frame)
                        await writer.drain()
                    elif t == "websocket.close":
                        writer.write(
                            ws.encode_close(
                                int(event.get("code", 1000)),
                                str(event.get("reason") or ""),
                            )
                        )
                        await writer.drain()
                        return False
            finally:
                up_task.cancel()
        except (ConnectionError, OSError):
            return False
        finally:
            cancelled.set()
            try:
                up_q.put_nowait(None)  # stop the sender thread
            except queue.Full:
                pass  # it will exit on the closed conn instead
            try:
                conn.close()
            except OSError:
                pass
            if ws_ctx is not None:
                # session span: the trace's proxy entry node (replica-side
                # spans and nested submissions parent to it), duration =
                # whole websocket session
                try:
                    import os as _os

                    from ray_tpu_torch._private import telemetry as _telemetry

                    end = time.time()
                    _telemetry.record_span(
                        {
                            "event": f"serve:proxy:ws:{path}",
                            "start": ws_t0,
                            "end": end,
                            "duration_ms": (end - ws_t0) * 1e3,
                            "pid": _os.getpid(),
                            "extra": {"app": app, "entry": "websocket",
                                      **ws_ctx.to_dict()},
                        }
                    )
                except Exception:
                    pass
        return False

    # -- control -----------------------------------------------------------

    def add_route(self, route_prefix: str, app_name: str, handle):
        self.routes[route_prefix] = app_name
        self._handles[app_name] = handle
        self._stream_handles[app_name] = handle.options(stream=True)
        is_asgi = False
        try:
            replicas = getattr(handle, "_replicas", None) or []
            if replicas:
                is_asgi = bool(
                    ray_tpu_torch.get(replicas[0].is_asgi.remote(), timeout=30)
                )
        except Exception:
            is_asgi = False
        self._is_asgi[app_name] = is_asgi
        # direct proxy->replica data plane (head out of the request path);
        # a re-added route must close the prior pool's channels first
        old = self._direct.pop(app_name, None)
        if old is not None:
            try:
                old.close()
            except Exception:
                pass
        try:
            from ray_tpu_torch._private.worker import get_runtime
            from ray_tpu_torch.serve._direct import DirectPool

            key = get_runtime().config.auth_key.encode()
            self._direct[app_name] = DirectPool(handle, key)
        except Exception:
            self._direct.pop(app_name, None)
        return self.port

    def _refresh_direct(self):
        for pool in self._direct.values():
            try:
                pool.refresh()
            except Exception:
                pass

    def remove_route(self, route_prefix: str):
        app = self.routes.pop(route_prefix, None)
        if app:
            self._handles.pop(app, None)
            self._stream_handles.pop(app, None)
            self._is_asgi.pop(app, None)
            pool = self._direct.pop(app, None)
            if pool is not None:
                try:
                    pool.close()
                except Exception:
                    pass
        return True

    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)


_REASONS = {
    200: "OK",
    400: "Bad Request",
    403: "Forbidden",
    404: "Not Found",
    500: "Internal Server Error",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}


def ensure_proxy(controller, app_name: str, route_prefix: str, port: int = DEFAULT_PORT):
    from ray_tpu_torch.serve.api import get_app_handle

    try:
        proxy = ray_tpu_torch.get_actor(_PROXY_NAME)
    except ValueError:
        try:
            proxy = HTTPProxy.options(name=_PROXY_NAME, num_cpus=0).remote(port)
        except ValueError:
            proxy = ray_tpu_torch.get_actor(_PROXY_NAME)
    handle = get_app_handle(app_name)
    ray_tpu_torch.get(proxy.add_route.remote(route_prefix, app_name, handle), timeout=60)
    try:
        ray_tpu_torch.get(
            controller.register_route.remote(route_prefix, app_name), timeout=60
        )
    except Exception:
        pass
    return proxy


def start_node_proxies() -> Dict[str, Tuple[str, int]]:
    """One HTTP ingress per alive node (parity: the reference's ProxyState
    keeping a proxy actor on every node, ``_private/proxy_state.py``): each
    proxy is pinned to its node and serves every registered route through
    its own handles (pow-2 + probed queue depths). Returns
    ``{node_id_hex: (host, port)}``; ports are ephemeral per node."""
    from ray_tpu_torch.serve.api import _get_or_create_controller, get_app_handle
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    controller = _get_or_create_controller()
    routes = ray_tpu_torch.get(controller.get_routes.remote(), timeout=60)
    # one handle fetch per app (not per node x route); skip apps deleted
    # since their route was registered
    handles = {}
    for app in set(routes.values()):
        try:
            handles[app] = get_app_handle(app)
        except ValueError:
            pass
    out: Dict[str, Tuple[str, int]] = {}
    for node in ray_tpu_torch.nodes():
        if not node["alive"]:
            continue
        nid = node["node_id"]
        name = f"{_PROXY_NAME}:{nid[:12]}"
        try:
            proxy = ray_tpu_torch.get_actor(name)
        except ValueError:
            try:
                proxy = HTTPProxy.options(
                    name=name,
                    num_cpus=0,
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=nid, soft=False
                    ),
                ).remote(0, bind_host="0.0.0.0")  # ephemeral port per node
            except ValueError:
                proxy = ray_tpu_torch.get_actor(name)
        for prefix, app in routes.items():
            if app in handles:
                ray_tpu_torch.get(
                    proxy.add_route.remote(prefix, app, handles[app]),
                    timeout=60,
                )
        out[nid] = tuple(ray_tpu_torch.get(proxy.address.remote(), timeout=60))
    return out
