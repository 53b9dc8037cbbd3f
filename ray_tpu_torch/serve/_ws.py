"""WebSocket support for the Serve ingress.

Parity: the reference proxies any ASGI scope type — including websockets —
by embedding uvicorn (``python/ray/serve/_private/proxy.py``); Serve apps
receive ``websocket`` scopes like any Starlette/FastAPI app. Here the
hand-rolled HTTP front end performs the RFC 6455 upgrade itself and relays
frames over a DEDICATED proxy→replica connection (dialed per session from
the replica's direct data-plane listener, ``serve/_direct.py``):

    client ⇄ proxy              ws frames (this codec)
    proxy  ⇄ replica            ("msg", asgi_event) upstream,
                                ("evt", asgi_event) downstream
    replica ⇄ user ASGI app     standard websocket.* events

The app sees the standard ASGI websocket lifecycle: ``websocket.connect`` →
``websocket.accept`` (or ``websocket.close`` → HTTP 403, per spec) →
``websocket.receive``/``websocket.send`` → ``websocket.disconnect``.

Websocket sessions require the direct data plane (the head-relayed handle
path is unidirectional); with no live replica channel the proxy answers 503.
"""

from __future__ import annotations

import base64
import hashlib
import os
import queue
import struct
import threading
from typing import Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_FRAME = 64 * 1024 * 1024

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key (RFC 6455 §4.2.2)."""
    digest = hashlib.sha1((client_key + _GUID).encode("latin1")).digest()
    return base64.b64encode(digest).decode()


def _xor_mask(data: bytes, mask: bytes) -> bytes:
    n = len(data)
    if n == 0:
        return b""
    m = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(m, "little")).to_bytes(
        n, "little"
    )


def encode_frame(opcode: int, payload: bytes, fin: bool = True, mask: bool = False) -> bytes:
    """One frame. Servers send unmasked; clients must mask (RFC 6455 §5.3)."""
    b0 = (0x80 if fin else 0) | opcode
    mbit = 0x80 if mask else 0
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", b0, mbit | n)
    elif n < 1 << 16:
        head = struct.pack("!BBH", b0, mbit | 126, n)
    else:
        head = struct.pack("!BBQ", b0, mbit | 127, n)
    if mask:
        mk = os.urandom(4)
        return head + mk + _xor_mask(payload, mk)
    return head + payload


def encode_close(code: int = 1000, reason: str = "", mask: bool = False) -> bytes:
    # close payload caps at 125 bytes (2 for the code); the reason must stay
    # valid UTF-8 after truncation (RFC 6455 §5.5.1), so cut on a codepoint
    # boundary, never mid-sequence
    raw = reason.encode("utf-8")
    if len(raw) > 123:
        raw = raw[:123].decode("utf-8", errors="ignore").encode("utf-8")
    payload = struct.pack("!H", code) + raw
    return encode_frame(OP_CLOSE, payload, mask=mask)


def parse_close(payload: bytes) -> Tuple[int, str]:
    if len(payload) >= 2:
        code = struct.unpack("!H", payload[:2])[0]
        try:
            reason = payload[2:].decode("utf-8")
        except UnicodeDecodeError:
            reason = ""
        return code, reason
    return 1005, ""


async def read_frame(reader) -> Tuple[bool, int, bytes]:
    """Read one frame from an ``asyncio.StreamReader`` → (fin, opcode, payload),
    unmasking when the peer masked (clients always do)."""
    hdr = await reader.readexactly(2)
    b0, b1 = hdr[0], hdr[1]
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    length = b1 & 0x7F
    if length == 126:
        length = struct.unpack("!H", await reader.readexactly(2))[0]
    elif length == 127:
        length = struct.unpack("!Q", await reader.readexactly(8))[0]
    if length > MAX_FRAME:
        raise ValueError(f"websocket frame exceeds {MAX_FRAME} bytes")
    mask = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(length) if length else b""
    if mask:
        payload = _xor_mask(payload, mask)
    return fin, opcode, payload


class MessageReader:
    """Reassembles fragmented messages across calls. Control frames may be
    injected INSIDE a fragmented message (RFC 6455 §5.4): they surface
    immediately while the partial data message stays buffered here, so the
    continuation frames that follow still have their message in progress."""

    def __init__(self, reader):
        self._reader = reader
        self._opcode: Optional[int] = None
        self._parts: list = []
        self._total = 0

    async def next(self) -> Tuple[int, bytes]:
        while True:
            fin, op, payload = await read_frame(self._reader)
            if op in (OP_CLOSE, OP_PING, OP_PONG):
                return op, payload
            if op != OP_CONT:
                self._opcode = op
                self._parts = [payload]
                self._total = len(payload)
            else:
                if self._opcode is None:
                    raise ValueError(
                        "continuation frame with no message in progress"
                    )
                self._parts.append(payload)
                self._total += len(payload)
            if self._total > MAX_FRAME:
                raise ValueError(
                    f"websocket message exceeds {MAX_FRAME} bytes"
                )
            if fin:
                op, data = self._opcode, b"".join(self._parts)
                self._opcode, self._parts, self._total = None, [], 0
                return op, data


async def read_message(reader) -> Tuple[int, bytes]:
    """One-shot form of MessageReader for callers without interleaved
    control-frame concerns (a fragmented message must complete within the
    call). Prefer MessageReader for session loops."""
    return await MessageReader(reader).next()


# ---------------------------------------------------------------------------
# Replica side: drive the user ASGI app over a dedicated proxy connection.
# ---------------------------------------------------------------------------


def run_asgi_websocket(asgi_app, scope, conn, instance=None) -> None:
    """Execute one websocket session against ``asgi_app`` on the replica.

    ``conn`` is the dedicated proxy connection (multiprocessing.connection):
    upstream ASGI events arrive as ``("msg", event)`` records (fed by a
    reader thread into the app's ``receive``), downstream ``send`` events
    leave as ``("evt", event)``; ``("end", None)`` / ``("err", blob)``
    terminate the session. Runs on the direct server's per-connection
    thread; the app gets its own event loop.
    """
    import asyncio
    import pickle

    import cloudpickle

    scope = dict(scope)
    scope["type"] = "websocket"
    scope["headers"] = [(bytes(k), bytes(v)) for k, v in scope.get("headers", [])]
    scope.setdefault("asgi", {"version": "3.0", "spec_version": "2.3"})
    ext = dict(scope.get("extensions") or {})
    ext["serve_replica"] = instance
    scope["extensions"] = ext

    upstream: "queue.Queue" = queue.Queue(maxsize=256)
    send_lock = threading.Lock()
    closed = threading.Event()

    def put_upstream(event) -> bool:
        """Interruptible bounded put: never wedges past session close, so
        the serving thread (and its ongoing-request slot) always frees."""
        while not closed.is_set():
            try:
                upstream.put(event, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            while not closed.is_set():
                kind, event = conn.recv()
                if kind == "msg":
                    if not put_upstream(event):
                        return
                    if event.get("type") == "websocket.disconnect":
                        return
        except (EOFError, OSError):
            put_upstream({"type": "websocket.disconnect", "code": 1006})

    rt = threading.Thread(target=reader, daemon=True, name="serve-ws-up")
    rt.start()

    connected = False
    disconnected: list = [False, 1006]

    async def receive():
        nonlocal connected
        if not connected:
            connected = True
            return {"type": "websocket.connect"}
        if disconnected[0]:
            # sticky: an app polling receive() after the disconnect must
            # not block forever on the drained queue
            return {"type": "websocket.disconnect", "code": disconnected[1]}
        loop = asyncio.get_running_loop()

        def _get():
            # poll, don't park: an abandoned receive() (wait_for timeout,
            # cancelled race) leaves this executor thread behind — it must
            # notice session close and exit, or loop shutdown joins it for
            # minutes and the serving thread + ongoing-request slot wedge
            while True:
                try:
                    return upstream.get(timeout=0.5)
                except queue.Empty:
                    if closed.is_set():
                        return {"type": "websocket.disconnect", "code": 1006}

        ev = await loop.run_in_executor(None, _get)
        if ev.get("type") == "websocket.disconnect":
            disconnected[0] = True
            disconnected[1] = ev.get("code", 1006)
        return ev

    async def send(event):
        if closed.is_set():
            raise RuntimeError("websocket session closed")
        with send_lock:
            conn.send(("evt", event))

    async def _session():
        try:
            await asgi_app(scope, receive, send)
        finally:
            # set BEFORE the loop shuts down its default executor: any
            # executor thread still polling in receive()'s _get must see
            # this and exit, or asyncio.run would join it for minutes
            closed.set()

    try:
        asyncio.run(_session())
        with send_lock:
            conn.send(("end", None))
    except (EOFError, OSError, BrokenPipeError):
        pass  # proxy/client went away mid-session
    except BaseException as e:  # noqa: BLE001
        try:
            blob = cloudpickle.dumps(e)
        except Exception:
            blob = pickle.dumps(RuntimeError(str(e)))
        try:
            with send_lock:
                conn.send(("err", blob))
        except (OSError, BrokenPipeError):
            pass
    finally:
        closed.set()
        # unblock a pending upstream.get if the app leaked one; never block
        # here — a full queue already has a wakeup for the getter
        try:
            upstream.put_nowait({"type": "websocket.disconnect", "code": 1006})
        except queue.Full:
            pass


# ---------------------------------------------------------------------------
# Minimal synchronous client (tests / simple consumers).
# ---------------------------------------------------------------------------


class WSClient:
    """Blocking RFC 6455 client over a raw socket — enough for tests and
    simple tooling (text/binary/ping/close; no extensions/compression)."""

    def __init__(self, host: str, port: int, path: str = "/",
                 subprotocols=(), timeout: float = 30.0):
        import socket as _socket

        self._sock = _socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        key = base64.b64encode(os.urandom(16)).decode()
        lines = [
            f"GET {path} HTTP/1.1",
            f"Host: {host}:{port}",
            "Upgrade: websocket",
            "Connection: Upgrade",
            f"Sec-WebSocket-Key: {key}",
            "Sec-WebSocket-Version: 13",
        ]
        if subprotocols:
            lines.append("Sec-WebSocket-Protocol: " + ", ".join(subprotocols))
        self._sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        status, headers = self._read_http_response()
        self.status = status
        self.response_headers = headers
        if status != 101:
            self._sock.close()
            raise ConnectionError(f"websocket upgrade refused: HTTP {status}")
        expect = accept_key(key)
        if headers.get("sec-websocket-accept") != expect:
            self._sock.close()
            raise ConnectionError("bad Sec-WebSocket-Accept")
        self.subprotocol = headers.get("sec-websocket-protocol")

    def _read_http_response(self):
        while b"\r\n\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("connection closed during upgrade")
            self._buf += chunk
        head, self._buf = self._buf.split(b"\r\n\r\n", 1)
        lines = head.decode("latin1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        headers = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        return status, headers

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_frame(self):
        hdr = self._read_exact(2)
        fin = bool(hdr[0] & 0x80)
        opcode = hdr[0] & 0x0F
        masked = bool(hdr[1] & 0x80)
        length = hdr[1] & 0x7F
        if length == 126:
            length = struct.unpack("!H", self._read_exact(2))[0]
        elif length == 127:
            length = struct.unpack("!Q", self._read_exact(8))[0]
        mask = self._read_exact(4) if masked else None
        payload = self._read_exact(length) if length else b""
        if mask:
            payload = _xor_mask(payload, mask)
        return fin, opcode, payload

    def send_text(self, text: str) -> None:
        self._sock.sendall(encode_frame(OP_TEXT, text.encode("utf-8"), mask=True))

    def send_bytes(self, data: bytes) -> None:
        self._sock.sendall(encode_frame(OP_BINARY, data, mask=True))

    def ping(self, payload: bytes = b"") -> None:
        self._sock.sendall(encode_frame(OP_PING, payload, mask=True))

    def recv(self):
        """Next message: str (text), bytes (binary), or ("close", code, reason).
        Pongs answer pings transparently; solicited pongs surface as
        ("pong", payload)."""
        opcode = None
        parts = []
        while True:
            fin, op, payload = self._read_frame()
            if op == OP_CLOSE:
                code, reason = parse_close(payload)
                try:
                    self._sock.sendall(encode_close(code, mask=True))
                except OSError:
                    pass
                return ("close", code, reason)
            if op == OP_PING:
                self._sock.sendall(encode_frame(OP_PONG, payload, mask=True))
                continue
            if op == OP_PONG:
                return ("pong", payload)
            if op != OP_CONT:
                opcode = op
                parts = [payload]
            else:
                parts.append(payload)
            if fin:
                data = b"".join(parts)
                return data.decode("utf-8") if opcode == OP_TEXT else data

    def close(self, code: int = 1000, reason: str = "") -> None:
        try:
            self._sock.sendall(encode_close(code, reason, mask=True))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
