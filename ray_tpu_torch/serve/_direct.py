"""Direct proxy→replica data plane.

Parity: the reference proxy speaks gRPC straight to replica processes
(``python/ray/serve/_private/proxy.py`` → replica ``ASGIReplicaWrapper``),
bypassing the control plane per request. Here every Replica hosts a small
authenticated socket server inside its worker process; proxies hold
persistent connections (the keep-alive hop) and exchange framed-pickle
request/response pairs — the cluster head is no longer in the per-request
path. Handle-path dispatch remains the fallback when a direct channel
breaks (replica restarting / autoscaled away).
"""

from __future__ import annotations

import contextlib
import pickle
import threading
from multiprocessing.connection import Client, Listener
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle


class DirectReplicaServer:
    """Runs inside the replica worker: serves requests over persistent
    authenticated connections, executing through the SAME gate/ongoing
    accounting as handle-path requests (autoscaling sees both)."""

    def __init__(self, replica, auth_key: bytes, host: str = "127.0.0.1"):
        self._replica = replica
        self._listener = Listener((host, 0), backlog=64, authkey=auth_key)
        self._stop = False
        threading.Thread(
            target=self._accept_loop, daemon=True, name="serve-direct"
        ).start()

    @property
    def port(self) -> int:
        return tuple(self._listener.address)[1]

    def _accept_loop(self):
        while not self._stop:
            try:
                conn = self._listener.accept()
            except Exception:
                # AuthenticationError (a failed HMAC challenge from a
                # scanner or stale-key proxy) is NOT an OSError; the accept
                # loop must survive it or the replica permanently loses its
                # direct plane
                if self._stop:
                    return
                continue
            from ray_tpu_torch._private.object_transfer import set_nodelay

            set_nodelay(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn):
        from ray_tpu_torch.util import tracing as _tracing

        try:
            while True:
                msg = conn.recv()
                method, args, kwargs, model_id, stream = msg[:5]
                # optional 6th frame element: the caller's trace context —
                # activated for this request so replica spans join the
                # proxy's trace (frames from older proxies simply lack it)
                ctx = None
                if len(msg) > 5 and msg[5]:
                    try:
                        ctx = _tracing.TraceContext.from_dict(msg[5])
                    except Exception:
                        ctx = None
                with _tracing.scope(ctx) if ctx is not None else (
                    contextlib.nullcontext()
                ):
                    done = self._serve_one(
                        conn, method, args, kwargs, model_id, stream
                    )
                if done:
                    return
        except (EOFError, OSError, BrokenPipeError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_one(self, conn, method, args, kwargs, model_id, stream) -> bool:
        """Handle one framed request; True = the connection is consumed
        (websocket sessions never return to request/response framing)."""
        if method == "__ws__":
            # the connection becomes a dedicated bidirectional
            # websocket session channel; it never returns to
            # request/response framing. A drain rejection (or any
            # pre-session failure) goes back as a typed error frame
            # so the proxy answers the upgrade cleanly instead of
            # dropping the socket.
            try:
                self._replica.handle_websocket(conn, args[0])
            except Exception as e:  # noqa: BLE001
                try:
                    blob = cloudpickle.dumps(e)
                except Exception:
                    blob = pickle.dumps(RuntimeError(str(e)))
                try:
                    conn.send(("err", blob))
                except (OSError, BrokenPipeError):
                    pass
            return True
        try:
            # the ("started", None) frame is the replica-side
            # started-marker: a channel that breaks BEFORE the proxy
            # saw it provably never executed this request (safe to
            # retry elsewhere); a break after it is torn work.
            # Draining rejections are checked first so they are
            # never marked started.
            if getattr(self._replica, "_draining", False):
                self._replica._reject_if_draining()
            if stream:
                conn.send(("started", None))
                for item in self._replica.handle_request_streaming(
                    method, args, kwargs, model_id
                ):
                    conn.send(("item", item))
                conn.send(("end", None))
            else:
                conn.send(("started", None))
                result = self._replica.handle_request(
                    method, args, kwargs, model_id
                )
                conn.send(("ok", result))
        except Exception as e:  # noqa: BLE001
            try:
                blob = cloudpickle.dumps(e)
            except Exception:
                blob = pickle.dumps(RuntimeError(str(e)))
            conn.send(("err", blob))
        return False

    def close(self):
        self._stop = True
        try:
            self._listener.close()
        except OSError:
            pass


class DirectChannel:
    """Proxy-side persistent connection to one replica's direct server.

    A channel whose request/response framing can no longer be trusted (recv
    timeout, stream abandoned mid-flight) marks itself broken; the pool
    re-dials a replacement lazily.
    """

    CALL_TIMEOUT_S = 120.0
    STREAM_FRAME_TIMEOUT_S = 300.0

    def __init__(self, address, auth_key: bytes):
        self._address = tuple(address)
        self._auth = auth_key
        self._conn = Client(self._address, authkey=auth_key)
        from ray_tpu_torch._private.object_transfer import set_nodelay

        set_nodelay(self._conn)
        self._lock = threading.Lock()
        self.broken = False

    def _recv(self, timeout: float):
        try:
            ready = self._conn.poll(timeout)
        except (OSError, EOFError) as e:
            self.broken = True
            self.close()
            raise _ChannelBroken(str(e)) from e
        if not ready:
            self.broken = True
            self.close()
            # the reply may still arrive later, so this socket's framing can
            # no longer be trusted (channel dies), but the REPLICA is not
            # dead — tag it so the pool raises a timeout, not replica-death
            err = _ChannelBroken(
                f"direct replica call timed out after {timeout}s"
            )
            err.timed_out = True
            raise err
        try:
            return self._conn.recv()
        except (OSError, EOFError) as e:
            self.broken = True
            self.close()
            raise _ChannelBroken(str(e)) from e

    def _send(self, msg):
        try:
            self._conn.send(msg)
        except (OSError, EOFError, BrokenPipeError) as e:
            self.broken = True
            self.close()
            raise _ChannelBroken(str(e)) from e

    @staticmethod
    def _ctx_frame():
        """The caller's trace context as the frame's optional 6th element
        (None when untraced) — replica spans join the proxy's span tree."""
        from ray_tpu_torch.util.tracing import context_args

        return context_args() or None

    def call(self, method: str, args, kwargs, model_id: str = "", timeout=None):
        timeout = timeout or self.CALL_TIMEOUT_S
        started = False
        with self._lock:
            try:
                self._send(
                    (method, list(args), dict(kwargs), model_id, False,
                     self._ctx_frame())
                )
                kind, payload = self._recv(timeout)
                if kind == "started":
                    started = True
                    kind, payload = self._recv(timeout)
            except _ChannelBroken as e:
                # started-marker: a break before the replica's "started"
                # frame means this request never executed — safe to retry
                e.started = started
                raise
        if kind == "ok":
            return payload
        # an APPLICATION exception (may subclass OSError!) — it must reach
        # the caller untouched, never be mistaken for a transport failure
        raise pickle.loads(payload)

    def call_streaming(self, method: str, args, kwargs, model_id: str = ""):
        completed = False
        started = False
        items_sent = 0
        with self._lock:
            try:
                self._send(
                    (method, list(args), dict(kwargs), model_id, True,
                     self._ctx_frame())
                )
                while True:
                    try:
                        kind, payload = self._recv(self.STREAM_FRAME_TIMEOUT_S)
                    except _ChannelBroken as e:
                        e.started = started
                        e.items_sent = items_sent
                        raise
                    if kind == "started":
                        started = True
                    elif kind == "item":
                        items_sent += 1
                        yield payload
                    elif kind == "end":
                        completed = True
                        return
                    else:
                        completed = True  # framing intact: error frame ends it
                        raise pickle.loads(payload)
            finally:
                if not completed:
                    # abandoned mid-stream (client went away): unread frames
                    # would desync the next request on this socket
                    self.broken = True
                    self.close()

    def close(self):
        try:
            self._conn.close()
        except OSError:
            pass


class DirectPool:
    """Pow-2 routed pool of direct channels for one application.

    Several channels per replica so concurrent proxy threads don't serialize
    on one socket; broken channels evict the replica until the next refresh
    (the caller falls back to the handle path meanwhile).
    """

    REFRESH_PERIOD_S = 5.0
    CHANNELS_PER_REPLICA = 4
    DRAINING_TTL_S = 30.0

    def __init__(self, handle, auth_key: bytes):
        self._handle = handle
        self._auth = auth_key
        self._lock = threading.Lock()
        # actor_id hex -> {"addr", "channels": [DirectChannel], "rr": int}
        self._replicas: Dict[str, dict] = {}
        self._outstanding: Dict[str, int] = {}
        # rid -> monotonic timestamp of the drain rejection: the replica is
        # alive but refusing work; skip it until the handle-info refresh
        # drops it (TTL-bounded so a cancelled drain re-enters the pool)
        self._draining: Dict[str, float] = {}
        self._last_refresh = 0.0
        self.refresh()

    def refresh(self) -> None:
        import time

        import ray_tpu_torch

        with self._lock:
            if time.monotonic() - self._last_refresh < 1.0:
                return
            self._last_refresh = time.monotonic()
        try:
            self._handle._maybe_refresh()  # pick up autoscaling changes
        except Exception:
            pass
        with self._lock:
            replicas = list(getattr(self._handle, "_replicas", []) or [])
        addrs: Dict[str, Any] = {}
        for r in replicas:
            rid = r._actor_id.hex()
            with self._lock:
                if rid in self._replicas:
                    continue
            try:
                addrs[rid] = (r, ray_tpu_torch.get(r.direct_address.remote(), timeout=30))
            except Exception:
                continue
        for rid, (r, addr) in addrs.items():
            if not addr:
                continue
            try:
                chans = [
                    DirectChannel(addr, self._auth)
                    for _ in range(self.CHANNELS_PER_REPLICA)
                ]
            except Exception:
                continue
            with self._lock:
                self._replicas[rid] = {"addr": addr, "channels": chans, "rr": 0}
                self._outstanding.setdefault(rid, 0)
        # drop replicas no longer in the handle's set
        live = {r._actor_id.hex() for r in replicas}
        with self._lock:
            for rid in [x for x in self._replicas if x not in live]:
                for c in self._replicas[rid]["channels"]:
                    c.close()
                del self._replicas[rid]
                self._outstanding.pop(rid, None)
            now = time.monotonic()
            for rid in [
                r
                for r, ts in self._draining.items()
                if r not in self._replicas or now - ts > self.DRAINING_TTL_S
            ]:
                del self._draining[rid]

    def _mark_draining(self, rid: str) -> None:
        import time

        with self._lock:
            if rid in self._replicas:
                self._draining[rid] = time.monotonic()

    def total_outstanding(self) -> int:
        """In-flight direct-path requests (admission-control input)."""
        with self._lock:
            return sum(self._outstanding.values())

    def _pick(self) -> Optional[Tuple[str, DirectChannel]]:
        import random

        with self._lock:
            rids = [r for r in self._replicas if r not in self._draining]
            if not rids:
                return None
            if len(rids) == 1:
                rid = rids[0]
            else:
                a, b = random.sample(rids, 2)
                rid = a if self._outstanding.get(a, 0) <= self._outstanding.get(b, 0) else b
            entry = self._replicas[rid]
            entry["rr"] = (entry["rr"] + 1) % len(entry["channels"])
            chan = entry["channels"][entry["rr"]]
            if chan.broken:
                # lazy re-dial into the same slot (a stream abandoned on it)
                try:
                    chan = DirectChannel(entry["addr"], self._auth)
                    entry["channels"][entry["rr"]] = chan
                except Exception:
                    return None
            self._outstanding[rid] = self._outstanding.get(rid, 0) + 1
            return rid, chan

    def _done(self, rid: str) -> None:
        with self._lock:
            if rid in self._outstanding:
                self._outstanding[rid] -= 1

    def _evict(self, rid: str) -> None:
        with self._lock:
            entry = self._replicas.pop(rid, None)
            self._outstanding.pop(rid, None)
        if entry:
            for c in entry["channels"]:
                c.close()

    def call(self, method: str, args, kwargs, model_id: str = "", timeout=None):
        """Direct call; raises _DirectUnavailable when no channel works (the
        caller falls back to the handle path). A channel that breaks AFTER
        the replica's started-marker is torn work: surfaced as a typed
        ReplicaDiedError, never silently re-executed."""
        import time

        from ray_tpu_torch.serve.exceptions import ReplicaDiedError, ReplicaDrainingError

        if time.monotonic() - self._last_refresh > self.REFRESH_PERIOD_S:
            self.refresh()
        for _ in range(3):
            picked = self._pick()
            if picked is None:
                break
            rid, chan = picked
            try:
                try:
                    return chan.call(method, args, kwargs, model_id, timeout=timeout)
                finally:
                    self._done(rid)
            except ReplicaDrainingError:
                # replica alive but refusing new work: request never started,
                # retry on another replica immediately
                self._mark_draining(rid)
            except _ChannelBroken as e:
                self._evict(rid)
                if getattr(e, "timed_out", False):
                    # slow request, not a dead replica: typed timeout (the
                    # proxy maps it to 504). The channel itself is gone —
                    # its framing can't be trusted — but the replica
                    # re-enters the pool on the next refresh.
                    from ray_tpu_torch.serve.exceptions import RequestTimeoutError

                    raise RequestTimeoutError(
                        getattr(self._handle, "deployment_name", ""),
                        method,
                        timeout or DirectChannel.CALL_TIMEOUT_S,
                    ) from e
                if getattr(e, "started", False):
                    raise ReplicaDiedError(
                        deployment=getattr(self._handle, "deployment_name", ""),
                        app=getattr(self._handle, "app_name", ""),
                        method=method,
                        replica_id=rid,
                        started=True,
                        reason=str(e),
                    ) from e
        raise _DirectUnavailable()

    def call_streaming(self, method: str, args, kwargs, model_id: str = ""):
        from ray_tpu_torch.serve.exceptions import ReplicaDiedError, ReplicaDrainingError

        for _ in range(3):
            picked = self._pick()
            if picked is None:
                raise _DirectUnavailable()
            rid, chan = picked
            try:
                try:
                    yield from chan.call_streaming(method, args, kwargs, model_id)
                    return
                finally:
                    self._done(rid)
            except ReplicaDrainingError:
                self._mark_draining(rid)  # nothing sent: pick another replica
            except _ChannelBroken as e:
                self._evict(rid)
                if getattr(e, "timed_out", False):
                    from ray_tpu_torch.serve.exceptions import RequestTimeoutError

                    raise RequestTimeoutError(
                        getattr(self._handle, "deployment_name", ""),
                        method,
                        DirectChannel.STREAM_FRAME_TIMEOUT_S,
                    ) from e
                if getattr(e, "started", False) or getattr(e, "items_sent", 0):
                    # the stream had begun (possibly with chunks already
                    # relayed to the client): typed torn-stream error
                    raise ReplicaDiedError(
                        deployment=getattr(self._handle, "deployment_name", ""),
                        app=getattr(self._handle, "app_name", ""),
                        method=method,
                        replica_id=rid,
                        started=True,
                        reason=str(e),
                    ) from e
                raise _DirectUnavailable()
        raise _DirectUnavailable()

    def open_dedicated(self):
        """Dial a FRESH connection to one replica for a long-lived
        bidirectional session (websocket). Not pooled — the caller owns and
        closes it; the replica dedicates its serving thread to the session.
        Raises _DirectUnavailable when no replica answers."""
        import random
        import time

        if time.monotonic() - self._last_refresh > self.REFRESH_PERIOD_S:
            self.refresh()
        with self._lock:
            addrs = [
                e["addr"]
                for rid, e in self._replicas.items()
                if rid not in self._draining
            ]
        random.shuffle(addrs)
        from ray_tpu_torch._private.object_transfer import _dial

        for addr in addrs:
            try:
                return _dial(addr, self._auth)
            except Exception:
                continue
        raise _DirectUnavailable()

    def close(self):
        with self._lock:
            entries = list(self._replicas.values())
            self._replicas.clear()
        for entry in entries:
            for c in entry["channels"]:
                c.close()


class _ChannelBroken(Exception):
    """Transport-level failure on a direct channel (distinct from user
    exceptions, which may themselves subclass OSError). ``started`` /
    ``items_sent`` carry the replica's started-marker state at the break."""

    started: bool = False
    items_sent: int = 0


class _DirectUnavailable(Exception):
    pass
