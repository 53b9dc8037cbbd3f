"""The port's serve library (``ray_tpu_torch.serve``: deployments, handles,
the controller, batching, streaming, multiplexing, ``user_config``, the
schema) held against the JAX package's (``ray_tpu.serve``), and the port's
ingress (HTTP, ASGI, WebSocket, gRPC) on ports it picks itself.

One reference runtime and one port runtime start once for the module, and
each deploys the same few applications once; each program then runs through
both packages and the results must be equal (exceptions compare by class
name). The reference side starts no HTTP proxy, so nothing here meets the
reference's fixed port 8700; the port's proxy is made on port 0 before any
route is added. Deployments are defined inside functions, so replicas
unpickle them by value and never import this module (which imports JAX).
Every wait is bounded by ``T``.
"""

import json
import os
import socket
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import ray_tpu
import ray_tpu.serve
import ray_tpu_torch
import ray_tpu_torch.serve

T = 30  # every wait's timeout, in seconds


def _build_apps(S):
    """The module's applications for one serve package ``S``."""

    @S.deployment
    def fn(payload=None):
        return {"echo": payload}

    @S.deployment
    class Counter:
        def __init__(self, start):
            self.v = start

        def __call__(self, k=1):
            self.v += k
            return self.v

        def value(self):
            return self.v

    @S.deployment(max_ongoing_requests=8)
    class Batched:
        def __init__(self):
            self.sizes = []

        @S.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, items):
            self.sizes.append(len(items))
            return [i * 10 for i in items]

        def batch_sizes(self):
            return self.sizes

    @S.deployment
    class Streamer:
        def __call__(self, n):
            for i in range(n):
                yield i * 3

    @S.deployment
    class MultiModel:
        @S.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            return f"model:{model_id}"

        def __call__(self, x):
            return f"{self.get_model(S.get_multiplexed_model_id())}+{x}"

    @S.deployment(num_replicas=2)
    class WhoAmI:
        def __call__(self):
            import os

            return os.getpid()

    @S.deployment
    class Pre:
        def __call__(self, x):
            return x * 2

    @S.deployment
    class Router:
        """The ingress: composition through a handle, bytes in and out, a
        user error."""

        def __init__(self, pre, **children):
            self.pre = pre

        def __call__(self, x):
            if isinstance(x, bytes):
                return x.upper()
            if isinstance(x, dict):
                return {"n": x.get("n", 0) * 2}
            return self.pre.remote(x).result(timeout_s=30) + 1

        def boom(self):
            raise ValueError("nope")

    @S.deployment(num_replicas=1, max_ongoing_requests=1, shed_queue_factor=2.0,
                  shed_retry_after_s=3.0, health_check_period_s=30.0)
    class Slow:
        def __call__(self, p=None):
            import time

            time.sleep(0.5)
            return "ok"

    @S.deployment(user_config={"threshold": 1})
    class Configurable:
        def __init__(self):
            import os

            self.threshold = None
            self.pid = os.getpid()

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self):
            return {"threshold": self.threshold, "pid": self.pid}

    main = Router.bind(Pre.bind(), fn=fn.bind(), counter=Counter.bind(10),
                       batched=Batched.bind(), streamer=Streamer.bind(),
                       mux=MultiModel.bind(), who=WhoAmI.bind())
    return {"main": main, "shed": Slow.bind(), "cfg": Configurable.bind(),
            "Configurable": Configurable}


@pytest.fixture(scope="module")
def serves():
    for R in (ray_tpu, ray_tpu_torch):
        if R.is_initialized():
            R.shutdown()
    out = {}
    try:
        # the fewest CPUs the programs need, and no prestarted workers
        ray_tpu.init(num_cpus=2, _system_config={"prestart_workers": False})
        ray_tpu_torch.init(num_cpus=2, _system_config={"prestart_workers": False})
        for key, S in (("ref", ray_tpu.serve), ("port", ray_tpu_torch.serve)):
            apps = _build_apps(S)
            for name in ("main", "shed", "cfg"):
                S.run(apps[name], name=name)
            out[key] = (S, apps)
        yield out
    finally:
        for S in (ray_tpu_torch.serve, ray_tpu.serve):
            S.shutdown()
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _dep(S, name, app="main"):
    return S.get_deployment_handle(name, app)


def _exc_name(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class name is the result
        return type(e).__name__
    return None


# -- the programs: each returns what both packages must agree on --------------


def prog_function(S, apps):
    return _dep(S, "fn").remote({"x": 1}).result(timeout_s=T)


def prog_class_methods(S, apps):
    h = _dep(S, "Counter")
    return h.remote(5).result(timeout_s=T), h.value.remote().result(timeout_s=T)


def prog_composition(S, apps):
    h = S.get_app_handle("main")
    return h.remote(10).result(timeout_s=T), _exc_name(
        lambda: h.boom.remote().result(timeout_s=T))


def prog_batch(S, apps):
    h = _dep(S, "Batched")
    responses = [h.remote(i) for i in range(8)]
    out = sorted(r.result(timeout_s=T) for r in responses)
    return out, max(h.batch_sizes.remote().result(timeout_s=T)) > 1


def prog_stream(S, apps):
    return list(_dep(S, "Streamer").options(stream=True, stream_item_timeout_s=T).remote(4))


def prog_multiplexed(S, apps):
    h = _dep(S, "MultiModel")
    return [h.options(multiplexed_model_id=m).remote(i).result(timeout_s=T)
            for i, m in enumerate(["a", "b", "a", "c"])]


def prog_two_replicas(S, apps):
    h = _dep(S, "WhoAmI")
    return len({h.remote().result(timeout_s=T) for _ in range(20)})


def prog_user_config(S, apps):
    first = S.get_app_handle("cfg").remote().result(timeout_s=T)
    h = S.run(apps["Configurable"].options(user_config={"threshold": 7}).bind(), name="cfg")
    second = h.remote().result(timeout_s=T)
    return first["threshold"], second["threshold"], second["pid"] == first["pid"]


def prog_overload(S, apps):
    """Capacity 1 replica x 1 ongoing x factor 2: the third concurrent call
    sheds, typed, with the deployment's retry-after."""
    h = S.get_app_handle("shed")
    ok, shed = [], []
    for _ in range(6):
        try:
            ok.append(h.remote())
        except S.DeploymentOverloadedError as e:
            shed.append(e)
    return (len(ok), len(shed), shed[0].retry_after_s, type(shed[0]).__name__,
            [r.result(timeout_s=T) for r in ok])


def prog_status_delete(S, apps):
    @S.deployment(num_replicas=2)
    def f(p=None):
        return 1

    S.run(f.bind(), name="tmp")
    st = S.status()
    entry = st["tmp"]["f"]
    shape = (sorted(entry), entry["num_replicas"], entry["target"], entry["health"],
             entry["draining"], sorted(entry["config"]), sorted(st["main"]))
    S.delete("tmp")
    gone = _exc_name(lambda: S.get_app_handle("tmp"))
    return shape, gone, "tmp" in S.status()


def prog_schema(S, apps, tmp_dir):
    """``build`` -> YAML -> ``deploy_config_file`` with an override. The bound
    app is reached through an import path into a module object of its own."""

    @S.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

    @S.deployment
    class Ingress:
        def __init__(self, d):
            self.d = d

        def __call__(self, x):
            return self.d.remote(x).result(timeout_s=30) + 1

    mod_name = f"_serve_schema_app_{S.__name__.split('.')[0]}"
    mod = types.ModuleType(mod_name)
    mod.app = Ingress.bind(Doubler.bind())
    sys.modules[mod_name] = mod
    try:
        config = S.build(mod.app, name="cfgapp", import_path=f"{mod_name}:app")
        for d in config["applications"][0]["deployments"]:
            if d["name"] == "Doubler":
                d["num_replicas"] = 2
        path = os.path.join(tmp_dir, f"{mod_name}.yaml")
        S.dump_config(config, path)
        handles = S.deploy_config_file(path)
        out = (sorted(d["name"] for d in config["applications"][0]["deployments"]),
               S.status()["cfgapp"]["Doubler"]["num_replicas"],
               handles["cfgapp"].remote(20).result(timeout_s=T))
        S.delete("cfgapp")
    finally:
        del sys.modules[mod_name]
    return out


PROGRAMS = [prog_function, prog_class_methods, prog_composition, prog_batch, prog_stream,
            prog_multiplexed, prog_two_replicas, prog_user_config, prog_overload,
            prog_status_delete]


@pytest.mark.parametrize("prog", PROGRAMS, ids=[p.__name__ for p in PROGRAMS])
def test_program_same_through_both_packages(serves, prog):
    ref = prog(*serves["ref"])
    port = prog(*serves["port"])
    assert port == ref


def test_schema_same_through_both_packages(serves, tmp_path):
    ref = prog_schema(*serves["ref"], str(tmp_path))
    port = prog_schema(*serves["port"], str(tmp_path))
    assert port == ref == (["Doubler", "Ingress"], 2, 41)


def test_program_results_expected(serves):
    """The shared results are also the right ones (not merely equal)."""
    S, apps = serves["port"]
    assert prog_function(S, apps) == {"echo": {"x": 1}}
    assert prog_stream(S, apps) == [0, 3, 6, 9]
    assert prog_multiplexed(S, apps) == ["model:a+0", "model:b+1", "model:a+2", "model:c+3"]
    assert prog_two_replicas(S, apps) == 2


def test_exports_match_the_reference():
    want = set(ray_tpu.serve.__all__)
    assert want <= set(ray_tpu_torch.serve.__all__)
    for name in want:
        assert getattr(ray_tpu_torch.serve, name) is not None
    from ray_tpu_torch.serve.llm import llm_deployment

    assert callable(llm_deployment)


# -- the port's ingress, on ports it picks itself ----------------------------


@pytest.fixture(scope="module")
def proxy(serves):
    """The port's HTTP proxy, made on an ephemeral port before any route is
    added (``ensure_proxy`` then finds it), with routes to the module's
    apps. Returns its (host, port)."""
    from ray_tpu_torch.serve._proxy import _PROXY_NAME, HTTPProxy, ensure_proxy
    from ray_tpu_torch.serve.api import _get_or_create_controller

    actor = HTTPProxy.options(name=_PROXY_NAME, num_cpus=0).remote(0)
    controller = _get_or_create_controller()
    for app in ("main", "shed"):
        ensure_proxy(controller, app, f"/{app}")
    return tuple(ray_tpu_torch.get(actor.address.remote(), timeout=T))


def _http(host, port, method, path, body=b"", headers=None, n=1):
    """Raw HTTP/1.1 client: n requests on ONE socket (keep-alive). Returns
    [(status, headers, body)]."""
    out = []
    s = socket.create_connection((host, port), timeout=T)
    try:
        f = s.makefile("rb")
        for _ in range(n):
            hdrs = {"Host": host, "Content-Length": str(len(body)), **(headers or {})}
            head = f"{method} {path} HTTP/1.1\r\n" + "".join(
                f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n"
            s.sendall(head.encode() + body)
            status = int(f.readline().split()[1])
            resp = {}
            while True:
                line = f.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode().partition(":")
                resp[k.strip().lower()] = v.strip()
            if resp.get("transfer-encoding") == "chunked":
                chunks = []
                while True:
                    size = int(f.readline().strip(), 16)
                    if size == 0:
                        f.readline()
                        break
                    chunks.append(f.read(size))
                    f.readline()
                payload = b"".join(chunks)
            else:
                payload = f.read(int(resp.get("content-length", 0)))
            out.append((status, resp, payload))
    finally:
        s.close()
    return out


def test_http_json_raw_and_keep_alive(serves, proxy):
    """JSON and raw bodies through the port's proxy equal the reference's
    handle results on the same ingress; four requests share one socket."""
    ref = ray_tpu.serve.get_app_handle("main")
    host, port = proxy
    want = ref.remote(10).result(timeout_s=T)
    [(status, _, body)] = _http(host, port, "POST", "/main", b"10",
                                headers={"Content-Type": "application/json"})
    assert status == 200 and json.loads(body) == {"result": want}

    raw = b"\x00binary\xffdata"
    [(status, hdrs, body)] = _http(host, port, "POST", "/main", raw,
                                   headers={"Content-Type": "application/octet-stream"})
    assert status == 200 and hdrs["content-type"] == "application/octet-stream"
    assert body == ref.remote(raw).result(timeout_s=T)

    want = ref.remote({"n": 5}).result(timeout_s=T)
    multi = _http(host, port, "POST", "/main", json.dumps({"n": 5}).encode(),
                  headers={"Content-Type": "application/json"}, n=4)
    assert [json.loads(b)["result"] for _, _, b in multi] == [want] * 4
    [(status, _, _)] = _http(host, port, "GET", "/nope")
    assert status == 404


def test_http_shed_is_503_with_retry_after(serves, proxy):
    host, port = proxy
    statuses = []
    lock = threading.Lock()

    def post():
        t0 = time.monotonic()
        req = urllib.request.Request(f"http://{host}:{port}/shed", data=b"null",
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=T) as r:
                got = (r.status, None)
        except urllib.error.HTTPError as e:
            got = (e.code, e.headers.get("Retry-After"))
        with lock:
            statuses.append((*got, time.monotonic() - t0))

    threads = [threading.Thread(target=post) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
    codes = [s for s, _, _ in statuses]
    assert len(codes) == 8 and set(codes) == {200, 503}, statuses
    for s, retry_after, dt in statuses:
        if s == 503:
            assert retry_after == "3" and dt < 5.0  # a fast, typed shed


def test_asgi_app_and_websocket_echo(serves, proxy):
    """One ASGI app mounted with ``serve.ingress``: routed responses, a
    chunked stream, and a WebSocket session (text, binary, ping, close)."""
    S = ray_tpu_torch.serve
    from ray_tpu_torch.serve._proxy import ensure_proxy
    from ray_tpu_torch.serve._ws import WSClient
    from ray_tpu_torch.serve.api import _get_or_create_controller

    async def app(scope, receive, send):
        if scope["type"] == "websocket":
            await receive()  # websocket.connect
            sub = scope["subprotocols"][0] if scope["subprotocols"] else None
            await send({"type": "websocket.accept", "subprotocol": sub})
            while True:
                msg = await receive()
                if msg["type"] == "websocket.disconnect":
                    return
                if msg.get("text") == "quit":
                    await send({"type": "websocket.close", "code": 4001, "reason": "bye"})
                    return
                if msg.get("text") is not None:
                    await send({"type": "websocket.send", "text": msg["text"].upper()})
                else:
                    await send({"type": "websocket.send", "bytes": msg["bytes"][::-1]})
        if scope["path"].endswith("/stream"):
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type", b"text/plain")]})
            for i in range(3):
                await send({"type": "http.response.body", "body": f"chunk-{i};".encode(),
                            "more_body": True})
            await send({"type": "http.response.body", "body": b"done", "more_body": False})
            return
        body = (await receive()).get("body", b"")
        await send({"type": "http.response.start", "status": 201,
                    "headers": [(b"content-type", b"application/x-custom"),
                                (b"x-echo-len", str(len(body)).encode())]})
        await send({"type": "http.response.body", "body": b"asgi:" + body[::-1],
                    "more_body": False})

    @S.deployment
    @S.ingress(app)
    class AsgiD:
        pass

    S.run(AsgiD.bind(), name="asgi")
    ensure_proxy(_get_or_create_controller(), "asgi", "/asgi")
    host, port = proxy
    [(status, hdrs, body)] = _http(host, port, "POST", "/asgi/echo", b"hello")
    assert (status, hdrs["content-type"], hdrs["x-echo-len"], body) == (
        201, "application/x-custom", "5", b"asgi:olleh")
    [(status, hdrs, body)] = _http(host, port, "GET", "/asgi/stream")
    assert status == 200 and hdrs.get("transfer-encoding") == "chunked"
    assert body == b"chunk-0;chunk-1;chunk-2;done"

    c = WSClient(host, port, "/asgi/chat", subprotocols=("chat", "alt"))
    try:
        assert c.subprotocol == "chat"
        c.send_text("hello")
        assert c.recv() == "HELLO"
        c.send_bytes(b"\x01\x02\x03")
        assert c.recv() == b"\x03\x02\x01"
        c.ping(b"p")
        assert c.recv() == ("pong", b"p")
        c.send_text("quit")
        assert c.recv() == ("close", 4001, "bye")
    finally:
        c.close()
    S.delete("asgi")


def test_grpc_predict_equals_reference_handle(serves):
    S = ray_tpu_torch.serve
    port = S.start_grpc_proxy()
    assert port > 0
    want = ray_tpu.serve.get_app_handle("main").remote(10).result(timeout_s=T)
    assert S.grpc_predict(f"127.0.0.1:{port}", 10, application="main", timeout_s=T) == want
    # a bad signature is refused before anything is unpickled
    import pickle

    import grpc

    from ray_tpu_torch.serve._grpc_proxy import SERVICE_METHOD

    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        with pytest.raises(grpc.RpcError) as err:
            channel.unary_unary(SERVICE_METHOD)(pickle.dumps("unsigned"), timeout=T)
        assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
    finally:
        channel.close()


def test_proxy_raises_on_a_taken_port(serves):
    """A proxy whose listener cannot bind fails its constructor (it does not
    wait and live on without a server), and the port's default is not the
    reference's."""
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.serve._proxy import DEFAULT_PORT, HTTPProxy

    assert DEFAULT_PORT != 8700
    held = socket.socket()
    try:
        held.bind(("127.0.0.1", 0))
        held.listen()
        taken = held.getsockname()[1]
        t0 = time.monotonic()
        actor = HTTPProxy.options(num_cpus=0).remote(taken)
        with pytest.raises(ActorDiedError):
            ray_tpu_torch.get(actor.address.remote(), timeout=T)
        assert time.monotonic() - t0 < 20
    finally:
        held.close()
