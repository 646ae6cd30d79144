"""The port's serve control plane (``ray_tpu_torch.serve``) on the port's
runtime, on the CPU: the cases of ``tests/test_serve.py`` and
``tests/test_serve_modes.py`` on one module cluster (4 CPUs, 2 fake GPUs).

- a function and a stateful class deployed; two replicas routed over; a
  method through ``options``; a deployment composed over a nested handle;
  a rolling redeploy and a delete;
- the HTTP proxy end to end, a chunked body and keep-alive;
- ``@serve.batch`` and ``@serve.multiplexed``;
- local testing mode (in process, no cluster), and the RPC proxy;
- ``LLMConfig.resources_per_replica``: a CUDA replica holds its cards as
  ``GPU`` (a fraction shares one), a CPU one holds none;
- the pool autoscaler's scale-down pass is inert (``utilization_headroom``
  reads the state API, which is not ported).
"""

import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.llm.config import LLMConfig

pytestmark = pytest.mark.timeout(120)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, num_gpus=2)
    try:
        yield
    finally:
        serve.shutdown()
        rt.shutdown()


@pytest.fixture(scope="module")
def proxy(cluster):
    """The HTTP proxy in this process: (host, port)."""
    return serve.start_http_proxy(port=0)


def _post(proxy, path, payload):
    host, port = proxy
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _wait_for(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)


@serve.deployment
def _square(x):
    return x * x


@serve.deployment(num_replicas=1)
class _Counter:
    def __init__(self, start):
        self.n = start

    def __call__(self, inc):
        self.n += inc
        return self.n


@pytest.mark.parametrize("kind", ["function", "class"])
def test_deploy_and_call(cluster, kind):
    if kind == "function":
        handle = serve.run(_square.bind(), name="fn")
        assert handle.remote(7).result(timeout_s=60) == 49
    else:
        handle = serve.run(_Counter.bind(10), name="counter")
        assert handle.remote(1).result(timeout_s=60) == 11
        assert handle.remote(2).result(timeout_s=60) == 13


def test_multiple_replicas_route(cluster):
    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.1})
    class Who:
        def __call__(self, _):
            return os.getpid()

    handle = serve.run(Who.bind(), name="who")
    pids = {handle.remote(None).result(timeout_s=60) for _ in range(12)}
    assert pids and os.getpid() not in pids
    assert len(serve.status()["who"]["replicas"]) == 2
    serve.delete("who")


def test_method_call_via_options(cluster):
    @serve.deployment
    class Calc:
        def add(self, ab):
            return ab[0] + ab[1]

        def mul(self, ab):
            return ab[0] * ab[1]

    handle = serve.run(Calc.bind(), name="calc")
    assert handle.add.remote((2, 3)).result(timeout_s=60) == 5
    assert handle.options(method_name="mul").remote(
        (2, 3)).result(timeout_s=60) == 6
    serve.delete("calc")


def test_model_composition_nested_handles(cluster):
    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            return self.pre.remote(x).result(timeout_s=60) * 10

    handle = serve.run(Model.bind(Preprocess.bind()), name="composed")
    assert handle.remote(4).result(timeout_s=60) == 50
    serve.delete("composed")


def test_redeploy_then_delete(cluster):
    @serve.deployment
    def v1(x):
        return "v1"

    @serve.deployment
    def v2(x):
        return "v2"

    h1 = serve.run(v1.bind(), name="versions")
    assert h1.remote(None).result(timeout_s=60) == "v1"
    h2 = serve.run(v2.options(name="v1").bind(), name="versions")
    # rolling redeploy: the old version serves until the new replica
    # passes its health gate, then the router flips
    _wait_for(lambda: h2.remote(None).result(timeout_s=60) == "v2",
              "the redeploy's flip")
    serve.delete("versions")
    _wait_for(lambda: "versions" not in serve.status(), "the delete")


def test_http_proxy_end_to_end(cluster, proxy):
    @serve.deployment
    def echo(payload):
        return {"got": payload}

    serve.run(echo.bind(), name="echo", route_prefix="/echo")
    assert _post(proxy, "/echo", {"a": 1}) == {"got": {"a": 1}}


def test_http_proxy_chunked_body_keepalive(cluster, proxy):
    """A chunked body is read in full and keep-alive framing survives: the
    second request on the same connection is answered too."""
    @serve.deployment
    def echo(payload):
        return {"got": payload}

    serve.run(echo.bind(), name="echoc", route_prefix="/echoc")
    payload = json.dumps({"a": 1}).encode()
    half = len(payload) // 2
    chunked = (f"{half:x}\r\n".encode() + payload[:half] + b"\r\n"
               + f"{len(payload) - half:x}\r\n".encode() + payload[half:]
               + b"\r\n0\r\n\r\n")
    with socket.create_connection(proxy, timeout=60) as s:
        s.sendall(b"POST /echoc HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n" + chunked)
        s.sendall(b"POST /echoc HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(payload)}\r\n\r\n".encode()
                  + payload)
        buf = b""
        deadline = time.monotonic() + 60
        while buf.count(b'{"got"') < 2 and time.monotonic() < deadline:
            s.settimeout(max(0.1, deadline - time.monotonic()))
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    assert buf.count(b"HTTP/1.1 200") == 2, buf[:500]
    assert buf.count(json.dumps({"got": {"a": 1}}).encode()) == 2


def test_batching(cluster):
    @serve.deployment
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def __call__(self, xs):
            return [x * 2 for x in xs]

    handle = serve.run(Batched.bind(), name="batched")
    responses = [handle.remote(i) for i in range(8)]
    assert sorted(r.result(timeout_s=60) for r in responses) == [
        2 * i for i in range(8)]
    serve.delete("batched")


def test_multiplexed_model_loading(cluster):
    @serve.deployment
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id, "scale": int(model_id[-1])}

        def __call__(self, req):
            model = self.get_model(req["model"])
            assert serve.get_multiplexed_model_id() == req["model"]
            return {"y": model["scale"] * req["x"],
                    "loads": list(self.loads)}

    handle = serve.run(MultiModel.bind(), name="mux")
    assert handle.remote({"model": "m1", "x": 5}).result(
        timeout_s=60)["y"] == 5
    r2 = handle.remote({"model": "m1", "x": 7}).result(timeout_s=60)
    assert r2["y"] == 7 and r2["loads"].count("m1") == 1  # cached
    handle.remote({"model": "m2", "x": 1}).result(timeout_s=60)
    handle.remote({"model": "m3", "x": 1}).result(timeout_s=60)  # evicts m1
    r4 = handle.remote({"model": "m1", "x": 2}).result(timeout_s=60)
    assert r4["loads"].count("m1") == 2  # loaded again after eviction
    serve.delete("mux")


@pytest.mark.parametrize("kind", ["class", "function"])
def test_local_testing_mode(kind):
    """Every deployment runs in this process: no replica, no cluster."""
    if kind == "function":
        handle = serve.run(_square.bind(), name="local-fn",
                           _local_testing_mode=True)
        assert handle.remote(7).result() == 49
        serve.delete("local-fn")
        return

    @serve.deployment
    class Preprocessor:
        def __call__(self, x):
            return x * 2

    @serve.deployment(user_config={"bias": 10})
    class Model:
        def __init__(self, pre):
            self.pre = pre
            self.bias = 0

        def reconfigure(self, cfg):
            self.bias = cfg["bias"]

        def __call__(self, x):
            return self.pre.remote(x).result() + self.bias

        def pid(self):
            return os.getpid()

    handle = serve.run(Model.bind(Preprocessor.bind()), name="local",
                       _local_testing_mode=True)
    assert handle.remote(5).result() == 20  # 5 * 2 + 10 (user_config)
    assert handle.options(method_name="pid").remote().result() == os.getpid()
    assert serve.get_app_handle("local").remote(1).result() == 12
    serve.delete("local")
    with pytest.raises(ValueError):
        serve.get_app_handle("local")


def test_rpc_proxy_roundtrips_python_values(cluster):
    from ray_tpu_torch.serve._private.rpc_proxy import (
        ServeRpcClient,
        stop_rpc_proxy,
    )

    @serve.deployment
    class Echo:
        def __call__(self, arr, scale=1.0):
            return {"sum": float(np.asarray(arr).sum() * scale),
                    "shape": np.asarray(arr).shape}

        def meta(self):
            return "echo-meta"

    serve.run(Echo.bind(), name="rpc", route_prefix="/rpc")
    client = ServeRpcClient(serve.start_rpc_proxy())
    try:
        assert "/rpc" in client.routes()
        out = client.call("/rpc", np.arange(6).reshape(2, 3), scale=2.0)
        assert out == {"sum": 30.0, "shape": (2, 3)}
        assert client.call("/rpc", method="meta") == "echo-meta"
        with pytest.raises(Exception):
            client.call("/nosuchroute!", 1)
    finally:
        client.close()
        stop_rpc_proxy()
        serve.delete("rpc")


@pytest.mark.parametrize("chips,device,want", [
    (None, None, {"CPU": 1.0, "GPU": 1.0}),
    (0.5, None, {"CPU": 1.0, "GPU": 0.5}),
    (2, "cuda", {"CPU": 1.0, "GPU": 2.0}),
    (None, "cpu", {"CPU": 1.0}),
    (0.5, "cpu", {"CPU": 1.0}),
])
def test_resources_per_replica(chips, device, want):
    """Unlike the reference (no accelerator at one chip), a CUDA replica
    holds its cards, so the scheduler counts it and its lease binds
    CUDA_VISIBLE_DEVICES; a CPU replica holds none."""
    conf = LLMConfig(chips_per_replica=chips)
    assert conf.resources_per_replica(device) == want


@pytest.mark.parametrize("chips", [1, 0.5])
def test_replica_holds_its_gpu_share(cluster, chips):
    """Replicas sized by resources_per_replica hold GPU in the scheduler
    and see the card their lease binds; two at 0.5 share one card."""
    @serve.deployment(num_replicas=2, ray_actor_options={
        "resources": LLMConfig(chips_per_replica=chips
                               ).resources_per_replica()})
    class Card:
        def __call__(self, _):
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    tuple(rt.get_gpu_ids()))

    before = rt.available_resources().get("GPU")
    handle = serve.run(Card.bind(), name=f"card{chips}")
    _wait_for(lambda: len(serve.status()[f"card{chips}"]["replicas"]) == 2,
              "two replicas")
    _wait_for(lambda: rt.available_resources().get("GPU", 0.0)
              == before - 2 * chips, "the replicas' GPU held")
    seen = {handle.remote(None).result(timeout_s=60) for _ in range(16)}
    assert all(env == ",".join(map(str, ids)) and len(ids) == 1
               for env, ids in seen)
    serve.delete(f"card{chips}")
    _wait_for(lambda: rt.available_resources().get("GPU") == before,
              "the cards back")


def test_pool_scale_down_is_inert():
    """The default headroom source has no utilization fold to read, so a
    pool whose alert cleared is never shrunk (unknown means never)."""
    from ray_tpu_torch.serve._private import pool_autoscaler as pa

    assert pa.utilization_headroom("llm-decode") is None
    acts, now = [], [0.0]

    class Cfg:
        serve_pool_autoscaler_enabled = True
        serve_pool_scale_step = 1
        serve_pool_scale_cooldown_s = 0.0
        serve_pool_min_replicas = 1
        serve_pool_max_replicas = 8
        serve_pool_scale_down_headroom = 0.9

    scaler = pa.PoolAutoscaler(
        actuate=lambda dep, n: acts.append((dep, n)),
        current=lambda dep: 4, config=Cfg(), clock=lambda: now[0],
        headroom_source=pa.utilization_headroom)
    for state in ("firing", "cleared"):
        scaler.on_alert({"rule": "serve_itl_burn", "state": state,
                         "key": "deployment=llm", "value": 3.0})
    assert acts == [("llm-decode", 5)]  # the burn scaled it up
    for _ in range(5):
        now[0] += 60.0
        scaler.tick()
    assert acts == [("llm-decode", 5)]  # and nothing shrank it
