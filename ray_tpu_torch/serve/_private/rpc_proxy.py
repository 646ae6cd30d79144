"""Binary RPC ingress for serve apps (the reference's gRPC proxy analog).

reference: python/ray/serve/_private/proxy.py:530 (gRPCProxy) — a second,
non-HTTP ingress sharing the HTTP proxy's route table.  grpc isn't in this
image, so the proxy rides the framework's length-prefixed RPC transport
(ray_tpu_torch/_private/rpc.py) and carries pickled args/results, which lets
callers pass arbitrary Python values (numpy arrays, dataclasses) that the
JSON HTTP path can't.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.rpc import RpcClient, RpcServer

from ray_tpu_torch.serve._private import proxy as http_proxy


class ServeRpcProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = RpcServer(host=host, port=port)
        self._server.register("ServeRequest", self.HandleServeRequest)
        self._server.register("ServeRoutes", self.HandleServeRoutes)

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.address

    def shutdown(self):
        self._server.shutdown()

    # ------------------------------------------------------------------

    def HandleServeRequest(self, payload, reply_token):
        handle = http_proxy.match_route(payload["route"])
        if handle is None:
            raise ValueError(f"no serve route matches {payload['route']!r}")
        if payload.get("method") and payload["method"] != "__call__":
            handle = handle.options(method_name=payload["method"])
        args, kwargs = serialization.loads_inline(payload["args"])
        response = handle.remote(*args, **kwargs)
        server = self._server

        # resolve off the handler thread; reply when the replica answers
        def wait():
            try:
                server.send_reply(
                    reply_token,
                    serialization.dumps_inline(
                        response.result(timeout_s=payload.get("timeout", 60))))
            except Exception as e:  # noqa: BLE001
                server.send_error_reply(reply_token, e)

        threading.Thread(target=wait, daemon=True,
                         name="serve-rpc-wait").start()
        return RpcServer.DELAYED_REPLY

    def HandleServeRoutes(self, payload):
        return http_proxy.list_routes()


_rpc_proxy: Optional[ServeRpcProxy] = None
_lock = threading.Lock()


def start_rpc_proxy(host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
    global _rpc_proxy
    with _lock:
        if _rpc_proxy is None:
            _rpc_proxy = ServeRpcProxy(host, port)
        return _rpc_proxy.address


def stop_rpc_proxy():
    global _rpc_proxy
    with _lock:
        if _rpc_proxy is not None:
            _rpc_proxy.shutdown()
            _rpc_proxy = None


class ServeRpcClient:
    """Client for the RPC ingress: call(route, *args) -> python value."""

    def __init__(self, address: Tuple[str, int]):
        self._rpc = RpcClient(tuple(address))

    def call(self, route: str, *args, method: str = "__call__",
             timeout: float = 60, **kwargs) -> Any:
        blob = self._rpc.call("ServeRequest", {
            "route": route, "method": method,
            "args": serialization.dumps_inline((args, kwargs)),
            "timeout": timeout,
        }, timeout=timeout + 10)
        return serialization.loads_inline(blob)

    def routes(self):
        return self._rpc.call("ServeRoutes", {})

    def close(self):
        self._rpc.close()
