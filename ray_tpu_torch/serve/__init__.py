"""ray_tpu_torch.serve — online model serving.

reference: python/ray/serve/ (SURVEY §2.3, §3.6): controller reconcile loop,
replica actors, power-of-two-choices routing, HTTP proxy, batching,
queue-depth autoscaling.
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    status,
)
from ray_tpu_torch.serve.asgi import build_asgi_deployment, ingress
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "ingress",
    "build_asgi_deployment",
    "multiplexed",
    "get_multiplexed_model_id",
    "deployment",
    "Deployment",
    "Application",
    "run",
    "delete",
    "shutdown",
    "status",
    "get_app_handle",
    "get_deployment_handle",
    "DeploymentHandle",
    "DeploymentResponse",
    "batch",
    "start_ingress",
    "stop_ingress",
    "build_proxy_deployment",
]


def start_http_proxy(host: str = "127.0.0.1", port: int = 8000):
    """Start the HTTP proxy in this process and route all deployed apps
    (reference: serve.start + ProxyActor)."""
    from ray_tpu_torch.serve._private.proxy import start_proxy

    return start_proxy(host, port)


def add_route(route_prefix: str, handle: DeploymentHandle, *,
              asgi: bool = False):
    """``asgi=True`` mounts a serve.ingress(app) deployment: raw requests
    forwarded, websocket upgrades enabled (reference: serve/api.py:174)."""
    from ray_tpu_torch.serve._private.proxy import register_route

    register_route(route_prefix, handle, asgi=asgi)


def start_rpc_proxy(host: str = "127.0.0.1", port: int = 0):
    """Start the binary RPC ingress sharing the HTTP proxy's route table
    (reference: the gRPC proxy, serve/_private/proxy.py:530)."""
    from ray_tpu_torch.serve._private.rpc_proxy import start_rpc_proxy as _start

    return _start(host, port)


def start_ingress(num_proxies=None, host: str = "127.0.0.1", port: int = 0):
    """Start N HTTP proxies behind one session-affine endpoint and return
    the tier's (host, port).  Scale-out alternative to start_http_proxy:
    SSE clients keep per-client affinity through the rendezvous-hash
    splice tier while admission (429/503 + Retry-After) runs per proxy."""
    from ray_tpu_torch.serve._private.ingress import start_ingress as _start

    return _start(num_proxies, host, port)


def stop_ingress():
    """Stop the ingress tier and its local proxies."""
    from ray_tpu_torch.serve._private.ingress import stop_ingress as _stop

    _stop()


def build_proxy_deployment(num_replicas: int = 2, routes=None,
                           name: str = "http-proxy"):
    """The HTTP proxy as a first-class serve deployment: drain, health
    checks and the utilization surface apply to the proxy tier itself."""
    from ray_tpu_torch.serve._private.ingress import build_proxy_deployment as _b

    return _b(num_replicas, routes, name)
