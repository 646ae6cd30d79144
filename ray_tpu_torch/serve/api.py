"""Serve public API.

reference: python/ray/serve/api.py — @serve.deployment :313, serve.run :665;
client deploy path _private/client.py:253 → controller reconcile.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.serve.handle import DeploymentHandle


class Application:
    """A bound deployment graph node (reference: serve Application from
    Deployment.bind)."""

    def __init__(self, deployment: "Deployment", init_args: tuple, init_kwargs: dict):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs

    def _collect(self, out: List[dict], seen: set) -> dict:
        """DFS over bound arguments; nested Applications become deployments
        and are replaced by handles at replica init."""
        d = self.deployment
        if d.name in seen:
            return {"__serve_handle__": d.name}
        seen.add(d.name)
        args = tuple(
            a._collect(out, seen) if isinstance(a, Application) else a
            for a in self.init_args
        )
        kwargs = {
            k: (v._collect(out, seen) if isinstance(v, Application) else v)
            for k, v in self.init_kwargs.items()
        }
        out.append({
            "name": d.name,
            "serialized_callable": d.serialized_callable,
            "init_args": args,
            "init_kwargs": kwargs,
            "num_replicas": d.num_replicas,
            "max_ongoing_requests": d.max_ongoing_requests,
            "ray_actor_options": d.ray_actor_options,
            "autoscaling_config": d.autoscaling_config,
            "user_config": d.user_config,
            "graceful_shutdown_timeout_s": d.graceful_shutdown_timeout_s,
            "slo_config": d.slo_config,
        })
        return {"__serve_handle__": d.name}


class Deployment:
    """reference: serve/deployment.py Deployment (options, bind)."""

    def __init__(self, target: Union[type, Callable], name: Optional[str] = None,
                 num_replicas: int = 1, max_ongoing_requests: int = 5,
                 ray_actor_options: Optional[dict] = None,
                 autoscaling_config: Optional[dict] = None,
                 user_config: Any = None,
                 graceful_shutdown_timeout_s: float = 20.0,
                 slo_config: Optional[dict] = None):
        self._target = target
        self.name = name or getattr(target, "__name__", "deployment")
        self.num_replicas = num_replicas
        self.max_ongoing_requests = max_ongoing_requests
        self.ray_actor_options = ray_actor_options
        self.autoscaling_config = autoscaling_config
        self.user_config = user_config
        self.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        # per-deployment serving SLO targets (serve/_private/slo.py):
        # {"slo_ttft_ms": .., "slo_itl_ms": .., "slo_availability": ..} —
        # unset keys fall back to the config-wide defaults
        self.slo_config = slo_config

    @property
    def serialized_callable(self) -> bytes:
        import cloudpickle

        return cloudpickle.dumps(self._target)

    def options(self, **kwargs) -> "Deployment":
        merged = dict(
            name=self.name, num_replicas=self.num_replicas,
            max_ongoing_requests=self.max_ongoing_requests,
            ray_actor_options=self.ray_actor_options,
            autoscaling_config=self.autoscaling_config,
            user_config=self.user_config,
            graceful_shutdown_timeout_s=self.graceful_shutdown_timeout_s,
            slo_config=self.slo_config,
        )
        merged.update(kwargs)
        return Deployment(self._target, **merged)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(target=None, **kwargs):
    """@serve.deployment decorator (reference: api.py:313)."""

    def wrap(t):
        return Deployment(t, **kwargs)

    if target is not None and (isinstance(target, type) or callable(target)):
        return wrap(target)
    return wrap


# ---------------------------------------------------------------------------
# run / delete / handles
# ---------------------------------------------------------------------------

def run(app: Application, *, name: str = "default", route_prefix: str = "/",
        blocking: bool = False,
        _local_testing_mode: bool = False) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress deployment
    (reference: api.py:665).  ``_local_testing_mode=True`` runs every
    deployment in-process with no cluster (reference:
    serve/_private/local_testing_mode.py)."""
    if _local_testing_mode:
        from ray_tpu_torch.serve._private.local_testing import run_local

        return run_local(app, name)

    import ray_tpu_torch
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    deployments: List[dict] = []
    app._collect(deployments, set())
    deployments[-1]["is_ingress"] = True  # root of the DFS is appended last
    deployments[-1]["route_prefix"] = route_prefix
    for d in deployments:
        d["app_name"] = name
    controller = get_or_create_controller()
    ray_tpu_torch.get(controller.deploy_application.remote(name, deployments))
    # SLO targets: register locally too (the driver process usually hosts
    # the HTTP proxy — the ingress ledger judges breaches without a KV
    # fetch on the hot path); the controller writes the sloconf KV rows
    # for every other process (state.serving_slo folds against them)
    from ray_tpu_torch.serve._private import slo as _slo

    for d in deployments:
        _slo.register_targets(d["name"], d.get("slo_config"))
    handle = DeploymentHandle(name, deployments[-1]["name"])
    # wait for replicas to come up
    handle._router._refresh()
    # auto-register the HTTP route in THIS process's proxy route table
    # (reference api.py:665 behavior: serve.run makes the app reachable);
    # ASGI ingress deployments (serve/asgi.py) are flagged so the proxy
    # forwards raw requests and allows websocket upgrades
    from ray_tpu_torch.serve._private.proxy import register_route

    is_asgi = bool(getattr(app.deployment._target, "_IS_ASGI", False))
    register_route(route_prefix, handle, asgi=is_asgi)
    _app_routes[name] = route_prefix
    return handle


# app name -> auto-registered route prefix (so delete() can unregister)
_app_routes: Dict[str, str] = {}


def delete(name: str = "default"):
    import ray_tpu_torch
    from ray_tpu_torch.serve._private.controller import get_or_create_controller
    from ray_tpu_torch.serve._private.local_testing import delete_local, get_local_app

    if get_local_app(name) is not None:
        delete_local(name)
        return
    # drop the auto-registered HTTP route: a stale route would forward
    # requests to dead replicas instead of returning 404
    prefix = _app_routes.pop(name, None)
    if prefix is not None:
        from ray_tpu_torch.serve._private.proxy import unregister_route

        unregister_route(prefix)
    ray_tpu_torch.get(get_or_create_controller().delete_application.remote(name))


def get_app_handle(name: str = "default") -> DeploymentHandle:
    import ray_tpu_torch
    from ray_tpu_torch.serve._private.controller import get_or_create_controller
    from ray_tpu_torch.serve._private.local_testing import get_local_app

    local = get_local_app(name)
    if local is not None:
        return local
    if not ray_tpu_torch.is_initialized():
        raise ValueError(f"no serve application named {name!r} "
                         "(no local app, and no cluster connected)")

    controller = get_or_create_controller()
    info = ray_tpu_torch.get(controller.get_deployment_info.remote(name))
    if info is None:
        raise ValueError(f"no serve application named {name!r}")
    return DeploymentHandle(name, info["name"])


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(app_name, deployment_name)


def status() -> Dict[str, Any]:
    import ray_tpu_torch
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    controller = get_or_create_controller()
    apps = ray_tpu_torch.get(controller.list_applications.remote())
    out = {}
    for a in apps:
        info = ray_tpu_torch.get(controller.get_deployment_info.remote(a))
        stats = ray_tpu_torch.get(
            controller.get_deployment_stats.remote(a, info["name"])) if info else []
        out[a] = {"ingress": info["name"] if info else None, "replicas": stats}
    return out


def shutdown():
    import ray_tpu_torch
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME
    from ray_tpu_torch.serve._private.proxy import clear_routes, stop_proxy
    from ray_tpu_torch.serve._private.rpc_proxy import stop_rpc_proxy

    # ingress first: the process-wide proxy (and its executor threads) must
    # not outlive serve — the lane hygiene guard caught 41 leaked
    # proxy-handle threads from a proxy that survived its tests
    for stop in (stop_proxy, stop_rpc_proxy):
        try:
            stop()
        except Exception:  # noqa: BLE001 — shutdown is best-effort; lane hygiene asserts the result
            pass
    clear_routes()
    _app_routes.clear()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001 — controller death races shutdown; both end serve
        pass
