"""Local testing mode: run a serve app without any cluster.

reference: python/ray/serve/_private/local_testing_mode.py — `serve.run(app,
_local_testing_mode=True)` instantiates every deployment in-process, wires
nested bound deployments as local handles, and returns a handle whose
`.remote()` resolves on a thread pool.  Tests and notebooks exercise the
exact deployment graph with zero actors.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()
_local_apps: Dict[str, "LocalDeploymentHandle"] = {}


def _executor() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=16,
                                       thread_name_prefix="serve-local")
        return _pool


class LocalDeploymentResponse:
    """Future-like mirror of DeploymentResponse (same .result() surface)."""

    def __init__(self, fut: Future):
        self._fut = fut

    def result(self, timeout_s: Optional[float] = None):
        return self._fut.result(timeout=timeout_s)

    @property
    def ref(self):
        return self._fut


class LocalDeploymentHandle:
    """Drives one in-process deployment instance (DeploymentHandle mirror)."""

    def __init__(self, instance: Any, name: str, method_name: str = "__call__",
                 stream: bool = False):
        self._instance = instance
        self._name = name
        self._method = method_name
        self._stream = stream

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None) -> "LocalDeploymentHandle":
        return LocalDeploymentHandle(
            self._instance, self._name,
            method_name if method_name is not None else self._method,
            stream if stream is not None else self._stream)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def remote(self, *args, **kwargs):
        if self._method == "__call__":
            target = self._instance
            if not callable(target):
                raise TypeError(f"deployment {self._name!r} instance "
                                "is not callable")
        else:
            target = getattr(self._instance, self._method)
        if self._stream:
            out = target(*args, **kwargs)
            return iter(out) if hasattr(out, "__next__") else iter([out])
        return LocalDeploymentResponse(_executor().submit(target, *args, **kwargs))


def _resolve_handles(value, instances: Dict[str, Any]):
    if isinstance(value, dict) and set(value) == {"__serve_handle__"}:
        name = value["__serve_handle__"]
        return LocalDeploymentHandle(instances[name], name)
    return value


def run_local(app, name: str = "default") -> LocalDeploymentHandle:
    """Instantiate the whole bound graph in-process; returns the ingress
    handle.  Deployment specs come from the same _collect DFS the cluster
    path uses, so nested-handle wiring is identical."""
    deployments: List[dict] = []
    app._collect(deployments, set())
    instances: Dict[str, Any] = {}
    # _collect appends children before parents, so every nested handle
    # already has its instance by the time a parent initializes
    for spec in deployments:
        import cloudpickle

        target = cloudpickle.loads(spec["serialized_callable"])
        args = tuple(_resolve_handles(a, instances) for a in spec["init_args"])
        kwargs = {k: _resolve_handles(v, instances)
                  for k, v in spec["init_kwargs"].items()}
        if isinstance(target, type):
            instance = target(*args, **kwargs)
        else:
            # function deployments ignore bound init args, matching the
            # cluster replica's behavior (replica.py) — parity over strictness
            instance = target
        if spec.get("user_config") is not None and hasattr(instance, "reconfigure"):
            instance.reconfigure(spec["user_config"])
        # serving SLO layer: same threading the cluster replica does
        # (deployment label for engine-side stages, local SLO targets)
        if hasattr(instance, "set_slo_label"):
            try:
                instance.set_slo_label(spec["name"])
            except Exception:  # noqa: BLE001 — instances without SLO threading are legal
                pass
        from ray_tpu_torch.serve._private import slo

        slo.register_targets(spec["name"], spec.get("slo_config"))
        instances[spec["name"]] = instance
    ingress = deployments[-1]["name"]
    handle = LocalDeploymentHandle(instances[ingress], ingress)
    _local_apps[name] = handle
    return handle


def get_local_app(name: str = "default") -> Optional[LocalDeploymentHandle]:
    return _local_apps.get(name)


def delete_local(name: str = "default"):
    _local_apps.pop(name, None)
