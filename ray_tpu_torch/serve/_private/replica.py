"""Replica actor: hosts one instance of a deployment.

reference: python/ray/serve/_private/replica.py (Replica, 1919 lines —
user-callable hosting, ongoing-request accounting for router probes).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.actor import method as _actor_method


class ServeReplica:
    """Hosts the user class/function; tracks queue length for the
    power-of-two-choices router (reference: replica.py + pow_2_router.py)."""

    def __init__(self, deployment_name: str, serialized_callable, init_args,
                 init_kwargs, max_ongoing_requests: int = 5,
                 app_name: str = "default"):
        import pickle

        target = pickle.loads(serialized_callable)

        def resolve(v):
            # bound sub-applications arrive as handle placeholders
            if isinstance(v, dict) and "__serve_handle__" in v:
                from ray_tpu_torch.serve.handle import DeploymentHandle

                return DeploymentHandle(app_name, v["__serve_handle__"])
            return v

        init_args = tuple(resolve(a) for a in (init_args or ()))
        init_kwargs = {k: resolve(v) for k, v in (init_kwargs or {}).items()}
        if isinstance(target, type):
            self._callable = target(*init_args, **init_kwargs)
        else:
            self._callable = target
        self._deployment = deployment_name
        self._app = app_name
        self._max_ongoing = max_ongoing_requests
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        # cache-aware routing: a callable exposing prefix_digest() gets its
        # digest published to the GCS KV (compact, throttled, versioned) so
        # DeploymentHandle routers can route prompts to the replica already
        # holding the longest KV prefix chain (serve/handle.py)
        self._digest_stop = threading.Event()
        if hasattr(self._callable, "prefix_digest"):
            threading.Thread(target=self._publish_digest_loop, daemon=True,
                             name="serve-prefix-digest").start()
        # device telemetry: a callable exposing utilization() gets its
        # slot/KV occupancy row published to the GCS KV (util: prefix) so
        # state.utilization() can name every replica's free slots/blocks —
        # the SLO-feedback autoscaler's input surface (ROADMAP item 1)
        from ray_tpu_torch._private import device_telemetry

        if (hasattr(self._callable, "utilization")
                and device_telemetry.enabled()):
            threading.Thread(target=self._publish_utilization_loop,
                             daemon=True,
                             name="serve-utilization").start()
        # serving SLO layer: thread the deployment name into the hosted
        # callable so engine-side lifecycle stages (queue_wait, prefill,
        # decode) book under it (llm/serve.py set_slo_label); callables
        # without the hook just don't produce stage rows
        if hasattr(self._callable, "set_slo_label"):
            try:
                self._callable.set_slo_label(deployment_name)
            except Exception:  # noqa: BLE001 — metering must not fail init
                pass
        # built-in per-deployment request metrics (latency histogram +
        # monotonic request counter; rate() of the counter is QPS) — bound
        # once here, recorded per request at constant cost
        from ray_tpu_torch._private import runtime_metrics

        self._latency_metric = runtime_metrics.SERVE_REQUEST_LATENCY.with_tags(
            {"app": app_name, "deployment": deployment_name})
        self._requests_metric = runtime_metrics.SERVE_REQUESTS.with_tags(
            {"app": app_name, "deployment": deployment_name})

    def _record_request(self, t0: float):
        self._latency_metric.observe(time.perf_counter() - t0)
        self._requests_metric.inc()
        # throttled SLO snapshot publication for replica processes: stage
        # sketches recorded inside the engine step loop reach the GCS KV
        # here, per handled request and OUTSIDE any engine lock
        from ray_tpu_torch.serve._private import slo

        slo.maybe_publish()

    def _publish_digest_loop(self):
        """Throttled, versioned digest publication.  The version bumps only
        when the digest content changes; an unchanged digest (same chains,
        same depth) costs no KV write.  Best-effort end to end: a GCS blip
        or a teardown-time race must never take the replica down."""
        import json

        from ray_tpu_torch._private.config import global_config
        from ray_tpu_torch.serve.handle import digest_kv_key

        try:
            import ray_tpu_torch

            actor_id = ray_tpu_torch.get_runtime_context().actor_id
            if actor_id is None:
                return  # local mode: no router reads the KV either
            key = digest_kv_key(self._app, self._deployment, actor_id.hex())
            from ray_tpu_torch._private.worker import get_global_worker

            gcs = get_global_worker().gcs
        except Exception:  # noqa: BLE001
            return
        version = 0
        last_fp = None
        interval = global_config().serve_prefix_digest_interval_s
        while not self._digest_stop.wait(interval):
            try:
                digest = self._callable.prefix_digest() or {}
                fp = (len(digest.get("hashes") or ()),
                      (digest.get("hashes") or [None])[-1],
                      tuple(digest.get("models") or ()),
                      digest.get("qlen"))
                if fp == last_fp:
                    continue
                last_fp = fp
                version += 1
                gcs.call("KVPut", {"key": key, "value": json.dumps({
                    "v": version, "ts": time.time(),
                    "block_size": digest.get("block_size", 0),
                    "hashes": list(digest.get("hashes") or ()),
                    "models": list(digest.get("models") or ()),
                    "qlen": digest.get("qlen"),
                })}, timeout=5)
            except Exception:  # noqa: BLE001 — publication is best-effort
                continue

    def _publish_utilization_loop(self):
        """Per-replica utilization rows to the GCS KV (device telemetry).
        Same discipline as the digest loop: outside every engine lock,
        best-effort end to end, keyed by actor id so a restarted replica
        writes a fresh row instead of racing the old one."""
        import json

        from ray_tpu_torch._private import device_telemetry
        from ray_tpu_torch._private.config import global_config

        try:
            import ray_tpu_torch

            actor_id = ray_tpu_torch.get_runtime_context().actor_id
            if actor_id is None:
                # local mode: state.utilization() folds the in-process
                # provider registry instead (engines register on attach)
                return
            key = device_telemetry.util_kv_key(
                self._app, self._deployment, actor_id.hex())
            from ray_tpu_torch._private.worker import get_global_worker

            gcs = get_global_worker().gcs
        except Exception:  # noqa: BLE001
            return
        interval = global_config().utilization_publish_interval_s
        while not self._digest_stop.wait(interval):
            try:
                row = self._callable.utilization()
                if row is None:
                    continue
                row = dict(row)
                row.setdefault("deployment", self._deployment)
                row["app"] = self._app
                row["replica"] = actor_id.hex()
                row["ts"] = time.time()
                gcs.call("KVPut", {"key": key, "value": json.dumps(row)},
                         timeout=5)
            except Exception:  # noqa: BLE001 — publication is best-effort
                continue

    def handle_request(self, method_name: str, args: tuple, kwargs: dict):
        t0 = time.perf_counter()
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            if method_name == "__call__":
                target = self._callable
                if not callable(target):
                    raise TypeError(
                        f"deployment {self._deployment!r} instance is not callable")
            else:
                target = getattr(self._callable, method_name)
            # child of the actor task's span (which chains to the proxy's
            # ingress span via the TaskSpec trace context): user-callable
            # time vs serve plumbing, separable on the trace
            from ray_tpu_torch.util import tracing

            with tracing.span(f"serve:{self._deployment}.{method_name}",
                              kind="serve"):
                out = target(*args, **kwargs)
                if hasattr(out, "__await__"):
                    import asyncio

                    out = asyncio.run(_await_it(out))
            return out
        finally:
            with self._lock:
                self._ongoing -= 1
            self._record_request(t0)

    def handle_request_streaming(self, method_name: str, args: tuple,
                                 kwargs: dict):
        """Generator twin of handle_request (reference: serve streaming
        responses): pair with num_returns='streaming' so callers iterate an
        ObjectRefGenerator.  A non-generator result streams as one item."""
        t0 = time.perf_counter()
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            if method_name == "__call__":
                target = self._callable
            else:
                target = getattr(self._callable, method_name)
            from ray_tpu_torch.util import tracing

            with tracing.span(f"serve:{self._deployment}.{method_name}",
                              kind="serve"):
                out = target(*args, **kwargs)
                if hasattr(out, "__next__"):
                    yield from out
                else:
                    yield out
        finally:
            with self._lock:
                self._ongoing -= 1
            self._record_request(t0)

    # control-plane methods ride the "system" concurrency group: a replica
    # whose user methods are all blocked must still answer router probes and
    # controller health checks (reference: the reference replica's dedicated
    # control/system concurrency groups, python/ray/serve/_private/replica.py)

    @_actor_method(concurrency_group="system")
    def queue_len(self) -> int:
        """Probe used by the router (reference: pow_2_router.py:52)."""
        return self._ongoing

    @_actor_method(concurrency_group="system")
    def stats(self) -> Dict[str, Any]:
        return {"ongoing": self._ongoing, "total": self._total,
                "max_ongoing": self._max_ongoing}

    def reconfigure(self, user_config) -> bool:
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        return True

    @_actor_method(concurrency_group="system")
    def check_health(self) -> bool:
        if hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return True


async def _await_it(coro):
    return await coro
