"""Scale-out ingress tier: N HTTP proxies behind one endpoint, with the
proxy as a first-class serve deployment.

One ``_AsyncProxy`` event loop saturates around a core's worth of frame
pumping; "millions of users" (ROADMAP item 1) need N of them behind one
address.  Two pieces:

  - **ProxyServer** — the HTTP proxy wrapped as a serve deployment
    callable.  Deployed like any other deployment, the controller's
    zero-drop drain machinery and the utilization surface
    apply to the proxy tier for free: a draining proxy replica stops
    receiving NEW connections (the tier drops it on refresh) while its
    live SSE streams run to completion, and ``state.utilization()`` folds
    its handle-thread occupancy like any engine's slots.
  - **IngressTier** — one listening endpoint splicing TCP connections to
    the proxy backends.  Affinity is rendezvous hashing on the client
    address: every connection (and reconnection) from one client lands on
    the same proxy while the backend set is unchanged, which keeps live
    SSE streams and their session state pinned; when a backend joins or
    leaves, only the rendezvous-minimal share of clients remaps.  The
    splice is pure byte copy on the tier's own event loop — the tier adds
    one hop and no parsing, so proxy-side admission (429/503 +
    Retry-After) and tracing pass through untouched.

``serve.start_ingress(num_proxies=N)`` is the one-box path used by the
benches: N in-process proxies (they share the process route table) behind
the tier.  On a cluster, ``build_proxy_deployment()`` gives the
deployment to ``serve.run`` and the tier balances across the replicas'
published addresses.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

PROXY_DEPLOYMENT = "http-proxy"
INGRESS_KV_PREFIX = "ingress:addr:"


class ProxyServer:
    """The HTTP proxy as a serve deployment callable.

    Each replica owns one ``_AsyncProxy`` on an ephemeral port and
    publishes its address; ``routes`` (list of ``[prefix, app,
    deployment, asgi]``) seeds the replica-local route table — proxies in
    other processes cannot see the driver's module-level routes."""

    def __init__(self, routes: Optional[Sequence] = None,
                 host: str = "127.0.0.1", port: int = 0):
        from ray_tpu_torch.serve._private.proxy import _AsyncProxy

        self._proxy = _AsyncProxy(host, port)
        self._t0 = time.monotonic()
        if routes:
            self.sync_routes(routes)
        self._publish_address()

    # -- control surface (called through the deployment handle) ------------

    def address(self) -> List:
        host, port = self._proxy.address
        return [host, int(port)]

    def sync_routes(self, routes: Sequence) -> int:
        """Install ``[prefix, app, deployment, asgi]`` rows into this
        replica's route table (idempotent)."""
        from ray_tpu_torch.serve._private.proxy import register_route
        from ray_tpu_torch.serve.handle import DeploymentHandle

        n = 0
        for prefix, app, deployment, asgi in routes:
            register_route(prefix, DeploymentHandle(app, deployment),
                           asgi=bool(asgi))
            n += 1
        return n

    def __call__(self, request=None):
        host, port = self._proxy.address
        return {"address": [host, int(port)],
                "uptime_s": round(time.monotonic() - self._t0, 3)}

    def check_health(self) -> bool:
        return self._proxy._server is not None

    def utilization(self) -> dict:
        """utilization row: handle threads are this deployment's
        "slots", running/capacity its duty cycle, the fair backlog its
        pending queue — state.utilization() folds it like any engine."""
        running, queued = self._proxy._fair.depth()
        total = self._proxy._fair._max_running
        return {"engine": "ingress",
                "deployment": PROXY_DEPLOYMENT,
                "slots": {"active": running, "max": total,
                          "free": max(0, total - running)},
                "pending": queued,
                "duty_cycle": round(running / total, 4) if total else 0.0}

    def shutdown(self) -> None:
        self._proxy.stop()

    # -- discovery -----------------------------------------------------------

    def _publish_address(self) -> None:
        """Best-effort KV row so a cluster-mode IngressTier can discover
        replica addresses (local mode: start_ingress wires backends
        directly)."""
        try:
            import json

            import ray_tpu_torch
            from ray_tpu_torch._private.worker import get_global_worker

            ctx = ray_tpu_torch.get_runtime_context()
            actor_id = getattr(ctx, "actor_id", None)
            if actor_id is None:
                return
            host, port = self._proxy.address
            get_global_worker().gcs.call("KVPut", {
                "key": INGRESS_KV_PREFIX + actor_id.hex(),
                "value": json.dumps({"address": [host, int(port)],
                                     "ts": time.time()}),
            }, timeout=5)
        except Exception:  # noqa: BLE001 — discovery is best-effort
            pass


def build_proxy_deployment(num_replicas: int = 2,
                           routes: Optional[Sequence] = None,
                           name: str = PROXY_DEPLOYMENT):
    """The proxy tier as a deployable serve app: ``serve.run(
    build_proxy_deployment(3).bind(routes), name="ingress")`` puts three
    proxies under the controller's reconcile/drain/utilization machinery."""
    from ray_tpu_torch.serve.api import Deployment

    return Deployment(ProxyServer, name=name, num_replicas=num_replicas,
                      max_ongoing_requests=64)


# ---------------------------------------------------------------------------
# Front balancer
# ---------------------------------------------------------------------------


def _rendezvous(key: str, backends: Sequence[Tuple[str, int]]) -> Tuple[str, int]:
    """Highest-random-weight choice: stable per key while the backend set
    is unchanged; a membership change remaps only the minimal share."""
    best, best_score = backends[0], -1
    for b in backends:
        h = hashlib.blake2b(f"{key}|{b[0]}:{b[1]}".encode(),
                            digest_size=8).digest()
        score = int.from_bytes(h, "big")
        if score > best_score:
            best, best_score = b, score
    return best


class IngressTier:
    """One endpoint, N proxy backends, per-client session affinity.

    Pure TCP splice on a dedicated event loop: each accepted connection
    picks its backend by rendezvous hash of the peer address and copies
    bytes both ways until either side closes.  A backend removed via
    ``set_backends`` (drain) stops receiving new connections; its live
    splices — including open SSE streams — are left to finish."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backends: Optional[Sequence[Tuple[str, int]]] = None):
        self._host = host
        self._port = port
        self._backends: List[Tuple[str, int]] = [
            (h, int(p)) for h, p in (backends or [])]
        self._lock = threading.Lock()
        self._loop = asyncio.new_event_loop()
        self._server: Optional[asyncio.base_events.Server] = None
        self._boot_error: Optional[BaseException] = None
        self._conns = 0
        started = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(started,), daemon=True,
            name="serve-ingress-tier")
        self._thread.start()
        started.wait(timeout=10)
        if self._server is None:
            err = self._boot_error
            raise RuntimeError(f"ingress tier failed to start: {err}") from err
        self.address: Tuple[str, int] = \
            self._server.sockets[0].getsockname()[:2]

    def _run(self, started: threading.Event):
        asyncio.set_event_loop(self._loop)

        async def boot():
            try:
                self._server = await asyncio.start_server(
                    self._handle, self._host, self._port)
            except BaseException as e:  # noqa: BLE001
                self._boot_error = e
            finally:
                started.set()

        self._loop.run_until_complete(boot())
        if self._boot_error is not None:
            return
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def set_backends(self, backends: Sequence[Tuple[str, int]]) -> None:
        with self._lock:
            self._backends = [(h, int(p)) for h, p in backends]

    def backends(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._backends)

    def pick(self, client_key: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            if not self._backends:
                return None
            return _rendezvous(client_key, self._backends)

    async def _handle(self, reader, writer):
        peer = writer.get_extra_info("peername") or ("?", 0)
        backend = self.pick(str(peer[0]))
        if backend is None:
            writer.close()
            return
        try:
            b_reader, b_writer = await asyncio.open_connection(*backend)
        except OSError:
            # backend died between refreshes: fail THIS connection fast
            # (the client retries and rendezvous picks among survivors)
            writer.close()
            return
        self._conns += 1
        try:
            await asyncio.gather(self._splice(reader, b_writer),
                                 self._splice(b_reader, writer))
        except (ConnectionResetError, BrokenPipeError,
                asyncio.CancelledError):
            pass
        finally:
            self._conns -= 1
            for w in (writer, b_writer):
                try:
                    w.close()
                except Exception:  # noqa: BLE001 — peer already gone
                    pass

    @staticmethod
    async def _splice(reader, writer, chunk: int = 64 * 1024):
        try:
            while True:
                data = await reader.read(chunk)
                if not data:
                    break
                writer.write(data)
                await writer.drain()
        finally:
            try:
                if writer.can_write_eof():
                    writer.write_eof()
            except (OSError, RuntimeError):
                pass

    def stop(self):
        async def _shutdown():
            if self._server is not None:
                self._server.close()
            # cancel live splices and let their finally blocks run before
            # the loop stops (no "task was destroyed" at teardown)
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            self._loop.stop()

        try:
            asyncio.run_coroutine_threadsafe(_shutdown(), self._loop)
            self._thread.join(timeout=5)
        except RuntimeError:
            pass


# ---------------------------------------------------------------------------
# One-box scale-out (the bench / local path)
# ---------------------------------------------------------------------------

_tier: Optional[IngressTier] = None
_local_proxies: List = []
_ingress_lock = threading.Lock()


def start_ingress(num_proxies: Optional[int] = None,
                  host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
    """Start N in-process proxies behind one IngressTier endpoint and
    return the tier's (host, port).  The proxies share this process's
    route table, so routes registered via serve.run / serve.add_route are
    served by every one of them; SSE clients keep per-connection (and
    per-client-address) affinity through the tier."""
    from ray_tpu_torch._private.config import global_config
    from ray_tpu_torch.serve._private.proxy import _AsyncProxy

    global _tier
    with _ingress_lock:
        if _tier is not None:
            return _tier.address
        n = int(num_proxies or global_config().serve_ingress_proxies)
        proxies = [_AsyncProxy(host, 0) for _ in range(max(1, n))]
        _local_proxies.extend(proxies)
        _tier = IngressTier(host, port,
                            backends=[p.address for p in proxies])
        return _tier.address


def stop_ingress() -> None:
    global _tier
    with _ingress_lock:
        if _tier is not None:
            _tier.stop()
            _tier = None
        for p in _local_proxies:
            try:
                p.stop()
            except Exception:  # noqa: BLE001 — proxy already stopped
                pass
        _local_proxies.clear()


def get_tier() -> Optional[IngressTier]:
    return _tier


def refresh_backends_from_kv() -> int:
    """Cluster mode: point the tier at every live ProxyServer replica's
    published address (rows keyed by actor id — a drained/dead replica's
    row is dropped by the controller's KV cleanup)."""
    import json

    from ray_tpu_torch._private.worker import get_global_worker

    if _tier is None:
        return 0
    try:
        gcs = get_global_worker().gcs
        keys = gcs.call("KVKeys", {"prefix": INGRESS_KV_PREFIX},
                        timeout=5).get("keys", [])
        backends = []
        for k in keys:
            row = gcs.call("KVGet", {"key": k}, timeout=5).get("value")
            if row:
                addr = json.loads(row).get("address")
                if addr:
                    backends.append((addr[0], int(addr[1])))
    except Exception:  # noqa: BLE001 — keep the current backend set
        return len(_tier.backends())
    if backends:
        _tier.set_backends(backends)
    return len(backends)
