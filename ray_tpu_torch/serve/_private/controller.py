"""ServeController: the reconcile loop.

reference: python/ray/serve/_private/controller.py:91 (ServeController actor),
application_state.py:794 (ApplicationState.update), deployment_state.py:1391
(DeploymentState; update :2827), deployment_scheduler.py:277.

Design: a detached actor holding desired state (applications → deployments →
target replica count) and actual state (replica actor handles). A background
reconcile thread converges actual → desired: starts/stops replicas, performs
autoscaling from replica queue stats, bumps a version counter consumed by
routers long-poll style (long_poll.py:228 analog).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.analysis.lock_witness import make_rlock

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "_serve_controller"


# serialized_callable bytes -> sha1 hex. Memoized: the reconcile loop
# hashes every deployment each tick, and cloudpickle bytes are stable within
# one controller process (the bytes object itself is stored once). Across
# processes cloudpickle of identical source may differ — a redeploy from a
# new driver then conservatively restarts replicas (reference behavior:
# config-version based; use user_config for restart-free updates).
_digest_cache: dict = {}


def _cfg_hash(cfg: dict) -> str:
    """Identity of a deployment's code+config (replicas restart when it
    changes; num_replicas alone does not force a restart)."""
    import hashlib

    from ray_tpu_torch._private.serialization import _dumps

    blob = cfg.get("serialized_callable") or b""
    digest = _digest_cache.get(blob)
    if digest is None:
        digest = hashlib.sha1(blob).hexdigest()
        if len(_digest_cache) > 4096:
            _digest_cache.clear()
        _digest_cache[blob] = digest
    key = (digest, cfg.get("init_args"),
           cfg.get("init_kwargs"), cfg.get("user_config"),
           cfg.get("ray_actor_options"), cfg.get("max_ongoing_requests"))
    return hashlib.sha1(_dumps(key)).hexdigest()


class ServeController:
    def __init__(self):
        # app -> deployment -> config dict
        self._desired: Dict[str, Dict[str, dict]] = {}
        # app -> deployment -> list of replica records
        # {"h": ActorHandle, "hash": cfg-hash the replica was started with}
        # — per-replica versioning is what makes rolling redeploys possible
        # (reference: deployment_state.py:1003 DeploymentReplica lifecycle)
        self._replicas: Dict[str, Dict[str, List[dict]]] = {}
        # replicas flipped out of service but possibly still running requests:
        # (handle, hard-kill deadline); killed when queue_len reaches 0 or the
        # graceful_shutdown_timeout_s deadline passes
        self._draining: List[list] = []
        self._version = 0
        self._lock = make_rlock("ServeController._lock")
        self._stop = threading.Event()
        # replica startup (spawn + health gate, up to actor_creation_timeout_s)
        # runs OFF the reconcile thread so one slow/unschedulable deployment
        # can never stall drains, deletes, or other deployments
        from ray_tpu_torch._private.utils import DaemonExecutor

        self._start_pool = DaemonExecutor(max_workers=4,
                                          thread_name_prefix="serve-start")
        self._starting: set = set()            # (app, dep) with a start in flight
        self._start_backoff: Dict[tuple, float] = {}  # (app, dep, hash) -> retry-at
        self._start_fails: Dict[tuple, int] = {}      # (app, dep, hash) -> streak
        # SLO-feedback pool autoscaler (serve/_private/pool_autoscaler.py):
        # burn alerts on the ALERT pubsub channel actuate prefill/decode
        # replica counts through scale_deployment; the reconcile tick
        # drives its headroom-guarded scale-down pass
        from ray_tpu_torch.serve._private.pool_autoscaler import (
            PoolAutoscaler, utilization_headroom)

        self._pool_autoscaler = PoolAutoscaler(
            actuate=self._scale_by_name, current=self._replicas_by_name,
            headroom_source=utilization_headroom)
        # live KV migration (serve/_private/kv_migration.py): the drain
        # path evacuates streams to survivors instead of waiting them
        # out, and the reconcile tick runs the queue-depth rebalance
        from ray_tpu_torch.serve._private.kv_migration import MigrationPlanner

        self._migration = MigrationPlanner(submit=self._start_pool.submit)
        if self._pool_autoscaler.enabled:
            try:
                from ray_tpu_torch._private.worker import get_global_worker

                get_global_worker().register_alert_handler(
                    self._pool_autoscaler.on_alert)
            except Exception:  # noqa: BLE001 — no worker (unit-test
                pass           # construction): alerts just never arrive
        self._thread = threading.Thread(target=self._reconcile_loop, daemon=True,
                                        name="serve-reconcile")
        self._thread.start()

    # -- API used by serve.run / serve.delete -------------------------------
    def deploy_application(self, app_name: str, deployments: List[dict]) -> bool:
        with self._lock:
            self._desired[app_name] = {d["name"]: d for d in deployments}
            self._version += 1
        # distribute explicit SLO targets cluster-wide (serve/_private/
        # slo.py): ingress ledgers and state.serving_slo() read these rows;
        # deployments without slo_config use the config defaults
        self._put_slo_conf(deployments)
        return True

    def delete_application(self, app_name: str) -> bool:
        with self._lock:
            app = self._desired.pop(app_name, None)
            self._version += 1
        if app:
            self._del_slo_conf(app.values())
        return True

    @staticmethod
    def _put_slo_conf(deployments) -> None:
        try:
            import json as _json

            from ray_tpu_torch.serve._private.slo import conf_kv_key
            from ray_tpu_torch._private.worker import get_global_worker

            gcs = get_global_worker().gcs
            for d in deployments:
                if d.get("slo_config"):
                    gcs.call("KVPut", {
                        "key": conf_kv_key(d["name"]),
                        "value": _json.dumps(d["slo_config"]),
                    }, timeout=2, retry_deadline=0.0)
                else:
                    # a redeploy that DROPPED slo_config must fall back to
                    # the config defaults — a stale row would keep judging
                    # breaches against targets the operator removed
                    gcs.call("KVDel", {"key": conf_kv_key(d["name"])},
                             timeout=2, retry_deadline=0.0)
        except Exception:  # noqa: BLE001 — targets fall back to defaults
            pass

    @staticmethod
    def _del_slo_conf(deployments) -> None:
        try:
            from ray_tpu_torch.serve._private.slo import conf_kv_key
            from ray_tpu_torch._private.worker import get_global_worker

            gcs = get_global_worker().gcs
            for d in deployments:
                if d.get("slo_config"):
                    gcs.call("KVDel", {"key": conf_kv_key(d["name"])},
                             timeout=2, retry_deadline=0.0)
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            pass

    def scale_deployment(self, app_name: str, deployment_name: str,
                         num_replicas: int) -> bool:
        """Set a deployment's replica count (the pool autoscaler's
        actuator).  When the deployment carries an autoscaling_config the
        count also becomes its min_replicas floor — the queue-depth
        autoscaler may add capacity on top but can no longer undo a
        burn-driven scale-up on its next tick."""
        with self._lock:
            cfg = self._desired.get(app_name, {}).get(deployment_name)
            if cfg is None:
                return False
            n = max(0, int(num_replicas))
            cfg["num_replicas"] = n
            ac = cfg.get("autoscaling_config")
            if ac:
                ac["min_replicas"] = n
                ac["max_replicas"] = max(int(ac.get("max_replicas", n)), n)
            self._version += 1
        return True

    def _find_app(self, deployment_name: str):
        with self._lock:
            for app, deps in self._desired.items():
                if deployment_name in deps:
                    return app
        return None

    def _scale_by_name(self, deployment_name: str, num_replicas: int):
        app = self._find_app(deployment_name)
        if app is None:
            raise KeyError(f"no deployment named {deployment_name!r}")
        self.scale_deployment(app, deployment_name, num_replicas)

    def _replicas_by_name(self, deployment_name: str) -> int:
        app = self._find_app(deployment_name)
        if app is None:
            raise KeyError(f"no deployment named {deployment_name!r}")
        with self._lock:
            return int(self._desired[app][deployment_name].get(
                "num_replicas", 1))

    def pool_autoscaler_report(self) -> dict:
        return self._pool_autoscaler.snapshot()

    def get_version(self) -> int:
        return self._version

    def list_applications(self) -> List[str]:
        with self._lock:
            return list(self._desired)

    def describe_application(self, app_name: str) -> dict:
        """Dashboard view: deployments with desired/live replica counts
        (reference: dashboard/modules/serve/)."""
        with self._lock:
            app = self._desired.get(app_name, {})
            live = self._replicas.get(app_name, {})
            return {
                name: {
                    "num_replicas": cfg.get("num_replicas", 1),
                    "is_ingress": bool(cfg.get("is_ingress")),
                    "live_replicas": len(live.get(name, [])),
                    "version_hash": _cfg_hash(cfg),
                }
                for name, cfg in app.items()
            }

    def get_deployment_info(self, app_name: str, deployment_name: Optional[str] = None):
        with self._lock:
            app = self._desired.get(app_name)
            if app is None:
                return None
            if deployment_name is None:
                # the ingress deployment is the one marked, else the last
                for d in app.values():
                    if d.get("is_ingress"):
                        return d
                return list(app.values())[-1] if app else None
            return app.get(deployment_name)

    def get_replica_actor_ids(self, app_name: str, deployment_name: str) -> List[str]:
        """Routers fetch replica actor ids + poll version (long-poll analog).
        Draining replicas are already excluded — they finish their in-flight
        requests but receive no new ones."""
        with self._lock:
            reps = self._replicas.get(app_name, {}).get(deployment_name, [])
            return [r["h"]._actor_id.hex() for r in reps]

    def get_deployment_stats(self, app_name: str, deployment_name: str):
        import time as _time

        import ray_tpu_torch

        with self._lock:
            reps = list(self._replicas.get(app_name, {}).get(deployment_name, []))
        # submit all probes first, then collect under ONE shared deadline —
        # serial per-replica timeouts would make a scrape of a deployment
        # with dead replicas take 5s x replicas
        refs = [r["h"].stats.remote() for r in reps]
        deadline = _time.monotonic() + 5
        out = []
        for ref in refs:
            try:
                out.append(ray_tpu_torch.get(
                    ref, timeout=max(0.1, deadline - _time.monotonic())))
            except Exception:  # noqa: BLE001
                out.append(None)
        return out

    def shutdown(self) -> bool:
        with self._lock:
            self._desired = {}
            self._version += 1
        self._stop.set()
        # reconcile once more to tear down replicas, then hard-kill anything
        # still draining — shutdown does not wait out drain deadlines
        self._reconcile()
        import ray_tpu_torch

        with self._lock:
            items, self._draining = self._draining, []
        for entry in items:
            try:
                ray_tpu_torch.kill(entry[0])
            except Exception:  # noqa: BLE001 — already-dead replica is the goal
                pass
        self._del_digest_rows(
            entry[3] if len(entry) > 3 else None for entry in items)
        return True

    # -- reconciliation ------------------------------------------------------
    def _reconcile_loop(self):
        while not self._stop.is_set():
            try:
                self._reconcile()
                self._autoscale()
                self._pool_autoscaler.tick()
                self._rebalance_tick()
            except Exception:  # noqa: BLE001
                logger.exception("serve reconcile error")
            time.sleep(0.1)

    def _rebalance_tick(self):
        """Queue-depth-divergence rebalance (kv_migration.MigrationPlanner):
        paced internally to 1 Hz, hysteresis and the per-replica rate cap
        live in the planner.  The snapshot copy keeps the lock hold
        trivial; the planner's RPCs all run off this thread's lock."""
        if not self._migration.enabled:
            return
        with self._lock:
            snapshot = {(app, dep): [r["h"] for r in recs]
                        for app, deps in self._replicas.items()
                        for dep, recs in deps.items() if len(recs) >= 2}
        if snapshot:
            self._migration.rebalance_tick(snapshot)

    def _reconcile(self):
        import ray_tpu_torch

        self._drain_step()
        self._drain_nodes_step()
        with self._lock:
            desired = {app: dict(deps) for app, deps in self._desired.items()}
        # Phase 1 (under the lock): retire replicas — deleted apps/deployments
        # drain entirely; scale-downs drain the excess; a code/config change
        # drains OLD-version replicas only once a full NEW-version set is in
        # service (graceful rolling redeploy — old replicas keep serving while
        # the new set starts, then finish their in-flight requests off-router).
        with self._lock:
            for app in list(self._replicas):
                for dep in list(self._replicas[app]):
                    want = desired.get(app, {}).get(dep)
                    recs = self._replicas[app][dep]
                    if not want:
                        self._begin_drain(recs, app, dep)
                        recs.clear()
                        del self._replicas[app][dep]
                        self._version += 1
                        continue
                    new_hash = _cfg_hash(want)
                    target = want["num_replicas"]
                    cur = [r for r in recs if r["hash"] == new_hash]
                    old = [r for r in recs if r["hash"] != new_hash]
                    if old and len(cur) >= target:
                        # the new-version set is complete: flip the router
                        # (version bump) and drain the old code
                        for r in old:
                            recs.remove(r)
                        self._begin_drain(old, app, dep)
                        self._version += 1
                    excess = cur[target:]
                    if excess:
                        for r in excess:
                            recs.remove(r)
                        self._begin_drain(excess, app, dep)
                        self._version += 1
                if app not in desired and not self._replicas.get(app):
                    self._replicas.pop(app, None)
        # Phase 2: kick off async starts for missing NEW-version replicas
        # (one in-flight start batch per deployment; backoff after failures)
        for app, deps in desired.items():
            for dep_name, cfg in deps.items():
                new_hash = _cfg_hash(cfg)
                key = (app, dep_name)
                with self._lock:
                    recs = self._replicas.setdefault(app, {}).setdefault(dep_name, [])
                    missing = cfg["num_replicas"] - sum(
                        1 for r in recs if r["hash"] == new_hash)
                    if (missing <= 0 or key in self._starting
                            or time.monotonic() < self._start_backoff.get(
                                (app, dep_name, new_hash), 0.0)):
                        continue
                    self._starting.add(key)
                self._start_pool.submit(
                    self._start_missing, app, dep_name, cfg, new_hash, missing)

    def _start_missing(self, app, dep_name, cfg, new_hash, missing):
        """Spawn `missing` replicas and health-gate them (off the reconcile
        thread). A replica joins the router only once its actor is up and
        check_health passes; the old version keeps serving through this
        window on a redeploy. Desired state is re-checked (and the records
        list re-fetched) under the lock before committing, so a concurrent
        shutdown()/delete/redeploy can't leak replicas onto an orphaned list."""
        import ray_tpu_torch
        from ray_tpu_torch._private.config import global_config

        try:
            from ray_tpu_torch._private.task_spec import GetTimeoutError

            started = [self._start_replica(app, cfg) for _ in range(missing)]
            deadline = time.monotonic() + global_config().actor_creation_timeout_s
            healthy, bad = [], []
            hard_errors = 0  # failures that are NOT scheduling timeouts
            refs = [h.check_health.remote() for h in started]
            for h, ref in zip(started, refs):
                try:
                    ray_tpu_torch.get(ref, timeout=max(1.0, deadline - time.monotonic()))
                    healthy.append(h)
                except GetTimeoutError:
                    bad.append(h)  # likely unschedulable (resources pinned)
                except Exception:  # noqa: BLE001
                    bad.append(h)
                    hard_errors += 1  # the new code itself is broken
            grace = cfg.get("graceful_shutdown_timeout_s", 20.0)
            fail_key = (app, dep_name, new_hash)
            with self._lock:
                still = self._desired.get(app, {}).get(dep_name)
                keep = 0
                if still is not None and _cfg_hash(still) == new_hash:
                    recs = self._replicas.setdefault(app, {}).setdefault(dep_name, [])
                    cur_n = sum(1 for r in recs if r["hash"] == new_hash)
                    keep = max(0, min(len(healthy), still["num_replicas"] - cur_n))
                    recs.extend({"h": h, "hash": new_hash, "grace": grace}
                                for h in healthy[:keep])
                    if keep:
                        self._version += 1
                discard = healthy[keep:] + bad
                if bad:
                    self._start_fails[fail_key] = self._start_fails.get(fail_key, 0) + 1
                    self._start_backoff[fail_key] = time.monotonic() + 5.0
                    if (self._start_fails[fail_key] >= 2 and still is not None
                            and hard_errors == 0):
                        # start-first rollout can deadlock when the OLD
                        # replicas pin the resources the new ones need: after
                        # two batches that failed purely by TIMEOUT (never
                        # scheduled), fall back to stop-first — drain the old
                        # version so the next attempt can schedule. A batch
                        # with any hard error means the NEW code is broken:
                        # keep the old version serving (a bad redeploy must
                        # degrade to stale code, not a full outage).
                        recs = self._replicas.get(app, {}).get(dep_name, [])
                        old = [r for r in recs if r["hash"] != new_hash]
                        if old:
                            logger.warning(
                                "serve: %s/%s new-version replicas timed out "
                                "starting twice; falling back to stop-first "
                                "rollout (draining %d old replicas)",
                                app, dep_name, len(old))
                            for r in old:
                                recs.remove(r)
                            self._begin_drain(old, app, dep_name)
                            self._version += 1
                else:
                    self._start_fails.pop(fail_key, None)
                    self._start_backoff.pop(fail_key, None)
            for victim in discard:
                try:
                    ray_tpu_torch.kill(victim)
                except Exception:  # noqa: BLE001 — already-dead victim is the goal
                    pass
        except Exception:  # noqa: BLE001
            logger.exception("serve: replica start batch failed for %s/%s",
                             app, dep_name)
        finally:
            with self._lock:
                self._starting.discard((app, dep_name))

    def _drain_nodes_step(self):
        """Preemption-aware replica drain: replicas on a DRAINING node are
        flipped out of the router (version bump) and queued through the
        existing rollout-drain machinery — they finish their in-flight
        requests while the reconcile loop starts replacements on surviving
        nodes (the scheduler already excludes DRAINING nodes)."""
        now = time.monotonic()
        if now < getattr(self, "_next_node_poll", 0.0):
            return
        self._next_node_poll = now + 1.0
        import ray_tpu_torch
        from ray_tpu_torch._private.worker import get_global_worker

        try:
            nodes = ray_tpu_torch.nodes() or []
        except Exception:  # noqa: BLE001
            return
        draining = {n["node_id"].hex() for n in nodes
                    if n.get("state") == "DRAINING"}
        if not draining:
            return
        try:
            actors = get_global_worker().gcs.call(
                "ListActors", {}, timeout=2, retry_deadline=0.0) or []
        except Exception:  # noqa: BLE001
            return
        node_of = {
            a["actor_id"].hex(): (a["node_id"].hex() if a["node_id"] else None)
            for a in actors
        }
        moved = 0
        with self._lock:
            for app, deps in self._replicas.items():
                for dep, recs in deps.items():
                    victims = [
                        r for r in recs
                        if node_of.get(r["h"]._actor_id.hex()) in draining
                    ]
                    if victims:
                        for r in victims:
                            recs.remove(r)
                        self._begin_drain(victims, app, dep)
                        self._version += 1
                        moved += len(victims)
        if moved:
            logger.warning(
                "serve: moved %d replica(s) off draining node(s) %s "
                "(graceful: in-flight requests finish; replacements "
                "starting on survivors)", moved, sorted(draining))

    def _begin_drain(self, recs, app: str = None, dep: str = None):
        """Queue replicas for graceful stop (caller holds the lock): they are
        already off the router; killed once idle or past their deadline (the
        grace recorded when the replica started).  Their prefix-digest KV
        rows are deleted up front — a draining replica must stop attracting
        cache-affinity traffic immediately (routers also drop rows whose
        replica left the live set, so this is belt and braces for the
        digest-TTL window) — and AGAIN after the kill (the replica's publish
        thread keeps running through the drain and would otherwise re-create
        the row as its last in-flight requests change the depth, orphaning
        one KV row per drained replica forever).

        Migrate-first (serve/_private/kv_migration.py): when the
        deployment still has live replicas, each draining replica is
        asked — off this thread; the caller holds the lock — to evacuate
        its in-flight decode streams onto the survivors before the
        wait-out drain runs its course.  The drain machinery itself is
        unchanged: an evacuated replica reaches queue_len 0 in seconds
        instead of after its longest generation, which is what makes the
        pool autoscaler's scale-down fast."""
        now = time.monotonic()
        keys = {}
        if app is not None and dep is not None:
            from ray_tpu_torch.serve.handle import digest_kv_key

            keys = {id(r): digest_kv_key(app, dep, r["h"]._actor_id.hex())
                    for r in recs}
        # third field: consecutive idle probes — a replica is only killed
        # after TWO idle reads ≥1 tick apart, so a request routed just before
        # the flip has a tick to land and show up in queue_len; fourth: the
        # digest KV key to clean up once the replica is dead
        self._draining.extend(
            [r["h"], now + float(r.get("grace", 20.0)), 0, keys.get(id(r))]
            for r in recs)
        self._del_digest_rows(keys.values())
        if app is not None and dep is not None and self._migration.enabled:
            survivors = [s["h"]._actor_id.hex()
                         for s in self._replicas.get(app, {}).get(dep, [])]
            if survivors:
                self._start_pool.submit(
                    self._migration.evacuate_replicas, app, dep,
                    [r["h"] for r in recs], survivors)

    @staticmethod
    def _del_digest_rows(keys):
        try:
            from ray_tpu_torch._private.worker import get_global_worker

            gcs = get_global_worker().gcs
            for key in keys:
                if key:
                    gcs.call("KVDel", {"key": key},
                             timeout=2, retry_deadline=0.0)
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            pass

    def _drain_step(self):
        """One pass over draining replicas: kill the idle and the overdue.
        queue_len rides the replica's 'system' concurrency group, so a
        replica still busy with user requests answers the probe."""
        import ray_tpu_torch

        with self._lock:
            items = list(self._draining)
        if not items:
            return
        # probe all replicas concurrently under ONE shared deadline — N wedged
        # replicas must not stall the reconcile loop N*timeout seconds
        probes = {}
        for entry in items:
            try:
                probes[id(entry)] = entry[0].queue_len.remote()
            except Exception:  # noqa: BLE001
                probes[id(entry)] = None
        gather_deadline = time.monotonic() + 2.0
        finished = []
        killed_keys = []
        for entry in items:
            h, deadline, idle_streak = entry[0], entry[1], entry[2]
            kill_it = time.monotonic() > deadline
            if not kill_it:
                ref = probes[id(entry)]
                try:
                    if ref is None:
                        raise RuntimeError("probe submit failed")
                    qlen = ray_tpu_torch.get(
                        ref, timeout=max(0.1, gather_deadline - time.monotonic()))
                    entry[2] = idle_streak + 1 if qlen == 0 else 0
                    kill_it = entry[2] >= 2
                except Exception:  # noqa: BLE001
                    kill_it = True  # unreachable replica: nothing to drain
            if kill_it:
                try:
                    ray_tpu_torch.kill(h)
                except Exception:  # noqa: BLE001 — already-dead replica is the goal
                    pass
                finished.append(id(entry))
                killed_keys.append(entry[3] if len(entry) > 3 else None)
        if finished:
            # the replicas are dead: their publish threads can no longer
            # resurrect the digest rows, so this delete is final
            self._del_digest_rows(killed_keys)
            with self._lock:
                self._draining = [x for x in self._draining
                                  if id(x) not in finished]

    def _start_replica(self, app: str, cfg: dict):
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.replica import ServeReplica

        opts = dict(cfg.get("ray_actor_options") or {})
        opts.setdefault("num_cpus", 0.1)
        opts["max_concurrency"] = max(cfg.get("max_ongoing_requests", 5), 2)
        # router probes + health checks stay responsive even when every
        # user-request slot is blocked
        opts["concurrency_groups"] = {"system": 4}
        cls = ray_tpu_torch.remote(ServeReplica).options(**opts)
        return cls.remote(
            cfg["name"], cfg["serialized_callable"], cfg.get("init_args"),
            cfg.get("init_kwargs"), cfg.get("max_ongoing_requests", 5),
            cfg.get("app_name", app),
        )

    def _autoscale(self):
        """Queue-depth autoscaling (reference: autoscaling_state.py /
        autoscaling_policy.py — target_ongoing_requests driven)."""
        import ray_tpu_torch

        with self._lock:
            items = [(app, dep, dict(cfg)) for app, deps in self._desired.items()
                     for dep, cfg in deps.items() if cfg.get("autoscaling_config")]
        for app, dep, cfg in items:
            ac = cfg["autoscaling_config"]
            with self._lock:
                reps = list(self._replicas.get(app, {}).get(dep, []))
            if not reps:
                continue
            total_ongoing = 0
            for r in reps:
                try:
                    total_ongoing += ray_tpu_torch.get(r["h"].queue_len.remote(), timeout=2)
                except Exception:  # noqa: BLE001 — unreachable replica counts as zero ongoing
                    pass
            target_per_replica = ac.get("target_ongoing_requests", 2)
            desired_n = max(
                ac.get("min_replicas", 1),
                min(ac.get("max_replicas", 10),
                    round(total_ongoing / max(target_per_replica, 1e-9)) or
                    ac.get("min_replicas", 1)),
            )
            with self._lock:
                if self._desired.get(app, {}).get(dep):
                    self._desired[app][dep]["num_replicas"] = desired_n


def get_controller_if_exists():
    """The controller handle if one is running, else None — read-only
    surfaces (state.ingress()) must not boot a control plane."""
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001 — none running
        return None


def get_or_create_controller():
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001 — no controller yet: create below
        pass
    try:
        cls = ray_tpu_torch.remote(ServeController).options(
            name=CONTROLLER_NAME, lifetime="detached", num_cpus=0,
            max_concurrency=16,
        )
        return cls.remote()
    except Exception:  # noqa: BLE001
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
