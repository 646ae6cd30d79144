"""Per-node daemon: worker leasing, local scheduling, object management.

TPU-native rebuild of the reference raylet
(reference: src/ray/raylet/node_manager.cc — HandleRequestWorkerLease :1658,
HandlePrepareBundleResources :1761, HandleCommitBundleResources :1777,
HandleDrainRaylet :1893, worker death :873,980; worker_pool.h:274;
local_task_manager.cc; object transfer: src/ray/object_manager/
object_manager.h:120, pull_manager.h:49, push_manager.h:27).

In this rebuild a "node" is a raylet object; multiple raylets can live in one
OS process for testing (reference: python/ray/cluster_utils.py Cluster), while
worker processes are always real subprocesses.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.analysis.lock_witness import make_lock, make_rlock
from ray_tpu_torch._private import runtime_metrics
from ray_tpu_torch._private.config import RayTpuConfig, global_config
from ray_tpu_torch._private.ids import NodeID, ObjectID, PlacementGroupID, WorkerID
from ray_tpu_torch._private.object_store import LocalObjectStore
from ray_tpu_torch._private.resources import NodeResources, ResourceSet
from ray_tpu_torch._private.rpc import ClientPool, RpcClient, RpcServer
from ray_tpu_torch._private.scheduler import ClusterResourceScheduler, SchedulingStrategy
from ray_tpu_torch._private.task_spec import TaskSpec

logger = logging.getLogger(__name__)


@dataclass
class _Worker:
    worker_id: WorkerID
    address: Tuple[str, int]
    proc: Optional[subprocess.Popen]
    dedicated_actor: Any = None          # ActorID when running an actor
    lease_id: Optional[str] = None
    env_hash: str = ""                   # runtime-env pool key ("" = default)
    idle_since: float = 0.0              # monotonic ts when last idled


@dataclass
class _Lease:
    lease_id: str
    worker: _Worker
    demand: ResourceSet
    instances: Dict[str, list]
    pg_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    for_actor: bool = False
    retriable: bool = False              # memory monitor may kill+retry
    granted_at: float = 0.0
    cpu_released: bool = False           # worker blocked in get(): CPU lent out
    reusable: bool = False               # owner-side lease cache may keep it
    expires_at: float = float("inf")     # reusable: reclaimed past this unless
    #                                      extended (ExtendLease) or busy


@dataclass
class _PendingLease:
    spec: TaskSpec
    reply_token: Any
    for_actor: bool
    count: int = 1                       # batched request: leases wanted
    batched: bool = False                # reply shape: {"leases": [...]}
    enqueue_time: float = field(default_factory=time.monotonic)
    warned_infeasible: bool = False


class _LeaseBatch:
    """Accumulates the grants of ONE RequestWorkerLease call (one reply
    token) while its allocated units wait for workers.  The single reply
    goes out when every allocated unit either got a worker or failed."""

    def __init__(self, pending: _PendingLease, expected: int):
        self.pending = pending
        self.expected = expected
        self.leases: List[dict] = []
        self.failures: List[str] = []
        # partial grant: where the next-best capacity for the ungranted
        # remainder lives (the owner re-requests there)
        self.spill_addr: Optional[Tuple[str, int]] = None

    def settled(self) -> bool:
        return len(self.leases) + len(self.failures) >= self.expected


@dataclass
class _Bundle:
    reserved: ResourceSet
    available: ResourceSet
    instances: Dict[str, list]
    committed: bool = False


class Raylet:
    """One node's control daemon + object store host."""

    def __init__(
        self,
        gcs_address: Tuple[str, int],
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
        is_head: bool = False,
        node_id: Optional[NodeID] = None,
        env: Optional[Dict[str, str]] = None,
        testing_preemption_notice: Optional[str] = None,
    ):
        self.node_id = node_id or NodeID.random()
        self.gcs_address = tuple(gcs_address)
        self.pool = ClientPool()
        self.gcs = self.pool.get(self.gcs_address)
        self.is_head = is_head
        self._worker_env = dict(env or {})

        # bind the flight-recorder hot path NOW: a raylet-only process
        # (`ray_tpu_torch start` node) has no CoreWorker to do it, and a lazily
        # created recorder would silently drop the drain/lease-reclaim
        # marks recorded below until the first AgentFlightRecorder read —
        # losing exactly the events a later diagnose sweep needs
        from ray_tpu_torch._private import flight_recorder

        flight_recorder.get_recorder()

        from ray_tpu_torch._private.accelerators import detect_node_resources_and_labels

        auto_res, auto_labels = detect_node_resources_and_labels()
        res = {**auto_res, **(resources or {})}
        all_labels = {**auto_labels, **(labels or {})}

        self.store = LocalObjectStore(object_store_memory, self.node_id.hex())
        self.local_resources = NodeResources(ResourceSet(res), all_labels)
        self.cluster = ClusterResourceScheduler(self.node_id)
        self.cluster.add_or_update_node(self.node_id, self.local_resources)

        self.server = RpcServer()
        self.server.register_all(self)

        from ray_tpu_torch._private.log_monitor import LogMonitor
        from ray_tpu_torch.dashboard.agent import NodeStatsCollector

        self._log_monitor = LogMonitor(self.gcs, self.server.address[0],
                                       self.node_id.hex())
        self._node_stats = NodeStatsCollector()

        self._lock = make_rlock("Raylet._lock")
        self._dispatch_cv = threading.Condition(self._lock)
        self._spawning_procs: Dict[int, subprocess.Popen] = {}
        # pid -> (spawn monotonic ts, "zygote"|"popen") for spawn latency
        self._spawn_started: Dict[int, Tuple[float, str]] = {}
        # pid -> kill monotonic ts for spawns reclaimed by the timeout
        # watcher: a racing RegisterWorker from one of these must be refused
        # (the process is being SIGKILLed; accepting it would put a dead
        # worker in the pool and double-decrement _starting).  Entries
        # expire after _SPAWN_REFUSE_S so a recycled OS pid can register.
        self._spawn_timed_out: Dict[int, float] = {}
        # built-in runtime metrics: worker-less head processes push through
        # this raylet's GCS client; gauge families whose tag-sets churn
        # (pending shapes, worker states) zero out vanished series
        from ray_tpu_torch.util import metrics as _metrics

        _metrics.set_fallback_gcs(self.gcs)
        # one refresh immediately at startup (negative-infinity analog), then
        # paced at metrics_report_interval_s by the report loop
        self._last_gauge_refresh = float("-inf")
        self._pending_shape_gauges = runtime_metrics.TaggedGaugeSet(
            runtime_metrics.PENDING_TASKS, "shape")
        self._worker_state_gauges = runtime_metrics.TaggedGaugeSet(
            runtime_metrics.WORKERS, "state")
        node_tag = self.node_id.hex()[:8]
        self._store_used_gauge = runtime_metrics.STORE_USED_BYTES.with_tags(
            {"node": node_tag})
        self._store_objects_gauge = runtime_metrics.STORE_OBJECTS.with_tags(
            {"node": node_tag})
        # warm zygote for fast worker forks; starts in the background at
        # init so the first spawn (under the dispatch lock) never waits
        self._zygote = None
        if (global_config().enable_worker_zygote
                and sys.platform == "linux"):
            from ray_tpu_torch._private.zygote import ZygoteClient

            base_env = {**os.environ, **self._worker_env}
            base_env.setdefault("PYTHONUNBUFFERED", "1")
            self._zygote = ZygoteClient(
                state_dir=self._log_monitor.log_dir,
                worker_env=base_env,
                log_sink=self._log_monitor.new_log_file())
        # worker pool keyed by runtime-env hash (reference: WorkerPool keys
        # idle workers by runtime env — dedicated workers per env)
        self._idle_workers: Dict[str, deque] = defaultdict(deque)
        self._all_workers: Dict[WorkerID, _Worker] = {}
        self._starting: Dict[str, int] = defaultdict(int)
        self._env_failures: Dict[str, tuple] = {}  # env_hash -> (error, expiry)
        self._pending_leases: deque[_PendingLease] = deque()
        # (pending, demand, instances, pg_id, bundle_index, batch)
        self._grants_waiting_worker: deque[tuple] = deque()
        self._leases: Dict[str, _Lease] = {}
        self._bundles: Dict[PlacementGroupID, Dict[int, _Bundle]] = {}
        self._draining = False
        self._drain_reason = ""
        self._drain_deadline_ts: Optional[float] = None   # wall clock
        self._drain_deadline_mono: float = 0.0
        # set once the drain finished and NodeDead("drained") went out: the
        # report loop must stop, or the GCS's {"restart": True} reply would
        # resurrect the dead node as a fresh ALIVE registration
        self._drain_complete = threading.Event()
        self._stopped = threading.Event()
        self._lease_counter = 0
        # worker address -> exit reason ("oom"); owners query this to turn a
        # ConnectionLost into OutOfMemoryError (reference: memory_monitor.h:52)
        self._exit_reasons: Dict[Tuple[str, int], str] = {}
        # oid -> monotonic start of an in-flight inbound push (push plane)
        self._push_receiving: Dict[ObjectID, float] = {}
        self._object_owners: Dict[ObjectID, Tuple[str, int]] = {}
        # raylet-side task phase events (QUEUED at lease request, SCHEDULED
        # at grant) for the GCS task sink — the queueing/dispatch phases of
        # state.summarize_trace().  Flushed by the report loop; own lock so
        # recording under the dispatch lock never does I/O.
        self._task_events: List[dict] = []
        self._task_events_lock = make_lock("Raylet._task_events_lock")

        # versioned cluster-view mirror (delta sync): the report loop sends
        # known_version and applies snapshot/delta replies through the
        # shared protocol in _private/cluster_view.py
        self._view_version = -1
        self._view_store = Raylet._SchedulerViewStore(self)
        # tree-pubsub control messages seen (tests + diagnosability)
        self._node_events_seen = 0
        # report-loop failure visibility: counter + throttled warning so a
        # flapping GCS link shows up instead of vanishing into a bare pass
        self._last_report_warn = float("-inf")

        # Register with GCS; receive cluster config + view.
        reply = self.gcs.call(
            "RegisterNode",
            {
                "node_id": self.node_id,
                "address": self.server.address,
                "resources": self.local_resources.total.to_dict(),
                "labels": all_labels,
                "is_head": is_head,
            },
        )
        from ray_tpu_torch._private import config as config_mod

        config_mod.set_global_config(RayTpuConfig.from_blob(reply["config_blob"]))
        self._apply_sync_reply(reply)

        self._threads = [
            threading.Thread(target=self._report_loop, daemon=True, name="raylet-report"),
            threading.Thread(target=self._dispatch_loop, daemon=True, name="raylet-dispatch"),
            threading.Thread(target=self._worker_monitor_loop, daemon=True, name="raylet-monitor"),
        ]
        if global_config().memory_monitor_refresh_ms > 0:
            self._threads.append(threading.Thread(
                target=self._memory_monitor_loop, daemon=True, name="raylet-memmon"))
        for t in self._threads:
            t.start()

        # Preemption/maintenance watcher: on TPU hosts poll the GCE metadata
        # server (instance/preempted, maintenance-event) and turn a platform
        # notice into a graceful self-drain; testing_preemption_notice (the
        # per-node arg or the cluster config knob) injects a deterministic
        # synthetic notice for tests.
        self._maintenance_watcher = None
        notice_spec = (testing_preemption_notice
                       if testing_preemption_notice is not None
                       else global_config().testing_preemption_notice)
        from ray_tpu_torch._private.accelerators.tpu import (
            TPUAcceleratorManager,
            TpuMaintenanceWatcher,
        )

        watch_hardware = (
            TPUAcceleratorManager.get_current_node_num_accelerators() > 0
            and not os.environ.get("RAY_TPU_DISABLE_METADATA_SERVER"))
        if notice_spec or watch_hardware:
            self._maintenance_watcher = TpuMaintenanceWatcher(
                on_notice=self._on_maintenance_notice,
                poll_interval_s=global_config().maintenance_poll_interval_s,
                testing_notice=notice_spec or None,
            )
            self._maintenance_watcher.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def shutdown(self):
        self._stopped.set()
        if self._maintenance_watcher is not None:
            self._maintenance_watcher.stop()
        self._log_monitor.stop()
        with self._lock:
            workers = list(self._all_workers.values())
            # mid-spawn workers haven't registered yet and would outlive us
            # retrying RegisterWorker against a dead socket (caught by the
            # lane hygiene test); kill them before they ever serve
            spawning = list(self._spawning_procs.values())
            self._spawning_procs.clear()
            self._dispatch_cv.notify_all()
        for proc in spawning:
            try:
                proc.kill()
            except Exception:  # noqa: BLE001 — mid-spawn proc may already be dead (the goal)
                pass
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.terminate()
                except Exception:  # noqa: BLE001 — already-dead proc is the desired state
                    pass
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=3)
                except Exception:  # noqa: BLE001
                    try:
                        w.proc.kill()
                    except Exception:  # noqa: BLE001 — kill after failed wait; already-dead is fine
                        pass
        if self._zygote is not None:
            self._zygote.shutdown()
        self.server.shutdown()
        self.store.shutdown()
        self.pool.close_all()

    # ------------------------------------------------------------------
    # Cluster view sync (reference: ray_syncer.h — versioned gossip).
    # The protocol (snapshot-sweeps vs delta+tombstones, version tracking)
    # lives in _private/cluster_view.py, shared with the mega-cluster
    # harness's skeleton raylets; this raylet contributes the store that
    # maps view entries onto its ClusterResourceScheduler.
    # ------------------------------------------------------------------

    def _apply_sync_reply(self, reply: dict):
        from ray_tpu_torch._private.cluster_view import apply_sync_reply

        with self._lock:
            self._view_version = apply_sync_reply(
                reply, self._view_store, self.node_id, self._view_version)

    class _SchedulerViewStore:
        """cluster_view.ViewStore over a raylet's scheduler (lock held by
        the caller for the whole apply)."""

        def __init__(self, raylet: "Raylet"):
            self._raylet = raylet

        def upsert(self, nid, snap):
            cluster = self._raylet.cluster
            node = cluster.nodes.get(nid)
            if node is None:
                node = NodeResources(ResourceSet(snap["total"]), snap.get("labels"))
                cluster.add_or_update_node(nid, node)
            node.available = ResourceSet(snap["available"])
            node.address = tuple(snap["address"])  # type: ignore[attr-defined]
            # DRAINING peers stay in the view (their running leases are
            # real) but take no spillback from this node's dispatch
            cluster.set_draining(nid, snap.get("state") == "DRAINING")

        def remove(self, nid):
            self._raylet.cluster.remove_node(nid)

        def ids(self):
            return list(self._raylet.cluster.nodes)

    # ------------------------------------------------------------------
    # Tree pubsub relay (control channels; reference: the broadcast-tree
    # shape of experimental.broadcast_object applied to control traffic)
    # ------------------------------------------------------------------

    def HandleRelayPublish(self, req):
        """One hop of a tree-fanned control publish: forward the once-
        pickled frame to this relay's subtree, then deliver locally."""
        import pickle as _pickle

        frame = req.get("frame")
        if not isinstance(frame, (bytes, bytearray)):
            frame = bytes(frame)  # OOB transit hands us a memoryview
        subtree = [tuple(a) for a in (req.get("subtree") or ())]
        if subtree:
            self._relay_forward(frame, subtree)
        try:
            msg = _pickle.loads(frame)
            self._on_control_message(msg.get("channel"), msg.get("message"))
        except Exception:  # noqa: BLE001 — a malformed frame must not
            pass           # poison the relay plane
        return True

    def _relay_forward(self, frame: bytes, subtree):
        from ray_tpu_torch._private.cluster_view import tree_partition
        from ray_tpu_torch._private.rpc import ConnectionLost, oob_wrap

        def send(head, rest, role):
            try:
                fut = self.pool.get(head).call_async(
                    "RelayPublish", {"frame": oob_wrap(frame),
                                     "subtree": rest})
            except Exception:  # noqa: BLE001 — dead child: deliver its
                # subtree directly so this publish still reaches it
                for t in rest:
                    send(t, [], "fallback")
                return
            runtime_metrics.inc_relay_publish(role)
            if rest:
                fut.add_done_callback(
                    lambda f, rest=rest:
                    [send(t, [], "fallback") for t in rest]
                    if isinstance(f.exception(), ConnectionLost) else None)
            else:
                fut.add_done_callback(lambda f: f.exception())  # swallow

        for group in tree_partition(subtree, global_config().pubsub_tree_fanout):
            send(group[0], group[1:], "relay")

    def _on_control_message(self, channel, message):
        """Local delivery of a tree-published control message.  The
        versioned view sync stays authoritative — pubsub only lets a
        raylet act on drain/death a few ticks earlier (both applications
        are idempotent, and node ids are per-incarnation so stale events
        can't hit a re-registered node)."""
        self._node_events_seen += 1
        if channel != "NODE" or not isinstance(message, dict):
            return
        nid = message.get("node_id")
        if nid is None or nid == self.node_id:
            return
        event = message.get("event")
        with self._lock:
            if event == "draining":
                self.cluster.set_draining(nid, True)
            elif event == "dead":
                self.cluster.remove_node(nid)

    def _update_node_gauges_locked(self):
        """Refresh this node's built-in gauges (called from the report loop
        under self._lock; every read here is O(pool size))."""
        from collections import Counter as _Counter

        shapes = _Counter(
            runtime_metrics.shape_str(p.spec.resources.to_dict())
            for p in self._pending_leases)
        self._pending_shape_gauges.set_all(dict(shapes))
        self._worker_state_gauges.set_all({
            "starting": sum(self._starting.values()),
            "idle": sum(len(p) for p in self._idle_workers.values()),
            "busy": len(self._leases),
            "total": len(self._all_workers),
        })
        total_tpu = self.local_resources.total.get("TPU")
        if total_tpu:
            runtime_metrics.set_tpu_chips(
                self.node_id.hex()[:8], total_tpu,
                total_tpu - self.local_resources.available.get("TPU"))
        self._store_used_gauge.set(self.store.used_bytes())
        self._store_objects_gauge.set(self.store.num_sealed())

    def _report_loop(self):
        while not self._stopped.wait(global_config().resource_report_interval_s):
            if self._drain_complete.is_set():
                # drained-to-death: reporting again would make the GCS reply
                # {"restart": True} and resurrect this node as a fresh ALIVE
                # registration
                continue
            try:
                interval = global_config().metrics_report_interval_s
                now = time.monotonic()
                with self._lock:
                    avail = self.local_resources.available.to_dict()
                    # gauge refresh is O(pool+queue+objects): pace it at the
                    # metrics interval, not every 0.2 s report tick.  Own
                    # clock, NOT the process-global push throttle — other
                    # pushers (driver collect_cluster, task flushes) reset
                    # that one constantly and would starve the refresh.
                    if now - self._last_gauge_refresh >= interval:
                        self._last_gauge_refresh = now
                        self._update_node_gauges_locked()
                runtime_metrics.maybe_push()
                self._flush_task_events()
                reply = self.gcs.call(
                    "ReportResources",
                    {"node_id": self.node_id, "available": avail,
                     "known_version": self._view_version})
                if reply.get("restart"):
                    # GCS restarted and lost us (reference: HandleNotifyGCSRestart
                    # node_manager.cc:948): re-register; the register reply
                    # carries a fresh full snapshot + version.
                    reply = self.gcs.call(
                        "RegisterNode",
                        {
                            "node_id": self.node_id,
                            "address": self.server.address,
                            "resources": self.local_resources.total.to_dict(),
                            "labels": dict(self.local_resources.labels),
                            "is_head": self.is_head,
                        },
                    )
                self._apply_sync_reply(reply)
                with self._lock:
                    self._dispatch_cv.notify_all()
            except Exception as e:  # noqa: BLE001
                # GCS temporarily unreachable; keep trying — but visibly:
                # count every failed tick and warn at most once per 30s so
                # a flapping link is diagnosable without log spam
                runtime_metrics.inc_report_failure()
                now = time.monotonic()
                if now - self._last_report_warn >= 30.0:
                    self._last_report_warn = now
                    logger.warning(
                        "raylet %s: resource report to GCS %s failed (%s: "
                        "%s); retrying every %.1fs",
                        self.node_id.hex()[:8], self.gcs_address,
                        type(e).__name__, e,
                        global_config().resource_report_interval_s)

    # ------------------------------------------------------------------
    # Worker pool (reference: worker_pool.h:274, worker_pool.cc)
    # ------------------------------------------------------------------

    def _spawn_worker(self, env_hash: str = "", runtime_env: Optional[dict] = None):
        self._starting[env_hash] += 1
        env = {
            **os.environ,
            **self._worker_env,
            "RAY_TPU_NODE_ID": self.node_id.hex(),
            "RAY_TPU_RAYLET_HOST": self.server.address[0],
            "RAY_TPU_RAYLET_PORT": str(self.server.address[1]),
            "RAY_TPU_GCS_HOST": self.gcs_address[0],
            "RAY_TPU_GCS_PORT": str(self.gcs_address[1]),
        }
        if runtime_env:
            import json

            env["RAY_TPU_RUNTIME_ENV"] = json.dumps(runtime_env)
            env["RAY_TPU_RUNTIME_ENV_HASH"] = env_hash
        # Workers write to per-process log files which the node's log monitor
        # tails to the driver (reference: _private/log_monitor.py); unbuffered
        # so prints land promptly.
        env.setdefault("PYTHONUNBUFFERED", "1")
        log_file = self._log_monitor.new_log_file()
        spawn_t0 = time.monotonic()
        proc = self._zygote_spawn(env, log_file)
        method = "zygote"
        if proc is None:
            method = "popen"
            with open(log_file, "ab") as lf:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch._private.workers_main"],
                    env=env,
                    stdout=lf,
                    stderr=subprocess.STDOUT,
                )
        runtime_metrics.inc_spawn(method)
        self._log_monitor.register_pid(log_file, proc.pid)
        self._spawning_procs[proc.pid] = proc
        self._spawn_started[proc.pid] = (spawn_t0, method)
        threading.Thread(
            target=self._watch_spawn, args=(proc, env_hash), daemon=True,
            name="raylet-spawnwatch"
        ).start()

    def _zygote_spawn(self, env: dict, log_file: str):
        """Fork a worker off the warm zygote (fast path: ~50 ms vs ~2.3 s
        full interpreter startup on this image — see zygote.py). Returns a
        Popen-like handle or None to use the subprocess fallback.  Never
        blocks on zygote startup: spawn() returns None while it warms
        (this runs under the dispatch lock)."""
        if self._zygote is None:
            return None
        pid = self._zygote.spawn(env, log_file)
        return _PidHandle(pid) if pid else None

    def _watch_spawn(self, proc, env_hash: str):
        """If a spawned worker exits — or wedges — before registering,
        reclaim its _starting slot.

        The deadline (worker_spawn_timeout_s, default 3 min) sits well above
        the worker's 90 s registration retry window, so a slow-but-alive
        worker always registers first; a worker stuck before registration
        (hung import, stalled zygote child) is killed on expiry instead of
        pinning a maximum_startup_concurrency slot and this poll thread
        forever.  Timeouts are counted in
        ray_tpu_raylet_worker_spawn_timeout_total so the leak is visible."""
        deadline = time.monotonic() + global_config().worker_spawn_timeout_s
        while not self._stopped.is_set():
            with self._lock:
                if proc.pid not in self._spawning_procs:
                    return  # registered
            dead = proc.poll() is not None
            expired = not dead and time.monotonic() > deadline
            if dead or expired:
                with self._lock:
                    # pop-under-lock decides ownership: HandleRegisterWorker
                    # pops the same key, so whoever pops it acts and
                    # _starting is decremented exactly once; a registration
                    # racing an expiry is REFUSED via _spawn_timed_out (the
                    # process is being killed — accepting would pool a
                    # corpse)
                    owned = self._spawning_procs.pop(proc.pid, None) is not None
                    if owned:
                        self._starting[env_hash] = max(0, self._starting[env_hash] - 1)
                        self._spawn_started.pop(proc.pid, None)
                        if expired:
                            now = time.monotonic()
                            self._spawn_timed_out = {
                                p: t for p, t in self._spawn_timed_out.items()
                                if now - t < self._SPAWN_REFUSE_S}
                            self._spawn_timed_out[proc.pid] = now
                    self._dispatch_cv.notify_all()
                if owned and expired:
                    try:
                        proc.kill()
                    except Exception:  # noqa: BLE001 — already-exited proc is the desired outcome
                        pass
                    runtime_metrics.inc_spawn_timeout()
                    logger.warning(
                        "raylet %s: spawned worker pid %s never "
                        "registered within %.0f s; killed",
                        self.node_id, proc.pid,
                        global_config().worker_spawn_timeout_s)
                return
            time.sleep(0.05)

    # refusal window for timed-out spawn pids: far longer than the SIGKILL→
    # register race it guards against, far shorter than OS pid recycling
    _SPAWN_REFUSE_S = 60.0

    def HandleRegisterWorker(self, req):
        pid = req.get("pid")
        env_hash = req.get("env_hash", "")
        with self._lock:
            killed_at = self._spawn_timed_out.get(pid) if pid is not None else None
            if (killed_at is not None
                    and time.monotonic() - killed_at < self._SPAWN_REFUSE_S):
                # the watcher already reclaimed this spawn's slot and is
                # killing the process; refusing here keeps the pool free of
                # dead workers and _starting single-decremented
                self._spawn_timed_out.pop(pid, None)
                raise RuntimeError(
                    f"worker pid {pid} exceeded the spawn deadline and was "
                    "reclaimed; registration refused")
            if killed_at is not None:
                self._spawn_timed_out.pop(pid, None)  # expired: pid recycled
            proc = self._spawning_procs.pop(pid, None) if pid is not None else None
            started = self._spawn_started.pop(pid, None) if pid is not None else None
        if started is not None:
            runtime_metrics.observe_spawn(
                started[1], time.monotonic() - started[0])
        with self._lock:
            if proc is None and pid is not None:
                proc = _PidHandle(pid)
            worker = _Worker(worker_id=req["worker_id"], address=tuple(req["address"]),
                             proc=proc, env_hash=env_hash,
                             idle_since=time.monotonic())
            self._all_workers[worker.worker_id] = worker
            self._starting[env_hash] = max(0, self._starting[env_hash] - 1)
            self._idle_workers[env_hash].append(worker)
            self._dispatch_cv.notify_all()
        return {"node_id": self.node_id, "config_blob": global_config().to_blob()}

    def _worker_monitor_loop(self):
        """Detect worker-process death (reference: node_manager.cc:980);
        reap dedicated runtime-env workers idle past the timeout so distinct
        envs don't accumulate resident processes forever."""
        last_reclaim = 0.0
        reclaim_thread: Optional[threading.Thread] = None
        while not self._stopped.wait(0.2):
            dead = []
            reap = []
            now = time.monotonic()
            if now - last_reclaim >= max(
                    global_config().worker_lease_ttl_s / 4.0, 0.25):
                last_reclaim = now
                if reclaim_thread is None or not reclaim_thread.is_alive():
                    # off-thread, single-flight: the reclaim probes leased
                    # workers with blocking RPCs — the 0.2s death poll must
                    # not stall behind them
                    def _reclaim():
                        try:
                            self._reclaim_expired_leases()
                        except Exception:  # noqa: BLE001 — reclaim retries on the next death-poll tick
                            pass
                    reclaim_thread = threading.Thread(
                        target=_reclaim, daemon=True,
                        name="raylet-lease-reclaim")
                    reclaim_thread.start()
            with self._lock:
                for wid, w in list(self._all_workers.items()):
                    if w.proc is not None and w.proc.poll() is not None:
                        dead.append(w)
                        del self._all_workers[wid]
                        pool = self._idle_workers.get(w.env_hash)
                        if pool and w in pool:
                            pool.remove(w)
                kill_after = global_config().idle_worker_kill_timeout_s
                for env_key, pool in self._idle_workers.items():
                    if not env_key:
                        continue  # the default pool is bounded by demand
                    while pool and now - pool[0].idle_since > kill_after:
                        w = pool.popleft()
                        self._all_workers.pop(w.worker_id, None)
                        reap.append(w)
            for w in reap:
                if w.proc is not None:
                    try:
                        w.proc.terminate()
                    except Exception:  # noqa: BLE001 — already-dead proc is the desired state
                        pass
            for w in dead:
                self._on_worker_death(w)

    # ------------------------------------------------------------------
    # Memory monitor (reference: src/ray/common/memory_monitor.h:52 — sample
    # node memory; over threshold, kill the most recently granted retriable
    # task's worker so the owner retries it; the kill reason is queryable so
    # the final surfaced error is OutOfMemoryError, not a generic crash)
    # ------------------------------------------------------------------

    def _memory_used_fraction(self) -> float:
        try:
            import psutil

            return float(psutil.virtual_memory().percent) / 100.0
        except ImportError:
            # /proc fallback so the monitor still protects hosts w/o psutil
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    info[k] = int(v.strip().split()[0])
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", total)
            return 1.0 - (avail / total) if total else 0.0

    def _memory_monitor_loop(self):
        cfg = global_config()
        period = max(cfg.memory_monitor_refresh_ms, 50) / 1000.0
        while not self._stopped.wait(period):
            try:
                frac = self._memory_used_fraction()
            except Exception:  # noqa: BLE001 — transient /proc read failure; next tick retries
                continue
            threshold = global_config().memory_usage_threshold
            if frac <= threshold:
                continue
            victim = None
            with self._lock:
                # prefer retriable task leases (they restart transparently);
                # fall back to non-retriable ones — the owner then surfaces
                # OutOfMemoryError immediately. Actors are never OOM-killed
                # here (reference policy: workers running tasks first).
                candidates = [l for l in self._leases.values()
                              if l.retriable and l.worker.proc is not None]
                if not candidates:
                    candidates = [l for l in self._leases.values()
                                  if not l.for_actor and l.worker.proc is not None]
                if candidates:
                    victim = max(candidates, key=lambda l: l.granted_at)
                    self._exit_reasons[tuple(victim.worker.address)] = "oom"
                    while len(self._exit_reasons) > 256:
                        self._exit_reasons.pop(next(iter(self._exit_reasons)))
            if victim is None:
                continue
            logger.warning(
                "raylet %s: node memory %.1f%% > %.1f%%; killing newest "
                "retriable task's worker %s (lease %s)",
                self.node_id, frac * 100, threshold * 100,
                victim.worker.worker_id, victim.lease_id)
            try:
                victim.worker.proc.kill()
            except Exception:  # noqa: BLE001 — victim already exited is the desired outcome
                pass
            # cooldown before the next kill: gives the freed memory time to
            # show in the next sample AND spaces out kills so a retried task
            # is not immediately re-shot while external pressure persists
            # (the owner also backs off harder on OOM retries)
            self._stopped.wait(2.0)

    def HandleGetWorkerExitReason(self, req):
        return self._exit_reasons.get(tuple(req["worker_addr"]))

    def _on_worker_death(self, w: _Worker):
        logger.warning("raylet %s: worker %s died", self.node_id, w.worker_id)
        with self._lock:
            lease = self._leases.pop(w.lease_id, None) if w.lease_id else None
            if lease is not None:
                self._release_lease_resources(lease)
            self._dispatch_cv.notify_all()
        if w.dedicated_actor is not None:
            try:
                self.gcs.notify(
                    "ReportActorDeath",
                    {"actor_id": w.dedicated_actor, "reason": f"worker process {w.worker_id} exited"},
                )
            except Exception:  # noqa: BLE001 — GCS down: the health sweep declares the death
                pass
        try:
            self.gcs.notify("Publish", {"channel": "WORKER_FAILURE", "message": {"worker_id": w.worker_id, "addr": w.address}})
        except Exception:  # noqa: BLE001 — GCS down: subscribers learn via the health sweep
            pass

    # ------------------------------------------------------------------
    # Leasing + local scheduling
    # (reference: HandleRequestWorkerLease node_manager.cc:1658,
    #  ClusterTaskManager::QueueAndScheduleTask, LocalTaskManager dispatch)
    # ------------------------------------------------------------------

    def _record_task_event(self, spec: TaskSpec, state: str):
        """Buffer a phase event for the GCS task sink (never blocks: the
        report loop flushes).  Gated like every other task event."""
        if not global_config().task_events_enabled:
            return
        ev = {
            "task_id": spec.task_id.hex(),
            "name": spec.name,
            "state": state,
            "time": time.time(),
            "attempt": spec.attempt,
            "job_id": spec.job_id.hex() if spec.job_id else None,
            "actor_id": spec.actor_id.hex() if spec.actor_id else None,
            "node_id": self.node_id.hex(),
        }
        if getattr(spec, "trace_id", None) is not None:
            ev["trace_id"] = spec.trace_id
            ev["span_id"] = spec.span_id
            ev["parent_span_id"] = spec.parent_span_id
        with self._task_events_lock:
            self._task_events.append(ev)
            if len(self._task_events) > 5000:  # GCS unreachable: shed oldest
                del self._task_events[:1000]

    def _flush_task_events(self):
        with self._task_events_lock:
            events, self._task_events = self._task_events, []
        if not events:
            return
        try:
            # call (not notify): notify swallows delivery failure, which
            # would silently drop every QUEUED/SCHEDULED phase recorded
            # during a GCS restart.  On failure the batch is re-queued —
            # the record-side 5000 cap bounds it while the GCS is down.
            self.gcs.call("AddTaskEvents", {"events": events},
                          timeout=5, retry_deadline=0.0)
        except Exception:  # noqa: BLE001
            with self._task_events_lock:
                self._task_events[:0] = events
                if len(self._task_events) > 5000:
                    del self._task_events[:len(self._task_events) - 5000]

    def HandleRequestWorkerLease(self, req, reply_token=None):
        spec: TaskSpec = req["spec"]
        count = min(max(1, int(req.get("num_leases", 1))), 256)
        pending = _PendingLease(
            spec=spec, reply_token=reply_token,
            for_actor=req.get("for_actor", False),
            count=count, batched="num_leases" in req)
        with self._lock:
            if self._draining:
                self.server.send_reply(reply_token, {"rejected": True, "reason": "draining"})
                return RpcServer.DELAYED_REPLY
            # record QUEUED only once the task actually queues here — a
            # draining raylet's rejection must not stamp a phase the
            # retried lease will re-stamp on another node.  Batched (fast
            # path) requests carry one representative spec for N tasks, so
            # per-task phases are stamped owner-side instead.
            if not pending.batched:
                self._record_task_event(spec, "QUEUED")
            self._pending_leases.append(pending)
            self._dispatch_cv.notify_all()
        return RpcServer.DELAYED_REPLY

    def _dispatch_loop(self):
        while not self._stopped.is_set():
            with self._lock:
                self._dispatch_cv.wait(timeout=0.2)
                if self._stopped.is_set():
                    return
                t0 = time.perf_counter()
                self._try_dispatch_locked()
                self._try_grant_waiting_locked()
                runtime_metrics.observe_dispatch(time.perf_counter() - t0)

    def _try_dispatch_locked(self):
        still_pending: deque[_PendingLease] = deque()
        while self._pending_leases:
            p = self._pending_leases.popleft()
            spec = p.spec
            strategy = spec.strategy or SchedulingStrategy()
            if strategy.kind == "placement_group":
                if not self._try_dispatch_pg_locked(p):
                    still_pending.append(p)
                continue
            # Pick the best node per unit against one snapshot; allocate the
            # local prefix here, spill the request if the FIRST unit belongs
            # elsewhere (the owner re-requests any ungranted remainder).
            placements = self.cluster.get_best_schedulable_nodes(
                spec.resources, strategy, count=p.count,
                prefer_node=self.node_id)
            if not placements:
                # Not schedulable anywhere right now — keep it queued even if
                # no current node could EVER fit it: queued demand is the
                # autoscaler's scale-up signal (reference: infeasible tasks
                # stay pending and appear in the GCS load report), and a new
                # node may make it feasible.  Warn once so a cluster without
                # an autoscaler doesn't hang silently.
                if (not getattr(p, "warned_infeasible", False)
                        and not any(n.feasible(spec.resources)
                                    for n in self.cluster.nodes.values())):
                    p.warned_infeasible = True
                    logger.warning(
                        "task %s demands %s, infeasible on every current node; "
                        "it will hang unless the cluster scales up",
                        spec.name, spec.resources.to_dict())
                still_pending.append(p)
                continue
            if placements[0] != self.node_id:
                node = self.cluster.nodes.get(placements[0])
                addr = getattr(node, "address", None)
                if addr is None:
                    still_pending.append(p)
                    continue
                runtime_metrics.inc_spillback()
                self.server.send_reply(p.reply_token, {"spillback": tuple(addr)})
                continue
            allocs = []
            for nid in placements:
                if nid != self.node_id:
                    break
                instances = self.local_resources.allocate(spec.resources)
                if instances is None:
                    break
                allocs.append(instances)
            if not allocs:
                still_pending.append(p)
                continue
            batch = _LeaseBatch(p, expected=len(allocs))
            if len(allocs) < len(placements):
                nxt = placements[len(allocs)]
                if nxt != self.node_id:
                    node = self.cluster.nodes.get(nxt)
                    addr = getattr(node, "address", None)
                    if addr is not None:
                        batch.spill_addr = tuple(addr)
            if p.batched and len(allocs) > 1:
                runtime_metrics.inc_lease_batch_granted(len(allocs))
            for instances in allocs:
                self._grants_waiting_worker.append(
                    (p, spec.resources, instances, None, -1, batch))
        self._pending_leases = still_pending

    def _try_dispatch_pg_locked(self, p: _PendingLease) -> bool:
        strategy = p.spec.strategy
        bundles = self._bundles.get(strategy.placement_group_id)
        if not bundles:
            # Bundle not on this node (caller routed here deliberately); reject
            # so the caller re-resolves placement.
            self.server.send_reply(p.reply_token, {"rejected": True, "reason": "no bundle on node"})
            return True
        indices = [strategy.bundle_index] if strategy.bundle_index >= 0 else sorted(bundles)
        allocs = []
        for _ in range(p.count):
            got = None
            for i in indices:
                b = bundles.get(i)
                if b is None or not b.committed:
                    continue
                if p.spec.resources.is_subset_of(b.available):
                    b.available = b.available - p.spec.resources
                    want = {
                        name: int(p.spec.resources.get(name))
                        for name in b.instances
                        if int(p.spec.resources.get(name))
                    }
                    instances = {name: b.instances[name][:n] for name, n in want.items()}
                    got = (instances, strategy.placement_group_id, i)
                    break
            if got is None:
                break
            allocs.append(got)
        if not allocs:
            return False
        batch = _LeaseBatch(p, expected=len(allocs))
        for instances, pg_id, i in allocs:
            self._grants_waiting_worker.append(
                (p, p.spec.resources, instances, pg_id, i, batch))
        return True

    def _try_grant_waiting_locked(self):
        from ray_tpu_torch._private import runtime_env as renv

        # Grants are matched to idle workers of the SAME runtime-env pool;
        # unmatched grants trigger spawns for their env (reference:
        # WorkerPool PopWorker with runtime-env-keyed idle pools).
        remaining: deque = deque()
        spawn_want: Dict[str, list] = {}
        while self._grants_waiting_worker:
            entry = self._grants_waiting_worker.popleft()
            p, batch = entry[0], entry[5]
            try:
                env = renv.normalize(p.spec.runtime_env)
                env_key = renv.env_hash(env)
                poisoned = self._env_failures.get(env_key)
                if poisoned is not None:
                    error, expiry = poisoned
                    if time.monotonic() < expiry:
                        raise RuntimeError(f"runtime_env setup failed: {error}")
                    del self._env_failures[env_key]  # backoff over; retry
                if not self._idle_workers.get(env_key):
                    want = spawn_want.setdefault(env_key, [0, env])
                    want[0] += 1
                    remaining.append(entry)
                    continue
                self._grant_one_locked(entry, env_key)
            except Exception as e:  # noqa: BLE001 — reject THIS grant only
                self._release_lease_resources(_Lease(
                    lease_id="", worker=None, demand=entry[1],
                    instances=entry[2], pg_id=entry[3], bundle_index=entry[4]))
                batch.failures.append(str(e))
                self._maybe_reply_batch_locked(batch)
        self._grants_waiting_worker = remaining
        budget = (global_config().maximum_startup_concurrency
                  - sum(self._starting.values()))
        for env_key, (count, env) in spawn_want.items():
            deficit = count - self._starting.get(env_key, 0)
            for _ in range(max(0, min(deficit, budget))):
                self._spawn_worker(env_key, env)
                budget -= 1

    def _grant_one_locked(self, entry, env_key: str):
        p, demand, instances, pg_id, bundle_index, batch = entry
        runtime_metrics.observe_schedule_latency(
            time.monotonic() - p.enqueue_time)
        if not p.batched:
            self._record_task_event(p.spec, "SCHEDULED")
        worker = self._idle_workers[env_key].popleft()
        self._lease_counter += 1
        lease_id = f"{self.node_id.hex()[:8]}-{self._lease_counter}"
        cfg = global_config()
        reusable = (not p.for_actor) and cfg.worker_lease_reuse_enabled
        lease = _Lease(
            lease_id=lease_id,
            worker=worker,
            demand=demand,
            instances=instances,
            pg_id=pg_id,
            bundle_index=bundle_index,
            for_actor=p.for_actor,
            retriable=(not p.for_actor) and p.spec.max_retries != 0,
            granted_at=time.monotonic(),
            reusable=reusable,
            expires_at=(time.monotonic() + cfg.worker_lease_ttl_s
                        if reusable else float("inf")),
        )
        self._leases[lease_id] = lease
        worker.lease_id = lease_id
        if p.for_actor:
            worker.dedicated_actor = p.spec.actor_id
        if worker.proc is not None and p.spec.job_id is not None:
            # job attribution for the log plane (approximate: a reused worker
            # is re-tagged at its next lease, like the reference's log runtime)
            self._log_monitor.set_job(worker.proc.pid, p.spec.job_id.hex())
        batch.leases.append({
            "worker_addr": worker.address,
            "worker_id": worker.worker_id,
            "lease_id": lease_id,
            "node_id": self.node_id,
            "resource_instances": instances,
            "raylet_addr": self.server.address,
            "reusable": reusable,
            "ttl_s": cfg.worker_lease_ttl_s if reusable else None,
        })
        self._maybe_reply_batch_locked(batch)

    def _maybe_reply_batch_locked(self, batch: _LeaseBatch):
        """Send the ONE reply of a (possibly batched) lease request once
        every allocated unit has settled (got a worker or failed)."""
        if not batch.settled():
            return
        p = batch.pending
        if not batch.leases:
            self.server.send_reply(
                p.reply_token,
                {"rejected": True,
                 "reason": batch.failures[0] if batch.failures else "no grant"})
            return
        if p.batched:
            reply = {"leases": batch.leases}
            if batch.spill_addr is not None:
                reply["spillback"] = batch.spill_addr
            self.server.send_reply(p.reply_token, reply)
        else:
            self.server.send_reply(p.reply_token, batch.leases[0])

    # -- lease TTL: extension + idle reclaim ---------------------------------

    def HandleExtendLease(self, req):
        """Owner-side lease-cache keep-alive: extend every held lease's TTL
        in one call; the reply carries which leases no longer exist (TTL
        already reclaimed them) and whether this node is draining, so the
        owner invalidates promptly instead of discovering via dead pushes."""
        ids = req.get("lease_ids") or []
        now = time.monotonic()
        ttl = global_config().worker_lease_ttl_s
        valid, invalid = [], []
        with self._lock:
            for lid in ids:
                lease = self._leases.get(lid)
                if lease is None:
                    invalid.append(lid)
                    continue
                if not self._draining:
                    lease.expires_at = now + ttl
                valid.append(lid)
            return {"valid": valid, "invalid": invalid,
                    "draining": self._draining}

    def _reclaim_expired_leases(self):
        """Reusable leases whose TTL lapsed (owner dead, extensions lost):
        probe the worker's queue — still flowing tasks extend, an empty
        queue revokes (worker back to the idle pool, owner told via the
        LeaseRevoked mark so any straggler push is refused)."""
        now = time.monotonic()
        with self._lock:
            expired = [l for l in self._leases.values()
                       if l.reusable and not l.for_actor
                       and now > l.expires_at]
        ttl = global_config().worker_lease_ttl_s
        for lease in expired:
            busy = True
            try:
                state = self.pool.get(lease.worker.address).call(
                    "LeaseState", {"lease_id": lease.lease_id},
                    timeout=2, retry_deadline=0.0)
                busy = bool(state and state.get("queued"))
            except Exception:  # noqa: BLE001 — unreachable worker: the
                continue  # death monitor owns that case
            with self._lock:
                live = self._leases.get(lease.lease_id)
                if live is not lease or now <= live.expires_at:
                    continue
                if busy:
                    # tasks flow: the owner is alive even if its extension
                    # RPCs are being lost — keep extending
                    lease.expires_at = time.monotonic() + ttl
                    continue
                self._leases.pop(lease.lease_id, None)
                if lease.cpu_released:
                    lease.cpu_released = False
                    self._credit_cpu(lease, -lease.demand.get("CPU"))
                self._release_lease_resources(lease)
                w = lease.worker
                w.lease_id = None
                if w.worker_id in self._all_workers:
                    w.dedicated_actor = None
                    w.idle_since = time.monotonic()
                    self._idle_workers[w.env_hash].append(w)
                self._dispatch_cv.notify_all()
            runtime_metrics.inc_lease_revoked()
            from ray_tpu_torch._private import flight_recorder

            flight_recorder.record("lease", "reclaim", lease.lease_id)
            logger.info("raylet %s: reclaimed idle expired lease %s",
                        self.node_id, lease.lease_id)
            try:
                self.pool.get(lease.worker.address).notify(
                    "LeaseRevoked", {"lease_id": lease.lease_id})
            except Exception:  # noqa: BLE001 — worker gone: the lease is reclaimed either way
                pass

    def _release_lease_resources(self, lease: _Lease):
        if lease.pg_id is not None:
            bundles = self._bundles.get(lease.pg_id)
            if bundles and lease.bundle_index in bundles:
                b = bundles[lease.bundle_index]
                b.available = (b.available + lease.demand)
        else:
            self.local_resources.release(lease.demand, lease.instances)

    def HandleReportWorkerEnvFailure(self, req):
        """A spawned worker's runtime-env setup failed: poison the env so
        waiting grants reject (RuntimeEnvSetupError analog) instead of
        respawning crashing workers forever."""
        env_hash = req.get("env_hash", "")
        with self._lock:
            # (error, expiry): re-poisoning extends the backoff; the grant
            # loop checks expiry, so no timer thread is needed
            self._env_failures[env_hash] = (
                req.get("error", "runtime_env setup failed"),
                time.monotonic() + 30.0,
            )
            self._dispatch_cv.notify_all()
        return True

    def HandleNotifyWorkerBlocked(self, req):
        """An executing worker is blocked in get() on objects that queued
        tasks may need to produce: lend its CPU back so those tasks can run
        — without this, N tasks blocked on each other's outputs across N
        CPUs deadlock (reference: node_manager.cc HandleNotifyWorkerBlocked /
        the blocked-worker CPU release)."""
        lease_id = req["lease_id"]
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or lease.cpu_released or lease.for_actor:
                return False
            cpu = lease.demand.get("CPU")
            if not cpu:
                return False
            lease.cpu_released = True
            self._credit_cpu(lease, cpu)
            self._dispatch_cv.notify_all()
        return True

    def HandleNotifyWorkerUnblocked(self, req):
        """get() returned: take the CPU back immediately. Availability may go
        transiently negative (the lent CPU is in use) — matching reference
        semantics, where a resumed worker briefly oversubscribes; balance
        restores when either lease returns."""
        lease_id = req["lease_id"]
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or not lease.cpu_released:
                return False
            lease.cpu_released = False
            self._credit_cpu(lease, -lease.demand.get("CPU"))
        return True

    def _credit_cpu(self, lease: _Lease, cpu: float):
        """Add (or, negative, subtract) CPU to the pool the lease draws from.
        Caller holds self._lock."""
        delta = ResourceSet({"CPU": cpu})
        if lease.pg_id is not None:
            bundles = self._bundles.get(lease.pg_id)
            if bundles and lease.bundle_index in bundles:
                b = bundles[lease.bundle_index]
                # signed addition: bundle availability has no clamp to dodge
                b.available = b.available + delta
        elif cpu >= 0:
            self.local_resources.release(delta)
        else:
            self.local_resources.available = (
                self.local_resources.available - ResourceSet({"CPU": -cpu}))

    def HandleReturnWorker(self, req):
        lease_id = req["lease_id"]
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return False
            if lease.cpu_released:
                # the lent CPU was never reclaimed (task finished while
                # "blocked"); take it back first so the full release below
                # doesn't double-credit
                lease.cpu_released = False
                self._credit_cpu(lease, -lease.demand.get("CPU"))
            self._release_lease_resources(lease)
            w = lease.worker
            w.lease_id = None
            if req.get("worker_exiting") or w.worker_id not in self._all_workers:
                pass
            else:
                w.dedicated_actor = None
                w.idle_since = time.monotonic()
                self._idle_workers[w.env_hash].append(w)
            self._dispatch_cv.notify_all()
        return True

    def HandleDrainRaylet(self, req):
        req = req or {}
        return self._initiate_drain(
            reason=req.get("reason", "drain requested"),
            deadline_s=req.get("deadline_s"),
            source=req.get("source", "rpc"),
        )

    def HandleGetDrainInfo(self, req):
        """Workers poll this to expose ``preemption_deadline()`` through the
        runtime context (reference direction: the drain deadline hint the
        autoscaler v2 drain protocol carries)."""
        with self._lock:
            return {
                "draining": self._draining,
                "reason": self._drain_reason,
                "deadline": self._drain_deadline_ts,
            }

    def _on_maintenance_notice(self, notice: dict):
        """Maintenance watcher callback: the platform announced this host is
        going away — start the graceful drain with the announced window."""
        self._initiate_drain(
            reason=f"preemption: {notice.get('kind', 'maintenance')}",
            deadline_s=notice.get("deadline_s"),
            source="maintenance-watcher",
        )

    def _initiate_drain(self, reason: str, deadline_s: Optional[float] = None,
                        source: str = "rpc") -> bool:
        """Graceful drain: stop taking work, tell the GCS (reason+deadline),
        let running leases finish, then announce NodeDead("drained").

        reference: HandleDrainRaylet node_manager.cc:1893 grown into the full
        preemption lifecycle — queued leases are rejected so owners resubmit
        to surviving nodes; running work gets until the deadline."""
        if deadline_s is None:
            deadline_s = global_config().drain_deadline_s
        from ray_tpu_torch._private import flight_recorder

        flight_recorder.record("drain", reason, f"deadline:{deadline_s:g}s")
        with self._lock:
            if self._draining:
                return True  # idempotent: first notice wins
            self._draining = True
            self._drain_reason = reason
            self._drain_deadline_ts = time.time() + deadline_s
            self._drain_deadline_mono = time.monotonic() + deadline_s
            pend = list(self._pending_leases)
            self._pending_leases.clear()
            # allocated-but-unstaffed grants (waiting on a worker spawn)
            # must flush too: staffing them AFTER the drain notice would
            # push fresh tasks onto a dying node
            grants = list(self._grants_waiting_worker)
            self._grants_waiting_worker.clear()
            for entry in grants:
                self._release_lease_resources(_Lease(
                    lease_id="", worker=None, demand=entry[1],
                    instances=entry[2], pg_id=entry[3],
                    bundle_index=entry[4]))
                entry[5].failures.append("draining")
                self._maybe_reply_batch_locked(entry[5])
            # local view: never spill new work onto ourselves again
            self.cluster.set_draining(self.node_id)
        logger.warning(
            "raylet %s draining (%s, via %s): deadline in %.0f s, "
            "%d queued leases rejected",
            self.node_id, reason, source, deadline_s, len(pend))
        for p in pend:
            self.server.send_reply(p.reply_token, {"rejected": True, "reason": "draining"})
        # the announcement must land — a silently lost DrainNode would leave
        # the GCS placing new work here and charging the eventual death as a
        # failure — so it retries off-thread until delivered (or the drain
        # window plus slack expires)
        threading.Thread(target=self._announce_drain, args=(reason, source),
                         daemon=True, name="raylet-drain-announce").start()
        threading.Thread(target=self._drain_monitor, daemon=True,
                         name="raylet-drain").start()
        return True

    def _announce_drain(self, reason: str, source: str):
        payload = {
            "node_id": self.node_id, "reason": reason,
            "deadline": self._drain_deadline_ts, "source": source,
        }
        give_up = self._drain_deadline_mono + 30.0
        while not self._stopped.is_set() and time.monotonic() < give_up:
            try:
                self.gcs.call("DrainNode", payload,
                              timeout=5, retry_deadline=0.0)
                return
            except Exception:  # noqa: BLE001 — GCS down/restarting; retry
                self._stopped.wait(1.0)
        logger.warning("raylet %s: DrainNode announcement never reached "
                       "the GCS", self.node_id)

    def _drain_monitor(self):
        """Wait for running leases to finish (or the deadline), then report
        this node DEAD("drained") and go silent."""
        while not self._stopped.is_set():
            with self._lock:
                idle = (not self._leases and not self._grants_waiting_worker
                        and not self._pending_leases)
            if idle or time.monotonic() >= self._drain_deadline_mono:
                break
            time.sleep(0.1)
        if self._stopped.is_set():
            return
        self._drain_complete.set()
        try:
            self.gcs.call("NodeDead",
                          {"node_id": self.node_id, "reason": "drained"},
                          timeout=5, retry_deadline=5.0)
        except Exception:  # noqa: BLE001 — the health sweep converges on
            pass  # DEAD("drained") from staleness if this never lands
        logger.warning("raylet %s drain complete: reported NodeDead(drained)",
                       self.node_id)

    # ------------------------------------------------------------------
    # Placement-group bundles (reference: node_manager.cc:1761,1777,1794;
    # placement_group_resource_manager.cc 2-phase)
    # ------------------------------------------------------------------

    def HandlePrepareBundles(self, req):
        pg_id = req["pg_id"]
        demands = {int(i): ResourceSet(r) for i, r in req["bundles"].items()}
        with self._lock:
            total = ResourceSet({})
            for d in demands.values():
                total = total + d
            instances_all = self.local_resources.allocate(total)
            if instances_all is None:
                return False
            bundles = self._bundles.setdefault(pg_id, {})
            cursor = {k: 0 for k in instances_all}
            for i, d in sorted(demands.items()):
                inst: Dict[str, list] = {}
                for name in instances_all:
                    n = int(d.get(name))
                    if n:
                        inst[name] = instances_all[name][cursor[name] : cursor[name] + n]
                        cursor[name] += n
                bundles[i] = _Bundle(reserved=d, available=ResourceSet.from_raw(dict(d.items())), instances=inst)
        return True

    def HandleCommitBundles(self, req):
        with self._lock:
            for b in self._bundles.get(req["pg_id"], {}).values():
                b.committed = True
            self._dispatch_cv.notify_all()
        return True

    def HandleReturnBundles(self, req):
        pg_id = req["pg_id"]
        with self._lock:
            bundles = self._bundles.pop(pg_id, None)
            if not bundles:
                return True
            # Kill workers leased against this PG, then release reservation.
            doomed = [l for l in self._leases.values() if l.pg_id == pg_id]
            for lease in doomed:
                self._leases.pop(lease.lease_id, None)
            total = ResourceSet({})
            instances: Dict[str, list] = {}
            for b in bundles.values():
                total = total + b.reserved
                for name, ids in b.instances.items():
                    instances.setdefault(name, []).extend(ids)
            self.local_resources.release(total, instances)
            self._dispatch_cv.notify_all()
        for lease in doomed:
            try:
                self.pool.get(lease.worker.address).notify("Exit", {"reason": "placement group removed"})
            except Exception:  # noqa: BLE001 — worker gone is the goal; exit notice is advisory
                pass
        return True

    # ------------------------------------------------------------------
    # Plasma endpoints (worker-facing; reference: plasma/store.h)
    # ------------------------------------------------------------------

    def HandlePlasmaCreate(self, req):
        oid = req["object_id"]
        owner = req.get("owner_addr")
        if owner is not None:
            with self._lock:
                self._object_owners[oid] = tuple(owner)
        return self.store.create(oid, req["size"])

    def HandlePlasmaSeal(self, req):
        self.store.seal(req["object_id"])
        return True

    def HandlePlasmaContains(self, req):
        return self.store.contains(req["object_id"])

    def HandlePlasmaGet(self, req, reply_token=None):
        oid = req["object_id"]
        timeout = req.get("timeout")
        got = self.store.get_shm_name(oid, timeout=0)
        if got is not None:
            return got

        def on_seal():
            value = self.store.get_shm_name(oid, timeout=0)
            self.server.send_reply(reply_token, value)

        already = self.store.on_sealed(oid, on_seal)
        if already:
            return self.store.get_shm_name(oid, timeout=0)
        if timeout is not None:
            def on_timeout():
                self.store.cancel_seal_callback(oid, on_seal)
                # Double-fire guard: if sealed raced the timer, on_seal already
                # replied and cancel was a no-op on an absent entry.
                if not self.store.contains(oid):
                    self.server.send_reply(reply_token, None)
            t = threading.Timer(timeout, on_timeout)
            t.daemon = True
            t.start()
        return RpcServer.DELAYED_REPLY

    def HandlePlasmaGetBatch(self, req):
        """Resolve N objects' locators in ONE round-trip (the
        ``ray_tpu_torch.get(list)`` fast path — N local plasma hits used to cost
        N ``PlasmaGet`` calls).  Non-blocking: an object not sealed here
        yet resolves to None and the caller falls back to the per-object
        waiting path."""
        return [self.store.get_locator(oid, timeout=0)
                for oid in req["object_ids"]]

    def HandlePlasmaFree(self, req):
        for oid in req["object_ids"]:
            self.store.free(oid)
            with self._lock:
                self._object_owners.pop(oid, None)
        return True

    def HandleObjectSize(self, req):
        return self.store.object_size(req["object_id"])

    # ------------------------------------------------------------------
    # Object transfer (reference: pull_manager.h:49 / push_manager.h:27 —
    # chunked node-to-node transfer; ownership-based directory)
    # ------------------------------------------------------------------

    def HandlePullObject(self, req):
        """Ensure object is in the local store, fetching remotely if needed."""
        oid: ObjectID = req["object_id"]
        if self.store.contains(oid):
            return True
        owner_addr = req.get("owner_addr")
        if owner_addr is None:
            return False
        try:
            loc = self.pool.get(tuple(owner_addr)).call("GetObjectLocations", {"object_id": oid})
        except Exception:  # noqa: BLE001
            return False
        if loc is None:
            return False
        if "value_bytes" in loc:  # small object served inline by the owner
            from ray_tpu_torch._private import serialization

            meta, raws = serialization.dumps_with_buffers(
                serialization.loads_inline(loc["value_bytes"])
            )
            self.store.put_bytes(oid, meta, raws)
            return True
        for node_addr in loc.get("nodes", []):
            if tuple(node_addr) == self.server.address:
                continue
            if self._fetch_from(tuple(node_addr), oid):
                with self._lock:
                    self._object_owners[oid] = tuple(owner_addr)
                self.store.mark_secondary(oid)
                try:
                    self.pool.get(tuple(owner_addr)).notify(
                        "AddObjectLocation", {"object_id": oid, "node_addr": self.server.address}
                    )
                except Exception:  # noqa: BLE001 — owner gone: the secondary copy GCs via LRU
                    pass
                return True
        return False

    def _fetch_from(self, node_addr: Tuple[str, int], oid: ObjectID) -> bool:
        chunk = global_config().object_transfer_chunk_bytes
        try:
            cli = self.pool.get(node_addr)
            size = cli.call("ObjectSize", {"object_id": oid})
            if size is None:
                return False
            self.store.create(oid, size)
            off = 0
            while off < size:
                data = cli.call(
                    "ReadObjectChunk", {"object_id": oid, "offset": off, "length": chunk}
                )
                if data is None:
                    return False
                self.store.write_into(oid, off, data)
                off += len(data)
            self.store.seal(oid)
            return True
        except Exception:  # noqa: BLE001
            logger.exception("fetch of %s from %s failed", oid, node_addr)
            return False

    def HandleReadObjectChunk(self, req):
        from ray_tpu_torch._private.rpc import oob_wrap

        data = self.store.read_object_bytes(
            req["object_id"], req["offset"], req["length"])
        # one copy total: read_object_bytes copies out of the store (the
        # entry may be evicted after); the out-of-band frame path then
        # writes that copy straight to the socket instead of pickling it
        # in-band (a second copy)
        return oob_wrap(data) if data is not None else None

    # ------------------------------------------------------------------
    # Push plane + broadcast fan-out (reference: push_manager.h:27 — the
    # owner initiates chunked pushes instead of N nodes pull-storming one
    # holder; broadcast propagates down a binary tree so every node uploads
    # to at most two children: the 1-GiB/50-node envelope shape)
    # ------------------------------------------------------------------

    def _push_to(self, target_addr: Tuple[str, int], oid: ObjectID,
                 owner_addr) -> bool:
        """Sender-driven chunked upload of a local sealed object."""
        chunk = global_config().object_transfer_chunk_bytes
        size = self.store.object_size(oid)
        if size is None:
            return False
        try:
            cli = self.pool.get(tuple(target_addr))
            begin = cli.call("ReceivePushBegin", {"object_id": oid, "size": size})
            if begin == "have":
                return True
            from ray_tpu_torch._private.rpc import oob_wrap

            off = 0
            while off < size:
                data = self.store.read_object_bytes(oid, off, chunk)
                if data is None:
                    return False
                cli.call("ReceivePushChunk",
                         {"object_id": oid, "offset": off,
                          "data": oob_wrap(data)})
                off += len(data)
            cli.call("ReceivePushEnd",
                     {"object_id": oid, "owner_addr": tuple(owner_addr) if owner_addr else None})
            return True
        except Exception:  # noqa: BLE001
            logger.exception("push of %s to %s failed", oid, target_addr)
            return False

    _PUSH_STALE_S = 60.0

    def HandleReceivePushBegin(self, req):
        oid = req["object_id"]
        if self.store.contains(oid):
            return "have"
        now = time.monotonic()
        with self._lock:
            started = self._push_receiving.get(oid)
            if started is not None and now - started < self._PUSH_STALE_S:
                return "busy"  # another push in flight; sender falls back
            if started is not None:
                # the previous sender died mid-push: reclaim the unsealed
                # allocation so this node isn't blocked forever
                try:
                    self.store.free(oid)
                except Exception:  # noqa: BLE001 — unsealed alloc may already be gone
                    pass
            self._push_receiving[oid] = now
        self.store.create(oid, req["size"])
        return "go"

    def HandleReceivePushChunk(self, req):
        self.store.write_into(req["object_id"], req["offset"], req["data"])
        return True

    def HandleReceivePushEnd(self, req):
        oid = req["object_id"]
        self.store.seal(oid)
        self.store.mark_secondary(oid)
        with self._lock:
            self._push_receiving.pop(oid, None)
        owner = req.get("owner_addr")
        if owner:
            with self._lock:
                self._object_owners[oid] = tuple(owner)
            try:
                self.pool.get(tuple(owner)).notify(
                    "AddObjectLocation",
                    {"object_id": oid, "node_addr": self.server.address})
            except Exception:  # noqa: BLE001 — owner gone: location add is advisory
                pass
        return True

    def HandleBroadcastObject(self, req):
        """Push the object to the first node of each half of ``targets``,
        then delegate the halves — a binary spanning tree rooted here.
        Requires the object to be local (the parent pushed it first)."""
        oid: ObjectID = req["object_id"]
        owner = req.get("owner_addr")
        targets = [tuple(t) for t in req.get("targets", [])
                   if tuple(t) != self.server.address]
        if not self.store.contains(oid):
            return {"ok": False, "reason": "object not local"}
        if not targets:
            return {"ok": True, "pushed": 0}
        pushed = 0
        halves = [targets[0::2], targets[1::2]]
        subcalls = []
        for half in halves:
            if not half:
                continue
            head, rest = half[0], half[1:]
            if self._push_to(head, oid, owner):
                pushed += 1
                if rest:
                    subcalls.append((head, rest))
            else:
                # absorb the failed head's subtree locally (flat fallback)
                for t in rest:
                    pushed += 1 if self._push_to(t, oid, owner) else 0
        for head, rest in subcalls:
            delegated = False
            try:
                sub = self.pool.get(head).call(
                    "BroadcastObject",
                    {"object_id": oid, "owner_addr": owner, "targets": rest},
                    timeout=None)
                if isinstance(sub, dict) and sub.get("ok"):
                    pushed += sub.get("pushed", 0)
                    delegated = True
            except Exception:  # noqa: BLE001
                logger.exception("broadcast delegation to %s failed", head)
            if not delegated:
                # absorb the orphaned subtree locally so no node is skipped
                for t in rest:
                    pushed += 1 if self._push_to(t, oid, owner) else 0
        return {"ok": True, "pushed": pushed}

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def HandleListObjects(self, req):
        """Per-object plasma listing for the state API (reference: `ray list objects`)."""
        with self._lock:
            oids = self.store.list_objects()
            return [
                {"object_id": oid.hex(), "size": self.store.object_size(oid)}
                for oid in oids
            ]

    def HandleCancelLease(self, req):
        """Drop a still-queued task before it is granted a worker
        (reference: ray.cancel on PENDING_SCHEDULING tasks)."""
        task_id = req["task_id"]
        with self._lock:
            for p in list(self._pending_leases):
                if not p.batched and p.spec.task_id == task_id:
                    self._pending_leases.remove(p)
                    self.server.send_reply(
                        p.reply_token,
                        {"rejected": True, "reason": "cancelled"})
                    return True
            remaining = deque()
            cancelled = False
            while self._grants_waiting_worker:
                entry = self._grants_waiting_worker.popleft()
                # batched fast-path requests carry a representative spec for
                # many tasks — only a dedicated (non-batched) grant can be
                # cancelled by task id
                if (not cancelled and not entry[0].batched
                        and entry[0].spec.task_id == task_id):
                    cancelled = True
                    self._release_lease_resources(_Lease(
                        lease_id="", worker=None, demand=entry[1],
                        instances=entry[2], pg_id=entry[3],
                        bundle_index=entry[4]))
                    entry[5].failures.append("cancelled")
                    self._maybe_reply_batch_locked(entry[5])
                    continue
                remaining.append(entry)
            self._grants_waiting_worker = remaining
            return cancelled

    # -- per-node agent endpoints (reference: dashboard/agent.py +
    # modules/reporter/; hosted on the raylet's RPC server) --------------

    def HandleAgentNodeStats(self, req):
        with self._lock:
            pids = [w.proc.pid for w in self._all_workers.values()
                    if w.proc is not None]
        return self._node_stats.collect(pids)

    def HandleAgentMetrics(self, req):
        """Per-node Prometheus exposition: this raylet process's local metric
        registry (reference: the per-node MetricsAgent's /metrics).  The
        head's /metrics stays the cluster-wide aggregate; this is the
        node-scoped view the dashboard/state API surface per node."""
        from ray_tpu_torch.util.metrics import collect_local, prometheus_text

        with self._lock:
            self._update_node_gauges_locked()
        return prometheus_text(collect_local())

    def _worker_addrs(self, pid=None):
        with self._lock:
            return [(w.proc.pid if w.proc else None, w.address)
                    for w in self._all_workers.values()
                    if w.address is not None
                    and (pid is None or (w.proc and w.proc.pid == pid))]

    def HandleAgentStacks(self, req):
        """Stack traces of every worker on this node (reference: py-spy
        dump via the reporter agent)."""
        out = []
        for pid, addr in self._worker_addrs(req.get("pid")):
            try:
                out.append(self.pool.get(tuple(addr)).call(
                    "DumpStacks", {}, timeout=10))
            except Exception as e:  # noqa: BLE001
                out.append({"pid": pid, "error": str(e)})
        return out

    def HandleAgentFlightRecorder(self, req):
        """Flight-recorder tails of this node's workers (and this raylet):
        the last N seconds of step phases, collective entry/exit marks and
        task/lease transitions per process.  Live workers answer over RPC
        (served off their RPC thread, so a wedged exec thread still
        replies); a worker that died is read from its crash-dump file —
        the post-mortem half of the recorder."""
        from ray_tpu_torch._private import flight_recorder

        seconds = req.get("seconds")
        limit = req.get("limit")
        payload = {"seconds": seconds, "limit": limit}
        out = [{"pid": os.getpid(), "role": "raylet",
                "entries": flight_recorder.tail(seconds=seconds, limit=limit)}]
        live_pids = set()
        # total probe budget below the state client's 15s call timeout:
        # several workers wedged in native code (GIL held, RPC thread
        # mute) each burn their full per-worker timeout, and serially
        # that would time out the WHOLE node out of the diagnose report
        deadline = time.monotonic() + 10.0
        for pid, addr in self._worker_addrs(req.get("pid")):
            live_pids.add(pid)
            try:
                remaining = deadline - time.monotonic()
                if remaining < 0.5:
                    raise TimeoutError(
                        "node probe budget exhausted (earlier workers "
                        "unresponsive)")
                row = self.pool.get(tuple(addr)).call(
                    "FlightRecorderTail", payload,
                    timeout=min(5.0, remaining))
                row["role"] = "worker"
                out.append(row)
            except Exception as e:  # noqa: BLE001
                row = {"pid": pid, "role": "worker", "error": str(e)}
                # same freshness horizon as the dead-file scan below: a
                # recycled pid must not surface a prior process's dump as
                # this worker's crash_dump
                dump = (flight_recorder.read_dump(
                    pid, max_age_s=max(seconds or 0, 600.0))
                    if pid else None)
                if dump is not None:
                    row["crash_dump"] = dump[-limit:] if limit else dump
                out.append(row)
        # workers already reaped from the pool left only their dump files:
        # scan the dump dir for recent .flight files no live worker owns
        # (bounded to the request window — the per-uid dir outlives
        # clusters, so unbounded scans would resurrect last week's crash)
        try:
            base = os.path.dirname(flight_recorder.dump_path())
            horizon = time.time() - max(seconds or 0, 600.0)
            want_pid = req.get("pid")
            for fn in sorted(os.listdir(base)):
                if not fn.endswith(".flight"):
                    continue
                try:
                    pid = int(fn[:-len(".flight")])
                except ValueError:
                    continue
                if pid in live_pids or (want_pid and pid != want_pid):
                    continue
                path = os.path.join(base, fn)
                try:
                    if os.path.getmtime(path) < horizon:
                        continue
                except OSError:
                    continue
                dump = flight_recorder.read_dump(pid)
                if dump:
                    out.append({"pid": pid, "role": "dead-worker",
                                "crash_dump":
                                    dump[-limit:] if limit else dump})
        except OSError:  # dump dir unreadable/absent: live rows only
            pass
        return out

    def HandleAgentNativeStacks(self, req):
        """Native (C/XLA-frame) stacks of a worker on this node — the key
        difference from AgentStacks: a worker WEDGED inside an XLA
        dispatch or the native arena still answers, because the dump
        rides a C-level signal handler, not an RPC the wedged worker
        must serve (reference: the reporter agent's py-spy dump)."""
        from ray_tpu_torch._private.native_stack import dump_native_stacks

        pid = req.get("pid")
        if pid is None:
            raise ValueError("AgentNativeStacks needs a pid")
        pid = int(pid)
        # only signal workers THIS raylet owns: SIGUSR2's default
        # disposition is termination, so an unrelated process with the
        # same pid on another node must never receive it
        if not any(p == pid for p, _ in self._worker_addrs(pid)):
            return None
        return {"pid": pid, "stacks": dump_native_stacks(pid)}

    def _proxy_worker_call(self, pid, method: str, payload: dict, reply_token):
        """Forward an agent endpoint to the worker owning ``pid`` with a
        delayed reply (shared by the profiler endpoints)."""
        addrs = self._worker_addrs(pid)
        if not addrs:
            raise ValueError(f"no worker with pid {pid}")
        _, addr = addrs[0]
        fut = self.pool.get(tuple(addr)).call_async(method, payload)
        server = self.server
        fut.add_done_callback(
            lambda f: server.send_error_reply(reply_token, f.exception())
            if f.exception() else server.send_reply(reply_token, f.result()))
        return RpcServer.DELAYED_REPLY

    def HandleAgentProfile(self, req, reply_token):
        """Sampling CPU profile of one worker (by pid)."""
        return self._proxy_worker_call(req.get("pid"), "CpuProfile", {
            "duration_s": req.get("duration_s", 5.0),
            "interval_s": req.get("interval_s", 0.01),
        }, reply_token)

    def HandleAgentTorchProfile(self, req, reply_token):
        """torch.profiler Chrome trace of one worker (by pid) — the
        device profiler analog of the reporter's py-spy endpoint."""
        return self._proxy_worker_call(req.get("pid"), "TorchProfile", {
            "duration_s": req.get("duration_s", 3.0),
            "logdir": req.get("logdir"),
        }, reply_token)

    def HandleListWorkers(self, req):
        """reference: `ray list workers` (worker pool state)."""
        with self._lock:
            idle = {w.worker_id for pool in self._idle_workers.values() for w in pool}
            return [
                {"worker_id": w.worker_id.hex(),
                 "pid": w.proc.pid if w.proc is not None else None,
                 "address": w.address,
                 "actor_id": w.dedicated_actor.hex() if w.dedicated_actor else None,
                 "idle": w.worker_id in idle}
                for w in self._all_workers.values()
            ]

    def HandleGetNodeStats(self, req):
        with self._lock:
            return {
                "node_id": self.node_id,
                "draining": self._draining,
                "num_workers": len(self._all_workers),
                "idle_workers": sum(len(p) for p in self._idle_workers.values()),
                "pending_leases": len(self._pending_leases),
                # resource shapes queued here — the autoscaler's demand signal
                # (reference: autoscaler load reports via GCS)
                "pending_demands": [
                    p.spec.resources.to_dict() for p in self._pending_leases
                ],
                "active_leases": len(self._leases),
                "resources": self.local_resources.snapshot(),
                "object_store_used": self.store.used_bytes(),
                "num_objects": len(self.store.list_objects()),
            }


class _PidHandle:
    """Minimal Popen-like wrapper around a bare pid for liveness checks."""

    def __init__(self, pid: int):
        self.pid = pid

    def poll(self):
        try:
            os.kill(self.pid, 0)
            return None
        except OSError:
            return -1

    def terminate(self):
        try:
            os.kill(self.pid, 15)
        except OSError:
            pass

    def kill(self):
        try:
            os.kill(self.pid, 9)
        except OSError:
            pass

    def wait(self, timeout=None):
        deadline = time.monotonic() + (timeout or 0)
        while self.poll() is None:
            if timeout is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("pid", timeout)
            time.sleep(0.05)
        return -1
