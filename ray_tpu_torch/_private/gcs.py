"""Global Control Service — the cluster control plane.

TPU-native rebuild of the reference GCS server
(reference: src/ray/gcs/gcs_server/gcs_server.h:91; actor manager
gcs_actor_manager.h:333; actor scheduler gcs_actor_scheduler.h:115;
placement groups gcs_placement_group_mgr.h:232; KV gcs_kv_manager.h;
health checks gcs_health_check_manager.h; task events gcs_task_manager.h).

One GCS per cluster, hosted in the head node process.  It owns cluster-level
metadata only — node/actor/job/placement-group tables and the KV store.
Object state stays with owners (SURVEY.md §1 cross-layer invariant).

Fault tolerance (reference: Redis persistence gcs_server.h:115-122; raylet
re-registration on HandleNotifyGCSRestart node_manager.cc:948): when
``persistence_path`` is set, the mutable tables (KV, jobs, actors, named
actors, placement groups) are snapshotted to disk atomically whenever dirty
and reloaded by a restarted GcsServer on the same address.  The node table is
NOT persisted — raylets re-register when their resource report returns
``{"restart": True}`` — and pubsub subscribers re-subscribe periodically, so
a restarted GCS reconverges without any state handoff beyond the snapshot.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.analysis.lock_witness import make_lock, make_rlock
from ray_tpu_torch._private import runtime_metrics
from ray_tpu_torch._private.config import RayTpuConfig, global_config
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, PlacementGroupID, WorkerID
from ray_tpu_torch._private.cluster_view import tree_partition
from ray_tpu_torch._private.resources import NodeResources, ResourceSet
from ray_tpu_torch._private.rpc import (
    ClientPool,
    ConnectionLost,
    RpcServer,
    encode_frame,
    oob_wrap,
)
from ray_tpu_torch._private.scheduler import ClusterResourceScheduler
from ray_tpu_torch._private.task_spec import ActorDiedError, TaskSpec

logger = logging.getLogger(__name__)


@dataclass
class NodeInfo:
    node_id: NodeID
    address: Tuple[str, int]          # raylet RPC address
    resources: NodeResources
    state: str = "ALIVE"              # ALIVE | DRAINING | DEAD
    last_report: float = field(default_factory=time.monotonic)
    is_head: bool = False
    # drain lifecycle (preemption / maintenance): why the node is draining,
    # the wall-clock deadline the platform announced, when the drain started
    # (monotonic, for the drain-latency metric), and why the node died
    drain_reason: str = ""
    drain_deadline: float = 0.0
    drain_started: float = 0.0
    death_reason: str = ""


@dataclass
class ActorInfo:
    actor_id: ActorID
    spec: TaskSpec                    # the creation task spec
    state: str = "PENDING"            # PENDING | ALIVE | RESTARTING | DEAD
    address: Optional[Tuple[str, int]] = None  # worker RPC address when alive
    node_id: Optional[NodeID] = None
    num_restarts: int = 0
    death_cause: str = ""
    name: Optional[str] = None
    detached: bool = False
    job_id: Optional[JobID] = None


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    bundles: List[ResourceSet]
    strategy: str
    state: str = "PENDING"            # PENDING | CREATED | REMOVED | RESCHEDULING
    bundle_nodes: List[Optional[NodeID]] = field(default_factory=list)
    name: Optional[str] = None
    soft_target_node_id: Optional[NodeID] = None
    slice_label: Optional[str] = None  # persisted so a GCS restart can resume scheduling


class Pubsub:
    """Push-based pubsub: GCS (or a raylet) pushes to subscriber RPC servers.

    reference: src/ray/pubsub/publisher.h:309 — the reference uses long-polls;
    we push directly since every process runs an RpcServer anyway.

    Two delivery planes share ``publish``:

    - **flat subscribers** (drivers/workers that called ``Subscribe``): the
      message is encoded ONCE per publish (``rpc.encode_frame``) and the
      identical frame is shipped to every subscriber — flat fan-out used to
      re-pickle the same payload N times.
    - **raylet relay tree** (control channels in ``TREE_CHANNELS``): every
      ALIVE raylet is a relay target; the GCS pushes ``RelayPublish`` to
      O(``pubsub_tree_fanout``) tree heads, each carrying the once-pickled
      payload frame plus the addresses of its subtree, and relays
      re-publish downward (the ``experimental.broadcast_object`` binary-
      tree shape applied to control traffic).  A relay that turns out dead
      is dropped from the tree and its subtree is delivered by direct GCS
      push, so one dead relay costs one publish of direct sends, not a
      silent dark subtree.
    """

    # control channels fanned out through the raylet relay tree (node
    # lifecycle + drain notices + watch-rule alerts; ACTOR:*/PG:* stay
    # flat — their subscriber sets are owners, not the whole cluster)
    TREE_CHANNELS = ("NODE", "ALERT")

    def __init__(self, pool: ClientPool, config: Optional[RayTpuConfig] = None):
        self._subs: Dict[str, List[Tuple[Tuple[str, int], str]]] = {}
        self._pool = pool
        self._config = config
        self._fails: Dict[Tuple[Tuple[str, int], str], int] = {}
        self._lock = make_lock("Pubsub._lock")
        # relay targets (alive raylets), insertion-ordered so the tree
        # shape is deterministic between publishes
        self._relays: Dict[Tuple[str, int], None] = {}

    def _fanout(self) -> int:
        cfg = self._config or global_config()
        return cfg.pubsub_tree_fanout

    def subscribe(self, channel: str, subscriber_addr: Tuple[str, int], method: str = "PubsubMessage"):
        with self._lock:
            subs = self._subs.setdefault(channel, [])
            key = (tuple(subscriber_addr), method)
            if key not in subs:
                subs.append(key)

    def unsubscribe(self, channel: str, subscriber_addr: Tuple[str, int]):
        with self._lock:
            subs = self._subs.get(channel, [])
            self._subs[channel] = [s for s in subs if s[0] != tuple(subscriber_addr)]

    def add_relay(self, addr: Tuple[str, int]):
        with self._lock:
            self._relays[tuple(addr)] = None

    def remove_relay(self, addr: Tuple[str, int]):
        with self._lock:
            self._relays.pop(tuple(addr), None)

    def publish(self, channel: str, message: Any):
        with self._lock:
            subs = list(self._subs.get(channel, []))
            relays = (list(self._relays)
                      if channel in self.TREE_CHANNELS else [])
        # flat plane: one encoded frame per method, reused by-reference
        # across every subscriber sharing it
        by_method: Dict[str, list] = {}
        for addr, method in subs:
            by_method.setdefault(method, []).append(addr)
        for method, addrs in by_method.items():
            parts = encode_frame(method, {"channel": channel,
                                          "message": message})
            for addr in addrs:
                key = (addr, method)
                try:
                    fut = self._pool.get(addr).call_async_frame(parts)
                except Exception:  # noqa: BLE001
                    self._note_publish_result(channel, key, ok=False)
                    continue
                # only UNREACHABILITY counts toward eviction — a handler
                # that raises proves the peer is alive (the error frame
                # came back)
                fut.add_done_callback(
                    lambda f, key=key: self._note_publish_result(
                        channel, key,
                        ok=not isinstance(f.exception(), ConnectionLost)))
        if relays:
            inner = pickle.dumps({"channel": channel, "message": message},
                                 protocol=5)
            for group in tree_partition(relays, self._fanout()):
                self._relay_send(inner, group[0], group[1:], "root")

    def _relay_send(self, inner: bytes, head: Tuple[str, int],
                    subtree: List[Tuple[str, int]], role: str):
        try:
            fut = self._pool.get(head).call_async(
                "RelayPublish", {"frame": oob_wrap(inner),
                                 "subtree": subtree})
        except Exception:  # noqa: BLE001
            self._on_relay_failure(inner, head, subtree)
            return
        runtime_metrics.inc_relay_publish(role)
        fut.add_done_callback(
            lambda f, head=head, subtree=subtree:
            self._on_relay_failure(inner, head, subtree)
            if isinstance(f.exception(), ConnectionLost) else None)

    def _on_relay_failure(self, inner: bytes, head: Tuple[str, int],
                          subtree: List[Tuple[str, int]]):
        """A relay was unreachable: drop it from the tree and deliver its
        subtree by direct push so THIS publish still reaches everyone
        below it.  Eviction is not a death sentence — a live raylet that
        merely hiccuped is re-added on its next resource report (the
        liveness proof), so only relays that stopped reporting stay out."""
        self.remove_relay(head)
        for t in subtree:
            self._relay_send(inner, t, [], "fallback")

    def _note_publish_result(self, channel: str, key, ok: bool):
        """Evict subscribers that stay unreachable (dead drivers that never
        unsubscribed), so publishing doesn't burn a connect attempt per dead
        peer forever.  Unreachability is an ADDRESS property: three strikes
        drop the peer from every channel at once."""
        evict = False
        with self._lock:
            if ok:
                # reachability proven for the whole ADDRESS: clear every
                # channel/method counter for it (eviction is address-wide)
                addr = key[0]
                self._fails = {k: v for k, v in self._fails.items()
                               if k[0] != addr}
                return
            n = self._fails.get(key, 0) + 1
            self._fails[key] = n
            if n >= 3:
                addr = key[0]
                for ch, subs in self._subs.items():
                    self._subs[ch] = [s for s in subs if s[0] != addr]
                self._fails = {k: v for k, v in self._fails.items()
                               if k[0] != addr}
                evict = True
        if evict:
            self._pool.invalidate(key[0])


class GcsServer:
    """All GCS managers behind one RpcServer."""

    def __init__(self, host: str = "127.0.0.1", config: Optional[RayTpuConfig] = None,
                 port: int = 0, persistence_path: Optional[str] = None):
        self.config = config or global_config()
        self.persistence_path = persistence_path
        self.pool = ClientPool()
        self.pubsub = Pubsub(self.pool, self.config)
        self.nodes: Dict[NodeID, NodeInfo] = {}
        # versioned cluster-view sync (reference: ray_syncer.h versioned
        # gossip): every node-state mutation bumps _view_version, replaces
        # that node's cached snap dict (snaps are replaced, never mutated,
        # so readers outside the lock see consistent entries), and appends
        # to the bounded changelog ring.  ReportResources serves changes-
        # since-known-version off the ring; full snapshots come from the
        # _view_cache (version, view, pickled_len) triple rebuilt lazily.
        self._view_version = 0
        self._node_snaps: Dict[NodeID, dict] = {}
        # pickled size per snap, computed ONCE per mutation so delta
        # replies can be metered without re-serializing per reporter
        self._snap_sizes: Dict[NodeID, int] = {}
        self._view_changelog: deque = deque(
            maxlen=max(16, self.config.cluster_view_changelog_len))
        self._view_cache: Optional[Tuple[int, dict, int]] = None
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}  # (namespace, name)
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self.named_pgs: Dict[str, PlacementGroupID] = {}
        self.jobs: Dict[JobID, dict] = {}
        self.kv: Dict[str, bytes] = {}
        self.scheduler = ClusterResourceScheduler()
        self.task_events: deque = deque(maxlen=self.config.task_events_max_buffer)
        self.metrics_by_reporter: Dict[str, dict] = {}
        # counters/histograms/sketches of EVICTED reporters, folded here so
        # cluster counters never step backwards under worker churn (the
        # "events that HAPPENED — they stay" invariant); keyed like the
        # CollectMetrics aggregate
        self._retired_metrics: Dict[tuple, dict] = {}
        # metrics history + watch engine: disabled => both stay
        # None and ReportMetrics pays one attribute read + None check
        self.history = None
        self.watch = None
        if self.config.metrics_history_enabled:
            from ray_tpu_torch._private.metrics_history import (
                MetricsHistory, WatchEngine, builtin_rules)

            self.history = MetricsHistory(self.config)
            if self.config.watch_rules_enabled:
                self.watch = WatchEngine(
                    self.history, config=self.config,
                    on_transition=self._on_watch_transition)
                if self.config.watch_builtin_rules_enabled:
                    for rule in builtin_rules(self.config):
                        self.watch.add_rule(rule)
        # cluster event log (reference: dashboard/modules/event/ +
        # src/ray/gcs/gcs_server event aggregation): bounded ring of
        # structured events surfaced by the dashboard and the state API
        self.events: deque = deque(maxlen=1000)
        self._event_seq = 0
        # monotonic per-severity totals — the ring above evicts, so metric
        # consumers (Prometheus rate/increase) need counters that never
        # decrease
        self._event_counts: Dict[str, int] = {}
        self._lock = make_rlock("GcsServer._lock")
        self._actor_queue: deque = deque()
        self._actor_cv = threading.Condition(self._lock)
        self._stopped = threading.Event()
        self._job_counter = 0
        from ray_tpu_torch._private.utils import DaemonExecutor

        self._actor_create_pool = DaemonExecutor(
            max_workers=32, thread_name_prefix="gcs-actor-create"
        )

        self._dirty = threading.Event()
        if self.persistence_path and os.path.exists(self.persistence_path):
            self._load_snapshot()

        self.server = RpcServer(host=host, port=port)
        self.server.register_all(self)
        # built-in runtime metrics: per-method RPC latency rides the server's
        # dispatch observer; a GCS hosted in a worker-less process pushes its
        # registry through the in-process adapter below
        self.server.observer = runtime_metrics.observe_gcs_rpc
        from ray_tpu_torch.util import metrics as _metrics

        _metrics.set_fallback_gcs(_LocalGcsChannel(self))
        self._threads = [
            threading.Thread(target=self._actor_scheduling_loop, daemon=True, name="gcs-actor-sched"),
            threading.Thread(target=self._health_check_loop, daemon=True, name="gcs-health"),
        ]
        if self.persistence_path:
            self._threads.append(
                threading.Thread(target=self._snapshot_loop, daemon=True, name="gcs-snapshot")
            )
        for t in self._threads:
            t.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def shutdown(self):
        self._stopped.set()
        with self._lock:
            self._actor_cv.notify_all()
        # stop feeding creation workers AND unblock the parked ones; their
        # in-flight RPCs abort fast because pool.close_all() marks every
        # client closed (rpc.py: closed clients never reconnect-retry)
        self._actor_create_pool.shutdown(cancel_futures=True)
        self.server.shutdown()
        self.pool.close_all()
        if self.persistence_path and self._dirty.is_set():
            try:
                self.snapshot_now()
            except Exception:  # noqa: BLE001
                logger.exception("GCS: final snapshot failed")

    # ------------------------------------------------------------------
    # Persistence (reference: gcs_server.h:115-122 Redis table storage;
    # here a pickled atomic file snapshot of the mutable tables)
    # ------------------------------------------------------------------

    _PERSISTED = ("kv", "jobs", "actors", "named_actors",
                  "placement_groups", "named_pgs")

    def _mark_dirty(self):
        self._dirty.set()

    def snapshot_now(self):
        with self._lock:
            # clear-before-capture (under the lock): a mutation racing this
            # snapshot re-sets the flag and gets picked up next round.
            # Serialize while holding the lock too — the table values are
            # shared mutable dataclasses, and a torn ActorInfo (state set,
            # address not yet) would be unrecoverable after reload.
            self._dirty.clear()
            state = {name: dict(getattr(self, name)) for name in self._PERSISTED}
            state["job_counter"] = self._job_counter
            blob = pickle.dumps(state)
        d = os.path.dirname(os.path.abspath(self.persistence_path)) or "."
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".gcs-snap-")
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self.persistence_path)  # atomic on POSIX
        except BaseException:
            self._dirty.set()  # not durable; retry next round
            try:
                os.unlink(tmp)
            except (OSError, UnboundLocalError):
                pass
            raise

    def _load_snapshot(self):
        with open(self.persistence_path, "rb") as f:
            state = pickle.load(f)
        with self._lock:
            for name in self._PERSISTED:
                getattr(self, name).update(state.get(name, {}))
            self._job_counter = state.get("job_counter", 0)
            # actors that were mid-(re)schedule go back on the queue; ALIVE
            # actors keep their worker address (their processes outlived us)
            for info in self.actors.values():
                if info.state in ("PENDING", "RESTARTING"):
                    self._actor_queue.append(info.actor_id)
            # PGs that were mid-schedule lost their _schedule_pg thread with the
            # old process; without a respawn they'd stay PENDING forever and
            # creation waiters would hang (unbounded when waiting on autoscaled
            # capacity).
            pending_pgs = [pg for pg in self.placement_groups.values()
                           if pg.state in ("PENDING", "RESCHEDULING")]
        for pg in pending_pgs:
            threading.Thread(
                # getattr: snapshots written before slice_label existed restore
                # PlacementGroupInfo dicts without the field
                target=self._schedule_pg, args=(pg, getattr(pg, "slice_label", None)),
                daemon=True, name="gcs-pg-resched",
            ).start()
        logger.info(
            "GCS: restored %d actors, %d kv keys, %d jobs, %d PGs from %s",
            len(self.actors), len(self.kv), len(self.jobs),
            len(self.placement_groups), self.persistence_path,
        )

    def _snapshot_loop(self):
        interval = self.config.gcs_snapshot_interval_s
        while not self._stopped.wait(interval):
            if self._dirty.is_set():
                try:
                    self.snapshot_now()
                except Exception:  # noqa: BLE001
                    logger.exception("GCS: periodic snapshot failed")

    # ------------------------------------------------------------------
    # Node management (reference: gcs_node_manager.h / gcs_resource_manager)
    # ------------------------------------------------------------------

    # a steady-state sync reply is {"view_version": int} — book its wire
    # cost as this constant instead of pickling every empty reply
    _EMPTY_SYNC_BYTES = len(pickle.dumps({"view_version": 1 << 62},
                                         protocol=5))

    def _bump_view_locked(self, node_id: NodeID):
        """One node-state mutation: new version, fresh snap (or tombstone —
        DEAD/removed nodes leave the snap table, and their absence at delta
        time IS the tombstone), changelog entry.  Caller holds self._lock."""
        self._view_version += 1
        info = self.nodes.get(node_id)
        if info is None or info.state == "DEAD":
            self._node_snaps.pop(node_id, None)
            self._snap_sizes.pop(node_id, None)
        else:
            snap = {
                **info.resources.snapshot(),
                "address": info.address, "state": info.state,
            }
            self._node_snaps[node_id] = snap
            self._snap_sizes[node_id] = len(pickle.dumps(snap, protocol=5))
        self._view_changelog.append((self._view_version, node_id))
        runtime_metrics.set_gcs_sync_version(self._view_version)

    def _view_snapshot(self) -> Tuple[int, dict, int]:
        """Cached full cluster view: (version, {nid: snap}, payload_len).

        The lock covers only O(N) pointer/integer work (snap-table copy +
        size sum off the per-mutation _snap_sizes) — nothing is pickled
        here, so a registration burst can't stall _actor_cv waiters behind
        snapshot serialization.  Snap dicts are replaced (never mutated)
        on change, so the copied view stays internally consistent.  The
        cache-store race is benign: any (version, view) pair captured
        under the lock is a valid snapshot to serve."""
        cache = self._view_cache
        if cache is not None and cache[0] == self._view_version:
            return cache
        with self._lock:
            version = self._view_version
            view = dict(self._node_snaps)
            nbytes = self._EMPTY_SYNC_BYTES + sum(self._snap_sizes.values())
        cache = (version, view, nbytes)
        self._view_cache = cache
        return cache

    def _view_delta_locked(self, known: int) -> Optional[dict]:
        """Changes since ``known``, or None when only a full snapshot can
        answer (version gap / changelog overflow / future version from a
        previous GCS incarnation).  Caller holds self._lock; cost is
        O(changes since known), not O(cluster size)."""
        v = self._view_version
        if known == v:
            return {"view_version": v}
        if not (0 <= known < v):
            return None
        if not self._view_changelog or self._view_changelog[0][0] > known + 1:
            return None  # ring no longer reaches back to `known`
        delta: Dict[NodeID, dict] = {}
        tombstones: List[NodeID] = []
        seen = set()
        for ver, nid in reversed(self._view_changelog):
            if ver <= known:
                break
            if nid in seen:
                continue
            seen.add(nid)
            snap = self._node_snaps.get(nid)
            if snap is None:
                tombstones.append(nid)
            else:
                delta[nid] = snap
        return {"view_version": v, "delta": delta, "tombstones": tombstones}

    def HandleRegisterNode(self, req):
        node_id: NodeID = req["node_id"]
        with self._lock:
            info = NodeInfo(
                node_id=node_id,
                address=tuple(req["address"]),
                resources=NodeResources(ResourceSet(req["resources"]), req.get("labels")),
                is_head=req.get("is_head", False),
            )
            self.nodes[node_id] = info
            self.scheduler.add_or_update_node(node_id, info.resources)
            self._bump_view_locked(node_id)
            self._actor_cv.notify_all()
        self.pubsub.add_relay(info.address)
        self.pubsub.publish("NODE", {"event": "alive", "node_id": node_id, "address": info.address})
        self._record_event("INFO", "gcs", f"node {node_id} joined",
                           node_id=node_id, address=info.address)
        version, view, nbytes = self._view_snapshot()
        runtime_metrics.add_gcs_sync_bytes("full", nbytes)
        return {"config_blob": self.config.to_blob(),
                "cluster_view": view, "view_version": version}

    def HandleReportResources(self, req):
        node_id: NodeID = req["node_id"]
        known = req.get("known_version", -1)
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or info.state == "DEAD":
                return {"restart": True}  # raylet should re-register (GCS restarted)
            info.last_report = time.monotonic()
            address = info.address
            available = req["available"]
            if info.resources.available.to_dict() != available:
                # only REAL availability changes bump the version (and wake
                # actor scheduling); an unchanged report is version-silent,
                # which is what makes the steady-state delta empty
                self.scheduler.update_available(node_id, available)
                self._bump_view_locked(node_id)
                self._actor_cv.notify_all()
            reply = self._view_delta_locked(known)
        # a report IS a liveness proof: re-admit this raylet to the pubsub
        # relay tree if a transient send failure evicted it (idempotent
        # dict set; dead relays stop reporting and stay out)
        self.pubsub.add_relay(address)
        if reply is None:
            version, view, nbytes = self._view_snapshot()
            runtime_metrics.add_gcs_sync_bytes("full", nbytes)
            return {"view_version": version, "cluster_view": view}
        # byte accounting without re-pickling the reply per reporter: the
        # per-snap sizes were computed once at mutation time; tombstones
        # are bare node ids (~the empty-frame constant each)
        nbytes = self._EMPTY_SYNC_BYTES
        for nid in reply.get("delta", ()):
            nbytes += self._snap_sizes.get(nid, 0)
        nbytes += self._EMPTY_SYNC_BYTES * len(reply.get("tombstones", ()))
        runtime_metrics.add_gcs_sync_bytes("delta", nbytes)
        return reply

    def HandleGetClusterView(self, req):
        version, view, nbytes = self._view_snapshot()
        runtime_metrics.add_gcs_sync_bytes("full", nbytes)
        return view

    def HandleDrainNode(self, req):
        """Begin a node's graceful drain (reference: gcs_node_manager drain +
        autoscaler v2 drain protocol).  Grows reason + deadline: the node is
        excluded from all new placement, a node-draining event goes out over
        pubsub, and actors with restart budget are proactively restarted on
        surviving nodes instead of waiting for health-check death."""
        node_id = req["node_id"]
        reason = req.get("reason", "drain requested")
        deadline = float(req.get("deadline") or 0.0)  # unix ts; 0 = unknown
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None:
                return False
            if info.state != "ALIVE":
                return True  # already draining/dead: idempotent
            info.state = "DRAINING"
            info.drain_reason = reason
            info.drain_deadline = deadline
            info.drain_started = time.monotonic()
            # still in the cluster view (running leases keep their booking)
            # but invisible to every new scheduling/placement decision
            self.scheduler.set_draining(node_id)
            self._bump_view_locked(node_id)
            restartable = [
                a.actor_id for a in self.actors.values()
                if a.node_id == node_id and a.state == "ALIVE"
                and (a.spec.max_restarts == -1
                     or a.num_restarts < a.spec.max_restarts)
                # pinned actors are excluded: a PG actor's bundle and a
                # hard-node-affinity actor's target are ON this very node —
                # killing them can't relocate them (the restart would wedge
                # in RESTARTING once the node is excluded); their owners
                # (train controller, the pinning caller) handle the drain
                and (a.spec.strategy is None
                     or (a.spec.strategy.kind != "placement_group"
                         and not (a.spec.strategy.kind == "node_affinity"
                                  and not a.spec.strategy.soft)))
            ]
        runtime_metrics.inc_node_drain(reason)
        logger.warning("GCS: node %s draining (%s); %d restartable actors "
                       "to relocate", node_id, reason, len(restartable))
        self.pubsub.publish("NODE", {"event": "draining", "node_id": node_id,
                                     "reason": reason, "deadline": deadline})
        self._record_event("WARNING", "gcs",
                           f"node {node_id} draining: {reason}",
                           node_id=node_id, reason=reason, deadline=deadline)
        # proactive restart: kill-with-restart-budget relocates the actor NOW
        # (the scheduler already excludes this node), instead of burning the
        # drain window waiting for the node to die under it
        for aid in restartable:
            self._kill_actor(aid, no_restart=False,
                             reason=f"node {node_id} draining")
        return True

    def HandleNodeDead(self, req):
        self._mark_node_dead(req["node_id"], req.get("reason", "reported dead"))
        return True

    def HandleGetAllNodeInfo(self, req):
        with self._lock:
            return [
                {
                    "node_id": nid,
                    "address": i.address,
                    "state": i.state,
                    "is_head": i.is_head,
                    "resources": i.resources.snapshot(),
                    "draining": i.state == "DRAINING",
                    "drain_reason": i.drain_reason,
                    "drain_deadline": i.drain_deadline,
                    "death_reason": i.death_reason,
                }
                for nid, i in self.nodes.items()
            ]

    def _mark_node_dead(self, node_id: NodeID, reason: str):
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None or info.state == "DEAD":
                return
            was_draining = info.state == "DRAINING"
            info.state = "DEAD"
            info.death_reason = reason
            self.scheduler.remove_node(node_id)
            self._bump_view_locked(node_id)  # snap leaves: the tombstone
            dead_actors = [a for a in self.actors.values() if a.node_id == node_id and a.state in ("ALIVE", "PENDING")]
        self.pubsub.remove_relay(info.address)
        if was_draining and info.drain_started:
            # drain latency: DRAINING -> DEAD("drained"), the graceful window
            runtime_metrics.observe_drain_latency(
                time.monotonic() - info.drain_started)
        logger.warning("GCS: node %s dead (%s); %d actors affected", node_id, reason, len(dead_actors))
        self.pubsub.publish("NODE", {"event": "dead", "node_id": node_id})
        self._record_event("WARNING", "gcs", f"node {node_id} dead: {reason}",
                           node_id=node_id, affected_actors=len(dead_actors))
        for a in dead_actors:
            self._on_actor_worker_death(a.actor_id, f"node {node_id} died")

    def _health_check_loop(self):
        cfg = self.config
        period = cfg.heartbeat_interval_s
        while not self._stopped.wait(period):
            cutoff = time.monotonic() - period * cfg.health_check_failure_threshold
            with self._lock:
                # DRAINING nodes are swept too: a draining node that dies
                # ungracefully (preempted before the drain finished) must
                # not linger in DRAINING forever — it goes DEAD("drained")
                stale = [(nid, i.state) for nid, i in self.nodes.items()
                         if i.state in ("ALIVE", "DRAINING")
                         and i.last_report < cutoff and not i.is_head]
                runtime_metrics.set_gcs_sink_sizes(
                    len(self.task_events), len(self.metrics_by_reporter),
                    len(self.events))
            runtime_metrics.maybe_push()
            for nid, state in stale:
                self._mark_node_dead(
                    nid, "drained" if state == "DRAINING"
                    else "missed health checks")
            self._watch_tick()

    def _watch_tick(self):
        """History fold + watch-rule evaluation on the GCS tick: history
        keeps advancing (and absence rules keep firing) even when no
        reporter pushes arrive."""
        hist = self.history
        if hist is not None and hist.fold_due():
            try:
                hist.fold(self.HandleCollectMetrics({}))
                runtime_metrics.set_history_footprint(
                    hist.bytes_estimate(), hist.series_count())
            except Exception:  # noqa: BLE001
                logger.exception("GCS: metrics-history fold failed")
        if self.watch is not None:
            now = time.monotonic()
            with self._lock:
                ages = {r: now - s.get("recv", now)
                        for r, s in self.metrics_by_reporter.items()}
            try:
                self.watch.tick(reporter_ages=ages)
            except Exception:  # noqa: BLE001
                logger.exception("GCS: watch tick failed")

    def _on_watch_transition(self, rule, transition: dict):
        """A watch alert fired or cleared: count it, put it in the cluster
        event log, and fan it out on the ALERT tree channel for any
        control-plane subscriber (autoscaler, serve controller)."""
        state = transition["state"]
        runtime_metrics.inc_watch_alert(transition["rule"], state)
        severity = transition["severity"] if state == "firing" else "INFO"
        self._record_event(
            severity, "watch",
            f"watch rule {transition['rule']} {state} "
            f"({transition['key']}: {transition['value']:.4g} vs "
            f"threshold {transition['threshold']:.4g})",
            rule=transition["rule"], key=transition["key"], state=state,
            value=transition["value"], threshold=transition["threshold"])
        self.pubsub.publish("ALERT", transition)

    # ------------------------------------------------------------------
    # Jobs
    # ------------------------------------------------------------------

    def HandleRegisterJob(self, req):
        with self._lock:
            self._job_counter += 1
            job_id = JobID(f"{self._job_counter:08x}")
            self.jobs[job_id] = {"driver_addr": req.get("driver_addr"), "state": "RUNNING", "start": time.time()}
        self._mark_dirty()
        self._record_event("INFO", "gcs", f"job {job_id} started",
                           job_id=job_id)
        return job_id

    def HandleJobFinished(self, req):
        job_id = req["job_id"]
        with self._lock:
            if job_id in self.jobs:
                self.jobs[job_id]["state"] = "FINISHED"
            doomed = [
                a.actor_id
                for a in self.actors.values()
                if a.job_id == job_id and not a.detached and a.state in ("ALIVE", "PENDING", "RESTARTING")
            ]
        self._mark_dirty()
        for aid in doomed:
            self._kill_actor(aid, no_restart=True, reason="job finished")
        return True

    # ------------------------------------------------------------------
    # Internal KV (reference: gcs_kv_manager.h)
    # ------------------------------------------------------------------

    def HandleKVPut(self, req):
        with self._lock:
            existed = req["key"] in self.kv
            if not req.get("overwrite", True) and existed:
                return False
            self.kv[req["key"]] = req["value"]
        self._mark_dirty()
        return not existed

    def HandleKVGet(self, req):
        with self._lock:
            return self.kv.get(req["key"])

    def HandleKVMultiGet(self, req):
        with self._lock:
            return {k: self.kv[k] for k in req["keys"] if k in self.kv}

    def HandleKVDel(self, req):
        with self._lock:
            existed = self.kv.pop(req["key"], None) is not None
        if existed:
            self._mark_dirty()
        return existed

    def HandleKVKeys(self, req):
        prefix = req.get("prefix", "")
        with self._lock:
            return [k for k in self.kv if k.startswith(prefix)]

    def HandleKVExists(self, req):
        with self._lock:
            return req["key"] in self.kv

    # ------------------------------------------------------------------
    # Pubsub endpoints
    # ------------------------------------------------------------------

    def HandleSubscribe(self, req):
        self.pubsub.subscribe(req["channel"], tuple(req["subscriber_addr"]))
        return True

    def HandleUnsubscribe(self, req):
        self.pubsub.unsubscribe(req["channel"], tuple(req["subscriber_addr"]))
        return True

    def HandlePublish(self, req):
        self.pubsub.publish(req["channel"], req["message"])
        return True

    # ------------------------------------------------------------------
    # Actor management (reference: gcs_actor_manager.h:333,352,361,439)
    # ------------------------------------------------------------------

    def HandleRegisterActor(self, req):
        spec: TaskSpec = req["spec"]
        actor_id = spec.actor_id
        with self._lock:
            if spec.actor_name:
                key = (req.get("namespace", "default"), spec.actor_name)
                if key in self.named_actors:
                    existing = self.actors.get(self.named_actors[key])
                    if existing is not None and existing.state != "DEAD":
                        raise ValueError(f"actor name {spec.actor_name!r} already taken")
                self.named_actors[key] = actor_id
            info = ActorInfo(
                actor_id=actor_id,
                spec=spec,
                name=spec.actor_name,
                detached=spec.detached,
                job_id=spec.job_id,
            )
            self.actors[actor_id] = info
            self._actor_queue.append(actor_id)
            self._actor_cv.notify_all()
        self._mark_dirty()
        return True

    def HandleGetActorInfo(self, req):
        with self._lock:
            info = self.actors.get(req["actor_id"])
            if info is None:
                return None
            return {
                "actor_id": info.actor_id,
                "state": info.state,
                "address": info.address,
                "node_id": info.node_id,
                "death_cause": info.death_cause,
                "name": info.name,
            }

    def HandleGetNamedActor(self, req):
        key = (req.get("namespace", "default"), req["name"])
        with self._lock:
            actor_id = self.named_actors.get(key)
            if actor_id is None:
                return None
            info = self.actors.get(actor_id)
            if info is None or info.state == "DEAD":
                return None
            return {"actor_id": actor_id, "spec": info.spec, "address": info.address, "state": info.state}

    def HandleListNamedActors(self, req):
        with self._lock:
            return [
                {"namespace": ns, "name": name, "actor_id": aid}
                for (ns, name), aid in self.named_actors.items()
                if self.actors.get(aid) and self.actors[aid].state != "DEAD"
            ]

    def HandleListActors(self, req):
        with self._lock:
            return [
                {
                    "actor_id": a.actor_id,
                    "state": a.state,
                    "name": a.name,
                    "node_id": a.node_id,
                    "num_restarts": a.num_restarts,
                    "class_name": a.spec.name,
                }
                for a in self.actors.values()
            ]

    def HandleKillActor(self, req):
        self._kill_actor(req["actor_id"], req.get("no_restart", True), reason="ray.kill")
        return True

    def _kill_actor(self, actor_id: ActorID, no_restart: bool, reason: str):
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None:
                return
            addr = info.address
            if no_restart:
                info.spec.max_restarts = 0
        if addr is not None:
            try:
                self.pool.get(addr).notify("KillActor", {"actor_id": actor_id, "reason": reason})
            except Exception:  # noqa: BLE001 — raylet gone: worker-death path reaps the actor anyway
                pass
        self._on_actor_worker_death(actor_id, reason, force_dead=no_restart)

    def HandleReportActorDeath(self, req):
        """Raylet or a caller observed the actor's worker die."""
        self._on_actor_worker_death(req["actor_id"], req.get("reason", "worker died"))
        return True

    def _on_actor_worker_death(self, actor_id: ActorID, reason: str, force_dead: bool = False):
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None or info.state == "DEAD":
                return
            if info.state == "RESTARTING" and not force_dead:
                # duplicate death report for the same incarnation (a drain's
                # proactive kill is followed by the raylet's worker-death
                # report): the restart is already queued — a second charge
                # would burn restart budget AND double-schedule the actor
                return
            can_restart = (not force_dead) and (
                info.spec.max_restarts == -1 or info.num_restarts < info.spec.max_restarts
            )
            if can_restart:
                info.state = "RESTARTING"
                info.num_restarts += 1
                info.address = None
                info.node_id = None
                self._actor_queue.append(actor_id)
                self._actor_cv.notify_all()
                state_msg = {"event": "restarting", "actor_id": actor_id, "num_restarts": info.num_restarts}
            else:
                info.state = "DEAD"
                info.death_cause = reason
                info.address = None
                state_msg = {"event": "dead", "actor_id": actor_id, "reason": reason}
        self._mark_dirty()
        self.pubsub.publish(f"ACTOR:{actor_id.hex()}", state_msg)
        if state_msg["event"] == "restarting":
            self._record_event(
                "WARNING", "gcs",
                f"actor {actor_id} restarting ({reason}), "
                f"attempt {state_msg['num_restarts']}", actor_id=actor_id)
        else:
            self._record_event("ERROR", "gcs",
                               f"actor {actor_id} died: {reason}",
                               actor_id=actor_id)

    # -- actor scheduling loop (reference: gcs_actor_scheduler.h:115) -----

    def _actor_scheduling_loop(self):
        while not self._stopped.is_set():
            with self._lock:
                while not self._actor_queue and not self._stopped.is_set():
                    self._actor_cv.wait(timeout=1.0)
                if self._stopped.is_set():
                    return
                actor_id = self._actor_queue.popleft()
                info = self.actors.get(actor_id)
                if info is None or info.state == "DEAD":
                    continue
                spec = info.spec
                strategy = spec.strategy
                if strategy is not None and strategy.kind == "placement_group":
                    # a PG actor runs on its bundle's node — the bundle
                    # already RESERVED the resources there, so availability-
                    # based selection would never pick a fully-reserved node
                    # (reference: gcs_actor_scheduler.h — leases against the
                    # bundle, not free capacity)
                    try:
                        node_id = self._pg_bundle_node(strategy)
                    except ValueError as e:
                        # unsatisfiable forever (e.g. bundle index out of
                        # range): fail the actor, don't requeue
                        info.state = "DEAD"
                        info.death_cause = str(e)
                        self._mark_dirty()
                        dead_msg = {"event": "dead", "actor_id": info.actor_id,
                                    "reason": str(e)}
                        node_id = None
                else:
                    node_id = self.scheduler.get_best_schedulable_node(
                        spec.resources, strategy, requires_available=True
                    )
                node = self.nodes.get(node_id) if node_id else None
            if info.state == "DEAD":
                # publish outside the lock (pubsub pushes over RPC)
                self.pubsub.publish(f"ACTOR:{info.actor_id.hex()}", dead_msg)
                continue
            if node is None:
                # No feasible node right now; retry when resources change.
                time.sleep(0.05)
                with self._lock:
                    self._actor_queue.append(actor_id)
                continue
            # Creation happens off-loop so gang actors whose constructors
            # rendezvous with each other can come up together (the reference's
            # GcsActorScheduler leases/creates via async RPC for the same
            # reason, gcs_actor_scheduler.h:263,323).
            self._actor_create_pool.submit(self._create_actor_guarded, info, node)

    def _pg_bundle_node(self, strategy) -> Optional[NodeID]:
        """Node hosting the strategy's bundle (None while the PG is not yet
        CREATED — the actor requeues until it is). Caller holds self._lock.
        Raises ValueError for a bundle index the PG doesn't have — that can
        never become schedulable and must fail the actor, not requeue."""
        pg = self.placement_groups.get(strategy.placement_group_id)
        if pg is None or pg.state != "CREATED" or not pg.bundle_nodes:
            return None
        idx = strategy.bundle_index
        if idx >= len(pg.bundle_nodes):
            raise ValueError(
                f"placement_group_bundle_index={idx} out of range for a "
                f"{len(pg.bundle_nodes)}-bundle placement group")
        if idx >= 0:
            return pg.bundle_nodes[idx]
        # bundle_index -1: any bundle; rotate so -1 actors spread over bundles
        nodes = [n for n in pg.bundle_nodes if n is not None]
        if not nodes:
            return None
        self._pg_rr = getattr(self, "_pg_rr", 0) + 1
        return nodes[self._pg_rr % len(nodes)]

    def _create_actor_guarded(self, info: ActorInfo, node: NodeInfo):
        try:
            self._create_actor_on_node(info, node)
        except Exception as e:  # noqa: BLE001
            if self._stopped.is_set():
                return  # shutdown aborted the RPC; don't requeue, just exit
            logger.warning(
                "GCS: actor %s creation on %s failed: %s", info.actor_id, node.node_id, e
            )
            time.sleep(0.1)
            with self._lock:
                if info.state != "DEAD":
                    self._actor_queue.append(info.actor_id)
                    self._actor_cv.notify_all()

    def _create_actor_on_node(self, info: ActorInfo, node: NodeInfo):
        """Lease a worker, then push the creation task
        (reference: LeaseWorkerFromNode gcs_actor_scheduler.h:263,
        CreateActorOnWorker :323)."""
        raylet = self.pool.get(node.address)
        lease = raylet.call(
            "RequestWorkerLease",
            {"spec": info.spec, "for_actor": True},
            timeout=self.config.actor_creation_timeout_s,
        )
        if lease.get("rejected"):
            raise RuntimeError(f"lease rejected: {lease.get('reason')}")
        worker_addr = tuple(lease["worker_addr"])
        reply = self.pool.get(worker_addr).call(
            "CreateActor",
            {"spec": info.spec, "lease": lease},
            timeout=self.config.actor_creation_timeout_s,
        )
        if not reply.get("ok"):
            raise RuntimeError(f"actor __init__ failed: {reply.get('error')}")
        with self._lock:
            info.state = "ALIVE"
            info.address = worker_addr
            info.node_id = node.node_id
        self._mark_dirty()
        self.pubsub.publish(
            f"ACTOR:{info.actor_id.hex()}",
            {"event": "alive", "actor_id": info.actor_id, "address": worker_addr},
        )

    # ------------------------------------------------------------------
    # Placement groups (reference: gcs_placement_group_mgr.h:232; 2-phase
    # prepare/commit node_manager.cc:1761,1777)
    # ------------------------------------------------------------------

    def HandleCreatePlacementGroup(self, req):
        pg_id: PlacementGroupID = req["pg_id"]
        bundles = [ResourceSet(b) for b in req["bundles"]]
        strategy = req.get("strategy", "PACK")
        name = req.get("name")
        slice_label = req.get("slice_label")
        with self._lock:
            if name:
                self.named_pgs[name] = pg_id
            info = PlacementGroupInfo(pg_id=pg_id, bundles=bundles, strategy=strategy,
                                      name=name, slice_label=slice_label)
            self.placement_groups[pg_id] = info
        self._mark_dirty()
        threading.Thread(
            target=self._schedule_pg, args=(info, slice_label), daemon=True, name="gcs-pg-sched"
        ).start()
        return True

    def _schedule_pg(self, info: PlacementGroupInfo, slice_label: Optional[str]):
        deadline = time.monotonic() + 3600.0
        while not self._stopped.is_set() and time.monotonic() < deadline:
            with self._lock:
                if info.state == "REMOVED":
                    return
                placement = self.scheduler.schedule_bundles(info.bundles, info.strategy, slice_label)
            if placement is None:
                time.sleep(0.1)
                continue
            if self._prepare_and_commit(info, placement):
                with self._lock:
                    info.state = "CREATED"
                    info.bundle_nodes = placement
                self._mark_dirty()
                self.pubsub.publish(f"PG:{info.pg_id.hex()}", {"event": "created", "pg_id": info.pg_id})
                return
            time.sleep(0.1)

    def _prepare_and_commit(self, info: PlacementGroupInfo, placement: List[NodeID]) -> bool:
        by_node: Dict[NodeID, List[int]] = {}
        for i, nid in enumerate(placement):
            by_node.setdefault(nid, []).append(i)
        prepared = []
        try:
            for nid, idxs in by_node.items():
                node = self.nodes.get(nid)
                if node is None or node.state != "ALIVE":
                    raise RuntimeError(f"node {nid} unavailable")
                ok = self.pool.get(node.address).call(
                    "PrepareBundles",
                    {"pg_id": info.pg_id, "bundles": {i: info.bundles[i].to_dict() for i in idxs}},
                )
                if not ok:
                    raise RuntimeError(f"prepare rejected on {nid}")
                prepared.append(nid)
            for nid in by_node:
                self.pool.get(self.nodes[nid].address).call("CommitBundles", {"pg_id": info.pg_id})
            return True
        except Exception as e:  # noqa: BLE001
            logger.info("GCS: PG %s prepare/commit failed: %s", info.pg_id, e)
            for nid in prepared:
                node = self.nodes.get(nid)
                if node is not None:
                    try:
                        self.pool.get(node.address).call("ReturnBundles", {"pg_id": info.pg_id})
                    except Exception:  # noqa: BLE001 — best-effort rollback; node death releases its bundles
                        pass
            return False

    def HandleGetPlacementGroup(self, req):
        with self._lock:
            info = self.placement_groups.get(req["pg_id"])
            if info is None:
                return None
            return {
                "pg_id": info.pg_id,
                "state": info.state,
                "bundle_nodes": list(info.bundle_nodes),
                "strategy": info.strategy,
                "bundles": [b.to_dict() for b in info.bundles],
                "name": info.name,
            }

    def HandleGetNamedPlacementGroup(self, req):
        with self._lock:
            pg_id = self.named_pgs.get(req["name"])
            if pg_id is None:
                return None
            info = self.placement_groups.get(pg_id)
            if info is None or info.state == "REMOVED":
                return None
            return {"pg_id": pg_id, "bundles": [b.to_dict() for b in info.bundles], "state": info.state}

    def HandleRemovePlacementGroup(self, req):
        pg_id = req["pg_id"]
        with self._lock:
            info = self.placement_groups.get(pg_id)
            if info is None:
                return False
            info.state = "REMOVED"
            nodes = set(n for n in info.bundle_nodes if n is not None)
        self._mark_dirty()
        for nid in nodes:
            with self._lock:
                node = self.nodes.get(nid)
            if node is not None:
                try:
                    self.pool.get(node.address).call("ReturnBundles", {"pg_id": pg_id})
                except Exception:  # noqa: BLE001 — best-effort return; node death releases its bundles
                    pass
        self.pubsub.publish(f"PG:{pg_id.hex()}", {"event": "removed", "pg_id": pg_id})
        return True

    # ------------------------------------------------------------------
    # Task events (reference: gcs_task_manager.h — observability sink)
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # Cluster events (reference: dashboard/modules/event/ aggregator)
    # ------------------------------------------------------------------

    def _record_event(self, severity: str, source: str, message: str,
                      **metadata):
        with self._lock:
            self._event_seq += 1
            self._event_counts[severity] = \
                self._event_counts.get(severity, 0) + 1
            self.events.append({
                "event_id": self._event_seq,
                "ts": time.time(),
                "severity": severity,
                "source": source,
                "message": message,
                "metadata": {k: str(v) for k, v in metadata.items()},
            })

    def HandleRecordEvent(self, req):
        self._record_event(req.get("severity", "INFO"),
                           req.get("source", "user"), req["message"],
                           **(req.get("metadata") or {}))
        return True

    def HandleGetEventCounts(self, req):
        with self._lock:
            return dict(self._event_counts)

    def HandleListEvents(self, req):
        severity = req.get("severity")
        source = req.get("source")
        after_id = req.get("after_id", 0)
        limit = req.get("limit", 1000)
        with self._lock:
            rows = [e for e in self.events
                    if e["event_id"] > after_id
                    and (severity is None or e["severity"] == severity)
                    and (source is None or e["source"] == source)]
        return rows[-limit:]

    def HandleAddTaskEvents(self, req):
        with self._lock:
            self.task_events.extend(req["events"])
        return True

    def HandleListTaskEvents(self, req):
        limit = req.get("limit", 1000)
        trace_id = req.get("trace_id")
        with self._lock:
            if trace_id is not None:
                rows = [e for e in self.task_events
                        if e.get("trace_id") == trace_id]
            else:
                rows = list(self.task_events)
        return rows[-limit:]

    # ------------------------------------------------------------------
    # State-API listings + cluster metrics aggregate
    # (reference: util/state/api.py sources; _private/metrics_agent.py)
    # ------------------------------------------------------------------

    def HandleListJobs(self, req):
        with self._lock:
            return [
                {"job_id": jid.hex(), "state": j.get("state"), "start": j.get("start"),
                 "driver_addr": j.get("driver_addr")}
                for jid, j in self.jobs.items()
            ]

    def HandleListPlacementGroups(self, req):
        with self._lock:
            return [
                {
                    "pg_id": pg.pg_id,
                    "name": pg.name,
                    "state": pg.state,
                    "strategy": pg.strategy,
                    "bundles": [b.to_dict() for b in pg.bundles],
                    "bundle_nodes": list(pg.bundle_nodes),
                }
                for pg in self.placement_groups.values()
            ]

    def HandleReportMetrics(self, req):
        with self._lock:
            # "time" (reporter wall clock) orders gauge newest-wins between
            # reporters; "recv" (GCS-local monotonic) drives staleness —
            # cross-host clock skew must not expire a live node's gauges
            self.metrics_by_reporter[req["reporter"]] = {
                "points": req["points"], "time": req.get("time"),
                "recv": time.monotonic(),
            }
            # bound memory across worker churn: evict stalest reporters —
            # but counters/histograms/sketches are events that HAPPENED,
            # so fold them into the retired baseline first (cluster
            # counters must never step backwards because a reporter aged
            # out; gauges die with their reporter, as they should)
            while len(self.metrics_by_reporter) > 512:
                stalest = min(self.metrics_by_reporter,
                              key=lambda r: self.metrics_by_reporter[r]["time"] or 0)
                self._retire_reporter_locked(
                    self.metrics_by_reporter.pop(stalest))
        hist = self.history
        if hist is not None and hist.fold_due():
            # the actual fold is rate-limited (fold_due is one clock read
            # per push) and runs OUTSIDE the lock: CollectMetrics takes it
            # again briefly for the snapshot, then aggregation and the
            # history fold are lock-free
            hist.fold(self.HandleCollectMetrics({}))
            runtime_metrics.set_history_footprint(
                hist.bytes_estimate(), hist.series_count())
        return True

    def _retire_reporter_locked(self, snap: dict) -> None:
        """Fold an evicted reporter's cumulative points into the retired
        baseline (same merge semantics and keys as HandleCollectMetrics;
        gauges excluded — a gone reporter must stop asserting them)."""
        for p in snap.get("points", ()):
            kind = p.get("kind")
            if kind == "gauge":
                continue
            key = (p["name"], tuple(sorted(p.get("tags", {}).items())),
                   tuple(p.get("boundaries") or ()), p.get("accuracy"))
            cur = self._retired_metrics.get(key)
            if cur is None:
                self._retired_metrics[key] = dict(p)
            elif kind == "counter":
                cur["value"] += p["value"]
            elif kind == "histogram":
                cur["buckets"] = [a + b for a, b in
                                  zip(cur["buckets"], p["buckets"])]
                cur["sum"] += p["sum"]
                cur["count"] += p["count"]
            elif kind == "sketch":
                bins = dict((int(i), int(c)) for i, c in cur.get("bins", ()))
                for i, c in p.get("bins", ()):
                    bins[int(i)] = bins.get(int(i), 0) + int(c)
                cur["bins"] = sorted(bins.items())
                cur["zero"] = cur.get("zero", 0) + p.get("zero", 0)
                cur["sum"] += p["sum"]
                if cur.get("count") and p.get("count"):
                    cur["min"] = min(cur["min"], p["min"])
                    cur["max"] = max(cur["max"], p["max"])
                elif p.get("count"):
                    cur["min"], cur["max"] = p["min"], p["max"]
                cur["count"] = cur.get("count", 0) + p.get("count", 0)

    # gauges from reporters silent this long are dropped from the aggregate:
    # a dead node/worker must stop asserting its last chip counts / store
    # bytes (counters and histograms are events that HAPPENED — they stay)
    _GAUGE_STALE_S = 30.0

    def HandleCollectMetrics(self, req):
        """Aggregate across reporters: counters/histograms sum, gauges
        newest-report-wins (by the reporter's push timestamp) and only from
        recently-live reporters."""
        with self._lock:
            snapshots = [
                (s.get("time") or 0.0, s.get("recv", 0.0), s["points"])
                for s in self.metrics_by_reporter.values()
            ]
            # evicted reporters' cumulative counters/histograms/sketches
            # seed the aggregate (shallow copies: every merge below
            # REBINDS fields, never mutates the baseline's lists in place)
            retired = [dict(p) for p in self._retired_metrics.values()]
        gauge_cutoff = time.monotonic() - max(
            self._GAUGE_STALE_S,
            10 * global_config().metrics_report_interval_s)
        agg: dict = {}
        gauge_time: dict = {}
        for p in retired:
            key = (p["name"], tuple(sorted(p.get("tags", {}).items())),
                   tuple(p.get("boundaries") or ()), p.get("accuracy"))
            agg[key] = p
            gauge_time[key] = float("-inf")
        for report_time, recv_time, points in snapshots:
            stale = recv_time < gauge_cutoff
            for p in points:
                if stale and p["kind"] == "gauge":
                    continue
                # histograms additionally keyed by boundaries (mismatched
                # bucket layouts never get zip-truncated); sketches by
                # their relative accuracy (mismatched gammas don't merge)
                key = (p["name"], tuple(sorted(p.get("tags", {}).items())),
                       tuple(p.get("boundaries") or ()), p.get("accuracy"))
                cur = agg.get(key)
                if cur is None:
                    agg[key] = dict(p)
                    gauge_time[key] = report_time
                elif p["kind"] == "counter":
                    cur["value"] += p["value"]
                elif p["kind"] == "histogram":
                    cur["buckets"] = [a + b for a, b in zip(cur["buckets"], p["buckets"])]
                    cur["sum"] += p["sum"]
                    cur["count"] += p["count"]
                elif p["kind"] == "sketch":
                    # lossless fold: same-gamma log buckets add, so the
                    # aggregate's quantiles are those of the combined
                    # stream (the property plain histograms lack)
                    bins = dict((int(i), int(c)) for i, c in cur.get("bins", ()))
                    for i, c in p.get("bins", ()):
                        bins[int(i)] = bins.get(int(i), 0) + int(c)
                    cur["bins"] = sorted(bins.items())
                    cur["zero"] = cur.get("zero", 0) + p.get("zero", 0)
                    cur["sum"] += p["sum"]
                    if cur.get("count") and p.get("count"):
                        cur["min"] = min(cur["min"], p["min"])
                        cur["max"] = max(cur["max"], p["max"])
                    elif p.get("count"):
                        cur["min"], cur["max"] = p["min"], p["max"]
                    cur["count"] = cur.get("count", 0) + p.get("count", 0)
                elif report_time >= gauge_time[key]:
                    cur["value"] = p["value"]
                    gauge_time[key] = report_time
        return list(agg.values())

    # ------------------------------------------------------------------
    # Metrics history + watch engine (_private/metrics_history.py)
    # ------------------------------------------------------------------

    def HandleMetricHistory(self, req):
        """Query the in-GCS time-series store (state.metric_history /
        /api/metric_history): family + optional tags/window/step, plus an
        optional operator (rate/delta/avg_over_time/quantile_over_time)."""
        if self.history is None:
            return {"enabled": False, "series": []}
        return self.history.query_api(req or {})

    def HandleListAlerts(self, req):
        """Active watch alerts + rules + recent transitions
        (state.alerts / /api/alerts)."""
        if self.watch is None:
            return {"enabled": False, "alerts": [], "rules": [],
                    "transitions": []}
        return self.watch.report(rule=(req or {}).get("rule"))

    def HandleAddWatchRule(self, req):
        """Register (or replace, by name) a watch rule from a dict — the
        contract the future autoscaler/controller uses to install its own
        signals."""
        if self.watch is None:
            return False
        from ray_tpu_torch._private.metrics_history import WatchRule

        self.watch.add_rule(WatchRule.from_dict(req["rule"]))
        return True

    def HandleRemoveWatchRule(self, req):
        if self.watch is None:
            return False
        return self.watch.remove_rule(req["name"])


class _LocalGcsChannel:
    """In-process GCS channel for metric pushes from a worker-less head
    process (matches the RpcClient .call surface used by metrics.py; no
    socket hop for a server talking to itself)."""

    def __init__(self, gcs: GcsServer):
        self._gcs = gcs

    def call(self, method: str, payload, timeout=None, **_kw):
        return getattr(self._gcs, f"Handle{method}")(payload)
