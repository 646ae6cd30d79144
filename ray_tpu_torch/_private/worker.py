"""Per-process worker runtime: task submission/execution, ownership, memory.

TPU-native rebuild of the reference CoreWorker
(reference: src/ray/core_worker/core_worker.h:167 — SubmitTask :853,
CreateActor :878, SubmitActorTask :935, Put :482, Get :656,
ExecuteTask core_worker.cc:2804; TaskManager task_manager.h:170 for retries +
lineage; ReferenceCounter reference_count.h:73 for distributed refcounting;
NormalTaskSubmitter task_submission/normal_task_submitter.cc:29;
ActorTaskSubmitter + sequence-numbered receiver queues
task_execution/actor_scheduling_queue.cc).

The cross-layer invariant is the reference's ownership model: the process
that creates an ObjectRef owns it, holds its value (small objects) or its
location directory (plasma objects), its lineage, and its reference count.
"""

from __future__ import annotations

import hashlib
import logging
import os
import sys
import tempfile
import threading
import time
import traceback
import weakref
from collections import defaultdict, deque
from ray_tpu_torch._private.analysis.lock_witness import make_lock, make_rlock
from ray_tpu_torch._private.utils import DaemonExecutor, fast_getpid
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import flight_recorder, runtime_metrics, serialization
from ray_tpu_torch.util import tracing
from ray_tpu_torch._private.accelerators import bind_visible_accelerators
from ray_tpu_torch._private.config import global_config
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import PlasmaClient
from ray_tpu_torch._private.rpc import ClientPool, ConnectionLost, RemoteError, RpcServer
from ray_tpu_torch._private.task_spec import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
    OutOfMemoryError,
    RayTpuError,
    TaskSpec,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)

DRIVER = "driver"
WORKER = "worker"

# content digests of worker_process_setup_hook callables, memoized per live
# object (see _package_runtime_env)
_setup_hook_digests: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _weakrefable(obj) -> bool:
    try:
        weakref.ref(obj)
        return True
    except TypeError:
        return False


def _picklable_error(e: BaseException) -> BaseException:
    """The reply crosses the wire pickled; an exception holding locks/
    sockets/local classes would otherwise kill the reply and hang callers.
    Preserve the message and type name in a plain substitute."""
    import pickle as _pickle

    try:
        _pickle.dumps(e)
        return e
    except Exception:  # noqa: BLE001
        return RayTpuError(f"{type(e).__name__}: {e} (original exception "
                           "unpicklable; see traceback)")


class ObjectRef:
    """A reference to a (possibly not-yet-computed) object.

    Carries (object_id, owner address) in-band so any process can resolve it
    by talking to the owner (reference: ownership model, reference_count.h:73).
    """

    __slots__ = ("id", "owner_addr", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_addr: Tuple[str, int], _register: bool = True):
        self.id = object_id
        self.owner_addr = tuple(owner_addr) if owner_addr else None
        self._registered = False
        w = _global_worker
        if _register and w is not None:
            w.reference_counter.add_local_ref(self)
            self._registered = True

    def hex(self):
        return self.id.hex()

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:16]})"

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and self.id == other.id

    def __reduce__(self):
        # Serializing a ref hands it to a borrower; note the handoff so the
        # owner's count survives the transit (reference: reference_count.h:428).
        w = _global_worker
        if w is not None and not w.shutting_down:
            w.reference_counter.on_ref_serialized(self)
        return (_deserialize_ref, (self.id, self.owner_addr))

    def __del__(self):
        if not self._registered:
            return
        w = _global_worker
        if w is not None and not w.shutting_down:
            try:
                w.reference_counter.remove_local_ref(self)
            except Exception:  # noqa: BLE001 — __del__ during teardown: refcount is moot
                pass

    def future(self):
        from concurrent.futures import Future

        fut: Future = Future()

        def run():
            try:
                fut.set_result(get(self))
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True,
                         name="objectref-future-wait").start()
        return fut


class ObjectRefGenerator:
    """Iterator over a streaming task's yielded items (reference: the
    ObjectRefGenerator of num_returns='streaming' tasks).  Each __next__
    blocks until item i exists (or the stream completed/failed) and returns
    an ObjectRef to it — so consumers overlap with the producer."""

    def __init__(self, worker: "CoreWorker", spec):
        self._w = worker
        self._task_id = spec.task_id
        self._name = spec.name
        self._anchor = ObjectID.from_task(spec.task_id, 0)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        w = self._w
        oid = ObjectID.from_task(self._task_id, self._i + 1)
        missing_deadline = None
        with w._store_lock:
            while True:
                if oid in w.memory_store or w.object_locations.get(oid):
                    self._i += 1
                    return ObjectRef(oid, w.address)
                err = w.object_errors.get(self._anchor) or w.object_errors.get(oid)
                if err is not None:
                    # match ray_tpu_torch.get semantics: raise the user's original
                    # exception, not the TaskError wrapper
                    if isinstance(err, TaskError):
                        raise err.cause from None
                    raise err
                count = w.memory_store.get(self._anchor)
                if count is not None:
                    if self._i >= count:
                        raise StopIteration
                    # stream finished but item i hasn't landed: give the
                    # in-flight delivery a grace window, then fail loudly
                    # instead of hanging
                    if missing_deadline is None:
                        missing_deadline = (time.monotonic()
                                            + global_config().streaming_item_grace_s)
                    elif time.monotonic() > missing_deadline:
                        raise ObjectLostError(
                            f"streamed item {self._i + 1} of "
                            f"{self._name} never arrived")
                w._store_cv.wait(timeout=1.0)

    def completed(self) -> bool:
        with self._w._store_lock:
            return (self._anchor in self._w.memory_store
                    or self._anchor in self._w.object_errors)

    def close(self):
        """Free the anchor and every UNCONSUMED item (also runs on GC of
        the generator).  Consumed items were handed out as ObjectRefs and
        stay governed by normal reference counting."""
        w = self._w
        if w is None or w.shutting_down:
            return
        self._w = None
        plasma_nodes: Dict[Tuple, list] = {}
        with w._store_lock:
            finished = (self._anchor in w.memory_store
                        or self._anchor in w.object_errors)
            count = w.memory_store.pop(self._anchor, None)
            w.object_errors.pop(self._anchor, None)
            if not finished:
                # producer still running: mark the stream closed so later
                # items are dropped on arrival instead of stored forever
                w._closed_streams.add(self._task_id)
            i = self._i + 1
            while True:
                oid = ObjectID.from_task(self._task_id, i)
                found = (w.memory_store.pop(oid, None) is not None)
                locs = w.object_locations.pop(oid, None)
                if locs:
                    found = True
                    for addr in locs:
                        plasma_nodes.setdefault(tuple(addr), []).append(oid)
                found |= (w.object_errors.pop(oid, None) is not None)
                if not found and (count is None or i > count):
                    break
                i += 1
        # unconsumed plasma-resident items: free them on their raylets the
        # same way the normal release path does (otherwise the producer-side
        # allocations linger until LRU pressure)
        for addr, oids in plasma_nodes.items():
            try:
                w.pool.get(addr).notify("PlasmaFree", {"object_ids": oids})
            except Exception:  # noqa: BLE001 — raylet gone: its plasma copies died with it
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — __del__: close is best-effort by contract
            pass

    def __repr__(self):
        return f"ObjectRefGenerator({self._name}, next_index={self._i + 1})"


def _deserialize_ref(object_id, owner_addr):
    ref = ObjectRef(object_id, owner_addr, _register=True)
    w = _global_worker
    if w is not None and not w.shutting_down:
        w.reference_counter.on_ref_deserialized(ref)
    return ref


class ReferenceCounter:
    """Owner-side + borrower-side reference bookkeeping.

    reference: src/ray/core_worker/reference_count.h:73 (owned counts),
    :428,568-574 (borrower registration).  Owned objects are freed — memory
    value dropped, plasma copies freed cluster-wide, lineage released — when
    local refs + in-flight submissions + registered borrowers all reach zero.
    """

    def __init__(self, worker: "CoreWorker"):
        self._w = worker
        self._lock = make_lock("ReferenceCounter._lock")
        self._local: Dict[ObjectID, int] = defaultdict(int)
        self._owned_submitted: Dict[ObjectID, int] = defaultdict(int)  # args of in-flight tasks
        self._borrowers: Dict[ObjectID, Set[Tuple[str, int]]] = defaultdict(set)
        self._in_transit: Dict[ObjectID, int] = defaultdict(int)
        # GC-deferred releases. ObjectRef.__del__ runs whenever the garbage
        # collector does — including INSIDE add_local_ref's critical section
        # (a dict insert can allocate -> trigger gc -> run __del__): taking
        # self._lock there self-deadlocks the thread. Round-4 root cause of
        # the silent core-lane hang (caught by the faulthandler dead-man
        # switch: main thread parked in remove_local_ref under
        # add_local_ref, watchdog exception swallowed as unraisable inside
        # __del__). deque.append is atomic and allocation-light — the only
        # thing a finalizer may do here.
        self._pending_removals: deque = deque()

    # -- local handles ---------------------------------------------------

    def add_local_ref(self, ref: ObjectRef):
        self.drain_deferred()
        with self._lock:
            self._local[ref.id] += 1

    def remove_local_ref(self, ref: ObjectRef):
        """Finalizer-safe: defers the real work (see _pending_removals)."""
        self._pending_removals.append((ref.id, ref.owner_addr))

    def drain_deferred(self):
        """Apply deferred releases. Called from regular (non-finalizer)
        code paths; never from __del__."""
        while True:
            try:
                oid, owner_addr = self._pending_removals.popleft()
            except IndexError:
                return
            owner_is_self = owner_addr == self._w.address
            with self._lock:
                self._local[oid] -= 1
                if self._local[oid] > 0:
                    continue
                del self._local[oid]
            if owner_is_self:
                self._maybe_free(oid)
            else:
                # Borrower released its last handle: tell the owner.
                self._w.notify_owner(owner_addr, "RemoveBorrower",
                                     {"object_id": oid,
                                      "borrower": self._w.address})

    # -- transit / borrowers --------------------------------------------

    def on_ref_serialized(self, ref: ObjectRef):
        if ref.owner_addr == self._w.address:
            with self._lock:
                self._in_transit[ref.id] += 1
        else:
            # A borrower forwarding the ref: piggy-back a borrow registration.
            self._w.notify_owner(ref.owner_addr, "AddBorrowerTransit", {"object_id": ref.id})

    def on_ref_deserialized(self, ref: ObjectRef):
        if ref.owner_addr != self._w.address:
            self._w.notify_owner(ref.owner_addr, "AddBorrower", {"object_id": ref.id, "borrower": self._w.address})
        else:
            with self._lock:
                if self._in_transit.get(ref.id, 0) > 0:
                    self._in_transit[ref.id] -= 1

    # owner-side handlers
    def handle_add_borrower(self, object_id: ObjectID, borrower):
        with self._lock:
            self._borrowers[object_id].add(tuple(borrower))
            if self._in_transit.get(object_id, 0) > 0:
                self._in_transit[object_id] -= 1

    def handle_add_borrower_transit(self, object_id: ObjectID):
        with self._lock:
            self._in_transit[object_id] += 1

    def handle_remove_borrower(self, object_id: ObjectID, borrower):
        with self._lock:
            self._borrowers[object_id].discard(tuple(borrower))
        self._maybe_free(object_id)

    # -- task-arg pinning ------------------------------------------------

    def add_submitted_ref(self, object_id: ObjectID):
        with self._lock:
            self._owned_submitted[object_id] += 1

    def remove_submitted_ref(self, object_id: ObjectID):
        with self._lock:
            self._owned_submitted[object_id] -= 1
            if self._owned_submitted[object_id] <= 0:
                del self._owned_submitted[object_id]
        self._maybe_free(object_id)

    # -- freeing ---------------------------------------------------------

    def _maybe_free(self, object_id: ObjectID):
        with self._lock:
            if (
                self._local.get(object_id, 0) > 0
                or self._owned_submitted.get(object_id, 0) > 0
                or self._borrowers.get(object_id)
                or self._in_transit.get(object_id, 0) > 0
            ):
                return
            self._borrowers.pop(object_id, None)
            self._in_transit.pop(object_id, None)
        self._w.free_owned_object(object_id)


class TaskManager:
    """Owner-side task bookkeeping: pending set, retries, lineage.

    reference: src/ray/core_worker/task_manager.h:170 (retries + lineage),
    :489-493 (objects pending reconstruction).
    """

    def __init__(self):
        self.lock = make_lock("TaskManager.lock")
        self.cv = threading.Condition(self.lock)
        self.pending: Dict[TaskID, TaskSpec] = {}
        self.lineage: Dict[ObjectID, TaskSpec] = {}
        self.reconstructing: Set[ObjectID] = set()

    def add_pending(self, spec: TaskSpec):
        with self.lock:
            self.pending[spec.task_id] = spec
            for oid in spec.return_ids():
                self.lineage[oid] = spec

    def complete(self, task_id: TaskID):
        with self.lock:
            self.pending.pop(task_id, None)
            self.cv.notify_all()

    def is_pending(self, task_id: TaskID) -> bool:
        with self.lock:
            return task_id in self.pending

    def spec_for_object(self, object_id: ObjectID) -> Optional[TaskSpec]:
        with self.lock:
            return self.lineage.get(object_id)

    def release_lineage(self, object_id: ObjectID):
        with self.lock:
            self.lineage.pop(object_id, None)


class CoreWorker:
    """One per process (driver or worker)."""

    def __init__(
        self,
        mode: str,
        raylet_addr: Tuple[str, int],
        gcs_addr: Tuple[str, int],
        job_id: Optional[JobID] = None,
        node_id: Optional[NodeID] = None,
    ):
        self.mode = mode
        self.worker_id = WorkerID.random()
        self.shutting_down = False
        self.pool = ClientPool()
        self.raylet = self.pool.get(tuple(raylet_addr))
        self.gcs = self.pool.get(tuple(gcs_addr))
        self.node_id = node_id
        self.plasma = PlasmaClient(self.raylet)
        self.server = RpcServer()
        self.server.register_all(self)

        self.memory_store: Dict[ObjectID, Any] = {}
        self.object_locations: Dict[ObjectID, Set[Tuple[str, int]]] = defaultdict(set)
        self.object_errors: Dict[ObjectID, Exception] = {}
        # streaming tasks whose consumer went away: late items are dropped
        # instead of stored (guarded by _store_lock)
        self._closed_streams: Set[TaskID] = set()
        # owner-side cancellation marks + where each in-flight task runs
        self._cancelled_tasks: Set[TaskID] = set()
        self._task_exec_addr: Dict[TaskID, Tuple[str, int]] = {}
        self._task_lease_raylet: Dict[TaskID, Any] = {}
        # executor-side: thread running the current normal task; the lock
        # makes check-and-inject atomic against task completion so an async
        # KeyboardInterrupt can never land in a LATER, uncancelled task
        self._exec_thread_id: Optional[int] = None
        self._exec_state_lock = make_lock("CoreWorker._exec_state_lock")
        # RLock: ObjectRefGenerator.__del__ -> close() can be triggered by
        # GC inside a _store_lock critical section (allocations happen under
        # the lock); reentrancy beats a finalizer self-deadlock
        self._store_lock = make_rlock("CoreWorker._store_lock")
        self._store_cv = threading.Condition(self._store_lock)

        self.reference_counter = ReferenceCounter(self)
        self.task_manager = TaskManager()
        self._submit_pool = DaemonExecutor(max_workers=8, thread_name_prefix="task-submit")
        self._exec_pool = DaemonExecutor(max_workers=1, thread_name_prefix="task-exec")
        # executor-side pipelined-push state: pushed tasks queue FIFO in
        # _exec_pool; the registry below lets a CancelTask reach a task
        # still QUEUED behind another (prompt cancelled reply, executor
        # skips it), LeaseState answers the raylet's TTL reclaim probe,
        # and _stale_leases refuses pushes on revoked leases
        self._queue_lock = make_lock("CoreWorker._queue_lock")
        self._queued_tokens: Dict[TaskID, tuple] = {}  # -> (token, attempt, lease_id)
        self._lease_task_counts: Dict[str, int] = {}
        self._stale_leases: Set[str] = set()
        self._stale_lease_order: deque = deque()
        # owner-side lease cache + pipelined submission (the normal-task
        # fast path; see NormalTaskSubmitter below)
        self._submitter = NormalTaskSubmitter(self)
        self._published_fns: Set[str] = set()
        self._runtime_env_cache: Dict[str, Optional[dict]] = {}
        self._fn_cache: Dict[str, Any] = {}
        self._put_counter = 0
        self._counter_lock = make_lock("CoreWorker._counter_lock")
        self._task_events: List[dict] = []
        # guards the buffer against concurrent writers (actor concurrency
        # groups, proxy executor threads emitting spans): an unlocked
        # append racing flush's swap-and-serialize would drop events
        self._task_events_lock = make_lock("CoreWorker._task_events_lock")
        self._last_event_flush = 0.0
        self._event_flush_timer_armed = False
        # bind the flight-recorder hot path now (rebinds module-level
        # ``record`` from the disabled stub to the live ring)
        flight_recorder.get_recorder()

        # Actor-related state (server side: this worker hosts an actor)
        self.actor_id: Optional[ActorID] = None  # set when this worker hosts an actor
        self._actor_instance = None
        self._actor_spec: Optional[TaskSpec] = None
        self._actor_lease: Optional[dict] = None
        self._actor_exec_pool: Optional[DaemonExecutor] = None
        self._actor_group_pools: Dict[str, "DaemonExecutor"] = {}
        # lease held by the normal task currently executing on this worker
        # (for the blocked-in-get CPU release; actors never lend theirs)
        self._exec_lease_id: Optional[str] = None
        self._actor_seq_lock = make_lock("CoreWorker._actor_seq_lock")
        # per-caller ordered arrival queues (reference: ActorSchedulingQueue):
        # caller -> {"epoch": int, "next": int, "pending": {(epoch, seq): item}}
        self._actor_callers: Dict[str, dict] = {}
        # Client-side actor handle state
        self._actor_addr_cache: Dict[ActorID, Tuple[str, int]] = {}
        self._actor_state_cache: Dict[ActorID, str] = {}
        self._actor_pipelines: Dict[ActorID, "_ActorPipeline"] = {}
        self._actor_lock = make_lock("CoreWorker._actor_lock")
        self._actor_cv = threading.Condition(self._actor_lock)

        self.job_id = job_id
        self.log_to_driver = False
        if mode == DRIVER:
            self.job_id = self.gcs.call("RegisterJob", {"driver_addr": self.server.address})

        self.current_task_id: Optional[TaskID] = None
        # (task_id hex, attempt) of pushes received but not yet replied —
        # the owner's lost-push probe (HasTask) reads this; entries clear
        # when the reply goes out
        self._received_pushes: set = set()
        self._received_pushes_lock = make_lock("CoreWorker._received_pushes_lock")
        # cached GetDrainInfo from the local raylet: (expires_mono, info)
        self._drain_info_cache: Optional[Tuple[float, Optional[dict]]] = None
        # pubsub subscriptions this worker holds; re-issued periodically so a
        # restarted GCS (or a transient-failure eviction, gcs.py Pubsub
        # 3-strike rule) cannot silently orphan a live subscriber
        self._subscriptions: set = set()
        # ALERT channel fan-in: watch transition dicts delivered to every
        # registered callback (register_alert_handler)
        self._alert_handlers: list = []
        self._sub_lock = make_lock("CoreWorker._sub_lock")
        threading.Thread(target=self._resubscribe_loop, daemon=True,
                         name="pubsub-resubscribe").start()

    def _gcs_subscribe(self, channel: str):
        with self._sub_lock:
            self._subscriptions.add(channel)
        try:
            self.gcs.call("Subscribe", {"channel": channel,
                                        "subscriber_addr": self.server.address},
                          timeout=5, retry_deadline=0.0)
        except Exception:  # noqa: BLE001 — a lost Subscribe must not fail
            # the caller (actor creation, log echo): the periodic
            # resubscribe loop re-issues it within resubscribe_interval_s,
            # and actor state falls back to GCS polling meanwhile
            pass

    def _resubscribe_loop(self):
        interval = global_config().resubscribe_interval_s
        rounds = 0
        while not self.shutting_down:
            time.sleep(interval)
            if self.shutting_down:
                return
            rounds += 1
            # idle-time flush of GC-deferred ref releases (objects freed
            # even when no new refs are being created to trigger a drain)
            try:
                self.reference_counter.drain_deferred()
            except Exception:  # noqa: BLE001 — deferred releases retry next resubscribe tick
                pass
            # piggybacked metrics flush: runtime + user metrics recorded in
            # this process reach the GCS aggregate without their own loop
            runtime_metrics.maybe_push()
            # piggybacked span flush: a process that executes no tasks
            # (HTTP proxy host, idle driver) still publishes buffered
            # trace spans within one resubscribe tick
            try:
                self.flush_task_events()
            except Exception:  # noqa: BLE001 — span flush retries next tick; events are lossy
                pass
            with self._sub_lock:
                channels = list(self._subscriptions)
            # bound the set: a 'dead' pubsub event can be missed (GCS restart,
            # eviction), so periodically verify ACTOR channels against the
            # authoritative table and drop finished ones
            audit = rounds % 12 == 0
            for ch in channels:
                try:
                    if audit and ch.startswith("ACTOR:"):
                        from ray_tpu_torch._private.ids import ActorID

                        actor_id = ActorID(ch[len("ACTOR:"):])
                        info = self.gcs.call(
                            "GetActorInfo", {"actor_id": actor_id},
                            timeout=2, retry_deadline=0.0)
                        # info None can be a registration in flight
                        # (_create_actor subscribes BEFORE RegisterActor) —
                        # only a positively-DEAD actor is dropped, and the
                        # missed 'dead' event is applied to the caches
                        if info is not None and info.get("state") == "DEAD":
                            with self._sub_lock:
                                self._subscriptions.discard(ch)
                            with self._actor_lock:
                                self._actor_addr_cache.pop(actor_id, None)
                                self._actor_state_cache[actor_id] = "DEAD"
                                self._actor_cv.notify_all()
                            continue
                    self.gcs.call("Subscribe", {
                        "channel": ch, "subscriber_addr": self.server.address,
                    }, timeout=2, retry_deadline=0.0)
                except Exception:  # noqa: BLE001
                    break  # GCS unreachable; retry the whole set next round

    def subscribe_worker_logs(self):
        """Echo workers' stdout/stderr lines here (reference: log_to_driver)."""
        self.log_to_driver = True
        self._gcs_subscribe("WORKER_LOGS")

    # ------------------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def shutdown(self):
        self.shutting_down = True
        try:  # cached leases go back to their raylets (TTL covers misses)
            self._submitter.release_all_leases()
        except Exception:  # noqa: BLE001 — teardown: TTL reclaims leases the release misses
            pass
        try:  # final metrics flush: short-lived workers' points must land.
            # Short timeout, no reconnect-retry — teardown must not stall
            # behind a GCS that died first (FT tests kill it deliberately).
            from ray_tpu_torch.util import metrics as _metrics

            _metrics.push_to_gcs(timeout=2, retry_deadline=0.0)
        except Exception:  # noqa: BLE001 — teardown races GCS death by design (see above)
            pass
        with self._sub_lock:
            self._subscriptions.clear()
        if self.log_to_driver:
            try:
                self.gcs.call("Unsubscribe",
                              {"channel": "WORKER_LOGS",
                               "subscriber_addr": self.server.address}, timeout=5)
            except Exception:  # noqa: BLE001 — teardown: a dead GCS needs no unsubscribe
                pass
        if self.mode == DRIVER and self.job_id is not None:
            try:
                self.gcs.call("JobFinished", {"job_id": self.job_id}, timeout=5)
            except Exception:  # noqa: BLE001 — teardown: the job finishes implicitly if GCS died
                pass
        self._submit_pool.shutdown(wait=False, cancel_futures=True)
        self._exec_pool.shutdown(wait=False, cancel_futures=True)
        self.server.shutdown()
        self.plasma.close()
        self.pool.close_all()

    def get_preemption_deadline(self) -> Optional[float]:
        """Wall-clock deadline (unix seconds) by which this worker's node
        will be gone, or None when the node is not draining.  Exposed as
        ``get_runtime_context().preemption_deadline()`` so long-running user
        code (training steps, batch jobs) can checkpoint ahead of a
        preemption instead of dying with the node.  The raylet's drain state
        is polled with a ~1 s cache, so calling this every step is cheap."""
        now = time.monotonic()
        cached = self._drain_info_cache
        if cached is not None and now < cached[0]:
            info = cached[1]
        else:
            try:
                info = self.raylet.call("GetDrainInfo", {},
                                        timeout=2, retry_deadline=0.0)
            except Exception:  # noqa: BLE001
                info = None
            self._drain_info_cache = (now + 1.0, info)
        if info and info.get("draining"):
            return info.get("deadline")
        return None

    def notify_owner(self, owner_addr, method, payload):
        if owner_addr is None or self.shutting_down:
            return
        try:
            self.pool.get(tuple(owner_addr)).notify(method, payload)
        except Exception:  # noqa: BLE001 — owner gone: nothing left to notify
            pass

    # ------------------------------------------------------------------
    # Put / Get / Wait / Free
    # ------------------------------------------------------------------

    def put(self, value) -> ObjectRef:
        with self._counter_lock:
            self._put_counter += 1
            oid = ObjectID.from_put(self.worker_id, self._put_counter)
        self._store_value(oid, value)
        return ObjectRef(oid, self.address)

    def _store_value(self, oid: ObjectID, value):
        """Store an owned value: small → memory store, large → local plasma."""
        meta, raws = serialization.dumps_with_buffers(value)
        size = serialization.serialized_size(meta, raws)
        if size <= global_config().max_inline_object_size:
            with self._store_lock:
                self.memory_store[oid] = value
                self._store_cv.notify_all()
        else:
            from ray_tpu_torch._private.object_store import plasma_create_write_seal

            plasma_create_write_seal(self.raylet, oid, meta, raws, self.address)
            with self._store_lock:
                self.object_locations[oid].add(tuple(self._raylet_addr()))
                self._store_cv.notify_all()

    def _raylet_addr(self):
        return self.raylet.address

    def _blocked_lease_id(self, refs) -> Optional[str]:
        """Non-None when THIS call runs inside a normal task's execution
        thread and some ref isn't already local — the raylet should lend the
        task's CPU out while we block (deadlock avoidance: the producer of
        the awaited object may be queued behind us)."""
        if (self._exec_lease_id is None
                or self._exec_thread_id != threading.get_ident()):
            return None
        with self._store_lock:
            if all(r.id in self.memory_store or r.id in self.object_errors
                   for r in refs):
                return None
        return self._exec_lease_id

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        blocked_lease = self._blocked_lease_id(refs)
        if blocked_lease is not None:
            try:
                self.raylet.notify("NotifyWorkerBlocked", {"lease_id": blocked_lease})
            except Exception:  # noqa: BLE001
                blocked_lease = None
        try:
            deadline = None if timeout is None else time.monotonic() + timeout
            prefetched = self._prefetch_local_plasma(refs) if len(refs) > 1 else None
            out = [self._get_one(r, deadline, prefetched) for r in refs]
        finally:
            if blocked_lease is not None:
                try:
                    self.raylet.notify("NotifyWorkerUnblocked",
                                       {"lease_id": blocked_lease})
                except Exception:  # noqa: BLE001 — raylet gone: the blocked lease died with it
                    pass
        for v in out:
            if isinstance(v, TaskError):
                raise v.cause from None
            if isinstance(v, (ActorDiedError, ActorUnavailableError, ObjectLostError,
                              WorkerCrashedError, TaskCancelledError)):
                raise v
        return out[0] if single else out

    def _remaining(self, deadline):
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise GetTimeoutError("ray_tpu_torch.get timed out")
        return rem

    def _prefetch_local_plasma(self, refs):
        """Batch-resolve locally-sealed plasma objects in ONE raylet
        round-trip (PlasmaGetBatch) — ``ray_tpu_torch.get(list)`` of N local
        plasma objects used to pay N PlasmaGet calls.  Objects not local
        (or inline) fall through to the per-object path."""
        return self.resolve_plasma_batch(refs, min_batch=2)

    def resolve_plasma_batch(self, refs, min_batch: int = 1):
        """The data plane's zero-copy view path: resolve every locally-
        sealed plasma object among ``refs`` in ONE raylet round-trip
        (PlasmaGetBatch), returning ``{ObjectID: value}`` or None.  Values
        reconstruct as protocol-5 buffer views over the store's shared
        memory — numpy/Arrow payloads alias the mapping, no host copy.
        Objects not yet local or sealed are simply absent from the result;
        callers fall back to the ordinary per-object get for those."""
        with self._store_lock:
            # only objects with a KNOWN plasma location (or borrowed refs,
            # which may be plasma) are worth a batch probe — owned tasks
            # whose inline results are still in flight would turn the probe
            # into a wasted round-trip per get
            want = [r.id for r in refs
                    if r.id not in self.memory_store
                    and r.id not in self.object_errors
                    and (self.object_locations.get(r.id)
                         or (r.owner_addr is not None
                             and r.owner_addr != self.address))]
        if len(want) < min_batch:
            return None
        try:
            resolved = self.plasma.get_batch(
                want, pins={r.id: r for r in refs})
        except Exception:  # noqa: BLE001 — fall back to per-object gets
            return None
        return resolved or None

    def _get_one(self, ref: ObjectRef, deadline, prefetched=None):
        oid = ref.id
        if prefetched is not None and oid in prefetched:
            return prefetched.pop(oid)
        owner_is_self = ref.owner_addr == self.address or ref.owner_addr is None
        backoff = 0.001
        while True:
            # 1. local memory store
            with self._store_lock:
                if oid in self.memory_store:
                    return self.memory_store[oid]
                err = self.object_errors.get(oid)
            if err is not None:
                return err
            # 2. local plasma — skip the contains-RPC for owned objects
            # with no known plasma location: their value arrives inline via
            # the task reply, and probing the raylet every wait-loop pass
            # made each pending get pay an extra round-trip
            with self._store_lock:
                has_loc = bool(self.object_locations.get(oid))
            if has_loc or not owner_is_self:
                found, value = self._try_local_plasma(oid, ref)
                if found:
                    return value
            if owner_is_self:
                got = self._get_owned(oid, deadline, ref)
            else:
                got = self._get_borrowed(ref, deadline)
            if got is not _PENDING:
                return got
            self._remaining(deadline)
            # wait on the store condition instead of sleeping blind: a task
            # reply (inline value or plasma location) notifies _store_cv, so
            # a just-finished task wakes its getter immediately instead of
            # after a full backoff cycle
            with self._store_lock:
                if (oid not in self.memory_store
                        and oid not in self.object_errors
                        and not self.object_locations.get(oid)):
                    self._store_cv.wait(timeout=backoff)
            backoff = min(backoff * 2, 0.05)

    def _try_local_plasma(self, oid, pin=None):
        try:
            if self.plasma.contains(oid):
                return self.plasma.get(oid, timeout=0, pin=pin)
        except Exception:  # noqa: BLE001 — local probe; a miss falls back to remote fetch
            pass
        return False, None

    def _get_owned(self, oid: ObjectID, deadline, pin=None):
        # Value lives in plasma somewhere; pull to local store.
        with self._store_lock:
            locations = set(self.object_locations.get(oid, ()))
        if locations:
            ok = self.raylet.call(
                "PullObject", {"object_id": oid, "owner_addr": self.address},
                timeout=global_config().gcs_rpc_timeout_s,
            )
            if ok:
                found, value = self._try_local_plasma(oid, pin)
                if found:
                    return value
            # All copies lost → lineage reconstruction
            # (reference: object_recovery_manager.h:41).
            if self._try_reconstruct(oid):
                return _PENDING
            return ObjectLostError(oid)
        # No locations: task still running (or value in flight).
        if self.task_manager.spec_for_object(oid) is not None or oid in self._pending_put_ids():
            return _PENDING
        return _PENDING  # puts in progress / unknown; caller enforces timeout

    def _pending_put_ids(self):
        return ()

    def _try_reconstruct(self, oid: ObjectID) -> bool:
        if not global_config().lineage_reconstruction_enabled:
            return False
        spec = self.task_manager.spec_for_object(oid)
        if spec is None or spec.actor_id is not None:
            return False
        with self.task_manager.lock:
            if oid in self.task_manager.reconstructing:
                return True
            if spec.max_retries <= 0:
                return False
            spec.max_retries -= 1
            for roid in spec.return_ids():
                self.task_manager.reconstructing.add(roid)
        logger.info("reconstructing %s by re-executing task %s", oid, spec.name)
        spec.attempt += 1
        with self._store_lock:
            for roid in spec.return_ids():
                self.object_locations.pop(roid, None)
        self.task_manager.add_pending(spec)
        self._submitter.submit(spec)
        return True

    def _get_borrowed(self, ref: ObjectRef, deadline):
        try:
            loc = self.pool.get(ref.owner_addr).call(
                "GetObjectLocations", {"object_id": ref.id}, timeout=global_config().gcs_rpc_timeout_s
            )
        except (ConnectionLost, RemoteError):
            return ObjectLostError(ref.id)
        if loc is None:
            return _PENDING
        if "error" in loc:
            return loc["error"]
        if "value_bytes" in loc:
            value = serialization.loads_inline(loc["value_bytes"])
            with self._store_lock:
                self.memory_store[ref.id] = value
            return value
        ok = self.raylet.call(
            "PullObject", {"object_id": ref.id, "owner_addr": ref.owner_addr},
            timeout=global_config().gcs_rpc_timeout_s,
        )
        if ok:
            found, value = self._try_local_plasma(ref.id, ref)
            if found:
                return value
        return _PENDING

    def wait(self, refs: List[ObjectRef], num_returns=1, timeout=None, fetch_local=True):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        while True:
            still = []
            for r in pending:
                # never exceed num_returns (reference semantics: extras stay
                # pending even if already computed)
                if len(ready) < num_returns and self._is_ready(r):
                    ready.append(r)
                else:
                    still.append(r)
            pending = still
            if len(ready) >= num_returns or not pending:
                return ready, pending
            if deadline is not None and time.monotonic() >= deadline:
                return ready, pending
            time.sleep(0.005)

    def _is_ready(self, ref: ObjectRef) -> bool:
        with self._store_lock:
            if ref.id in self.memory_store or ref.id in self.object_errors:
                return True
            if ref.owner_addr == self.address and self.object_locations.get(ref.id):
                return True
        if ref.owner_addr != self.address and ref.owner_addr is not None:
            try:
                loc = self.pool.get(ref.owner_addr).call("GetObjectLocations", {"object_id": ref.id}, timeout=5)
                return loc is not None
            except Exception:  # noqa: BLE001
                return False
        try:
            return self.plasma.contains(ref.id)
        except Exception:  # noqa: BLE001
            return False

    def free_owned_object(self, oid: ObjectID):
        with self._store_lock:
            self.memory_store.pop(oid, None)
            self.object_errors.pop(oid, None)
            locations = self.object_locations.pop(oid, set())
        self.task_manager.release_lineage(oid)
        for node_addr in locations:
            try:
                self.pool.get(node_addr).notify("PlasmaFree", {"object_ids": [oid]})
            except Exception:  # noqa: BLE001 — node gone: its plasma store died with it
                pass

    # ------------------------------------------------------------------
    # Owner-side handlers (object directory + refcounting RPCs)
    # ------------------------------------------------------------------

    def HandleGetObjectLocations(self, req):
        oid = req["object_id"]
        with self._store_lock:
            if oid in self.object_errors:
                return {"error": self.object_errors[oid]}
            if oid in self.memory_store:
                return {"value_bytes": serialization.dumps_inline(self.memory_store[oid])}
            locs = self.object_locations.get(oid)
            if locs:
                return {"nodes": [list(a) for a in locs]}
        return None  # still pending

    def broadcast_object(self, ref: "ObjectRef") -> int:
        """Proactively replicate a plasma object to every ALIVE node via the
        raylet push plane's spanning fan-out (reference: push_manager.h:27;
        the 1-GiB broadcast envelope). Returns the number of pushes.
        Inline (in-band) objects need no broadcast and return 0."""
        deadline = time.monotonic() + global_config().gcs_rpc_timeout_s
        while True:
            if ref.owner_addr == self.address:
                loc = self.HandleGetObjectLocations({"object_id": ref.id})
            else:
                loc = self.pool.get(tuple(ref.owner_addr)).call(
                    "GetObjectLocations", {"object_id": ref.id})
            if loc is not None:
                break  # produced (inline or plasma)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"broadcast_object: {ref.id} still pending after "
                    "gcs_rpc_timeout_s — is its producing task running?")
            time.sleep(0.05)
        if not isinstance(loc, dict) or not loc.get("nodes"):
            return 0
        have = {tuple(a) for a in loc["nodes"]}
        source = tuple(loc["nodes"][0])
        nodes = self.gcs.call("GetAllNodeInfo", {})
        targets = [tuple(n["address"]) for n in nodes
                   if n["state"] == "ALIVE" and tuple(n["address"]) not in have]
        if not targets:
            return 0
        rep = self.pool.get(source).call(
            "BroadcastObject",
            {"object_id": ref.id, "owner_addr": tuple(ref.owner_addr),
             "targets": targets}, timeout=None)
        return rep.get("pushed", 0) if isinstance(rep, dict) else 0

    def HandleAddObjectLocation(self, req):
        with self._store_lock:
            self.object_locations[req["object_id"]].add(tuple(req["node_addr"]))
        return True

    def HandleAddBorrower(self, req):
        self.reference_counter.handle_add_borrower(req["object_id"], req["borrower"])
        return True

    def HandleAddBorrowerTransit(self, req):
        self.reference_counter.handle_add_borrower_transit(req["object_id"])
        return True

    def HandleRemoveBorrower(self, req):
        self.reference_counter.handle_remove_borrower(req["object_id"], req["borrower"])
        return True

    def HandleDumpStacks(self, req):
        """Formatted stacks of every thread (reference: the reporter's
        py-spy dump — same content, no ptrace needed from inside)."""
        import traceback as tb

        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in frames.items():
            out.append({
                "thread": names.get(ident, str(ident)),
                "stack": "".join(tb.format_stack(frame)),
            })
        return {"pid": os.getpid(), "threads": out}

    def HandleFlightRecorderTail(self, req):
        """The last N seconds of this process's flight recorder (step
        phases, collective entry/exit marks, task transitions) — the
        live-read half of the post-mortem pair (crash dumps cover dead
        workers).  Served from the RPC thread, so a worker whose EXEC
        thread is wedged still answers."""
        return {"pid": os.getpid(),
                "entries": flight_recorder.tail(
                    seconds=req.get("seconds"), limit=req.get("limit"))}

    def HandleCpuProfile(self, req, reply_token):
        """Sampling CPU profile: sample every thread's top frames for
        ``duration_s``, return (stack -> hit count) aggregated (reference:
        reporter's py-spy record endpoint)."""
        duration = min(float(req.get("duration_s", 5.0)), 60.0)
        interval = max(float(req.get("interval_s", 0.01)), 0.001)
        server = self.server

        def run():
            try:
                self._cpu_profile_body(duration, interval, reply_token)
            except Exception as e:  # noqa: BLE001 — the caller must hear back
                try:
                    server.send_error_reply(reply_token, e)
                except Exception:  # noqa: BLE001 — error reply to a caller that already went away
                    pass

        threading.Thread(target=run, daemon=True, name="cpu-profiler").start()
        return RpcServer.DELAYED_REPLY

    def _cpu_profile_body(self, duration, interval, reply_token):
        counts: Dict[str, int] = {}
        end = time.monotonic() + duration
        me = threading.get_ident()
        n = 0
        while time.monotonic() < end:
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                # aggregate by function chain, not line numbers — a hot
                # loop must collapse into ONE bucket, not one per line
                chain = []
                f = frame
                while f is not None and len(chain) < 20:
                    code = f.f_code
                    qual = getattr(code, "co_qualname", code.co_name)
                    chain.append(f"{code.co_filename}:{qual}")
                    f = f.f_back
                key = "\n".join(reversed(chain))
                counts[key] = counts.get(key, 0) + 1
            n += 1
            time.sleep(interval)
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:30]
        self.server.send_reply(reply_token, {
            "pid": os.getpid(), "samples": n,
            "stacks": [{"count": c, "stack": s} for s, c in top],
        })

    def HandleTorchProfile(self, req, reply_token):
        """Capture a torch.profiler trace for ``duration_s`` (CPU, and CUDA
        where this process has initialised a card) and write it as a Chrome
        trace: the counterpart of the JAX package's XPlane capture.
        Returns the trace directory + files; open with Perfetto or
        chrome://tracing."""
        duration = min(float(req.get("duration_s", 3.0)), 60.0)
        logdir = req.get("logdir") or os.path.join(
            tempfile.gettempdir(), f"ray-tpu-torchprof-{os.getpid()}-{int(time.time())}")
        server = self.server

        def run():
            try:
                import torch

                activities = [torch.profiler.ProfilerActivity.CPU]
                # never the first CUDA call of a process that has none
                if torch.cuda.is_initialized():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                os.makedirs(logdir, exist_ok=True)
                # every thread's work, not this one's: a serve replica
                # launches its kernels from its engine loop's thread
                config = torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True)
                with torch.profiler.profile(activities=activities,
                                            experimental_config=config) as prof:
                    time.sleep(duration)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
                files = []
                for dp, _, fs in os.walk(logdir):
                    files.extend(os.path.join(dp, f) for f in fs)
                server.send_reply(reply_token, {
                    "pid": os.getpid(), "logdir": logdir,
                    "files": sorted(files),
                })
            except Exception as e:  # noqa: BLE001 — the caller must hear back
                try:
                    server.send_error_reply(reply_token, e)
                except Exception:  # noqa: BLE001 — error reply to a caller that already went away
                    pass

        threading.Thread(target=run, daemon=True, name="rpc-torch-profiler").start()
        return RpcServer.DELAYED_REPLY

    def register_alert_handler(self, cb) -> None:
        """Subscribe this worker to the tree-pubsub ALERT channel and
        deliver every watch transition dict to ``cb`` (the serve
        controller's pool autoscaler rides this; handlers must not
        block — they run on the pubsub dispatch path)."""
        self._alert_handlers.append(cb)
        self._gcs_subscribe("ALERT")

    def HandlePubsubMessage(self, req):
        channel, message = req["channel"], req["message"]
        if channel == "ALERT":
            for cb in list(self._alert_handlers):
                try:
                    cb(message)
                except Exception:  # noqa: BLE001 — one bad handler must not
                    logger.exception("alert handler failed")  # drop the rest
            return True
        if channel == "WORKER_LOGS":
            if self.log_to_driver and not self.shutting_down:
                # echo only this job's workers (unattributed lines — a worker
                # not yet leased — are shown by every driver)
                job = message.get("job")
                mine = getattr(self.job_id, "hex", lambda: None)()
                if job is None or mine is None or job == mine:
                    pid, ip = message.get("pid"), message.get("ip")
                    for line in message.get("lines", ()):
                        print(f"(pid={pid}, ip={ip}) {line}", flush=True)
            return True
        if channel.startswith("ACTOR:"):
            actor_id = message.get("actor_id")
            with self._actor_lock:
                if message["event"] == "alive":
                    self._actor_addr_cache[actor_id] = tuple(message["address"])
                    self._actor_state_cache[actor_id] = "ALIVE"
                elif message["event"] == "restarting":
                    self._actor_addr_cache.pop(actor_id, None)
                    self._actor_state_cache[actor_id] = "RESTARTING"
                elif message["event"] == "dead":
                    self._actor_addr_cache.pop(actor_id, None)
                    self._actor_state_cache[actor_id] = "DEAD"
                    # the channel is final: stop re-subscribing to it
                    with self._sub_lock:
                        self._subscriptions.discard(channel)
                self._actor_cv.notify_all()
        return True

    # ------------------------------------------------------------------
    # Task submission (reference: normal_task_submitter.cc:29 SubmitTask)
    # ------------------------------------------------------------------

    def submit_task(
        self,
        fn,
        args,
        kwargs,
        *,
        name=None,
        num_returns=1,
        resources=None,
        strategy=None,
        max_retries=None,
        retry_exceptions=False,
        runtime_env=None,
    ):
        from ray_tpu_torch._private.resources import ResourceSet
        from ray_tpu_torch._private.scheduler import SchedulingStrategy

        task_id = TaskID.random()
        digest, blob = self._publish_function(fn)
        runtime_env = self._package_runtime_env(runtime_env)
        trace_id, parent_span_id, span_id = tracing.capture_for_submit()
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            name=name or getattr(fn, "__name__", "task"),
            function_digest=digest,
            function_blob=blob,
            args=[self._pack_arg(a) for a in args],
            kwargs=[(k, *self._pack_arg(v)) for k, v in (kwargs or {}).items()],
            num_returns=num_returns,
            resources=ResourceSet(resources or {"CPU": 1}),
            strategy=strategy or SchedulingStrategy(),
            max_retries=max_retries if max_retries is not None else global_config().task_max_retries_default,
            retry_exceptions=retry_exceptions,
            owner_addr=self.address,
            owner_worker_id=self.worker_id,
            runtime_env=runtime_env,
            submit_ts=time.monotonic(),
            trace_id=trace_id,
            span_id=span_id,
            parent_span_id=parent_span_id,
        )
        self.task_manager.add_pending(spec)
        self._pin_args(spec)
        self._record_task_event(spec, "SUBMITTED")
        self._submitter.submit(spec)
        if num_returns == "streaming":
            return ObjectRefGenerator(self, spec)
        refs = [ObjectRef(oid, self.address) for oid in spec.return_ids()]
        return refs[0] if num_returns == 1 else refs

    def _package_runtime_env(self, runtime_env):
        if not runtime_env:
            return None
        from ray_tpu_torch._private import runtime_env as renv

        normalized = renv.normalize(runtime_env)
        if normalized is None:
            return None
        # Memoize on the canonical env hash PLUS a stat fingerprint of every
        # local path, so unchanged trees skip the re-zip while edits
        # invalidate the cache (reference: uri_cache.py).
        fingerprints = []
        for path in list(normalized.get("py_modules") or []) + (
                [normalized["working_dir"]] if normalized.get("working_dir") else []):
            if not str(path).startswith("kv://"):
                fingerprints.append(renv.path_fingerprint(str(path)))
        hook = normalized.get("worker_process_setup_hook")
        if callable(hook):
            # identify the callable by its pickled content, not its repr
            # (json default=str embeds the object address — two different
            # hooks could collide after GC address reuse); drop the live
            # object from the hashed dict for the same reason.  The digest
            # is memoized per live object (weak, so GC'd hooks free their
            # entry and address reuse can't alias) — re-pickling the hook
            # on every submit would put tens of µs on the hot submit path.
            digest = _setup_hook_digests.get(hook) if _weakrefable(hook) else None
            if digest is None:
                digest = hashlib.sha1(
                    serialization.dumps_inline(hook)).hexdigest()[:16]
                if _weakrefable(hook):
                    _setup_hook_digests[hook] = digest
            fingerprints.append(digest)
            hashed = {k: v for k, v in normalized.items()
                      if k != "worker_process_setup_hook"}
        else:
            hashed = normalized
        cache_key = (renv.env_hash(hashed), tuple(fingerprints))
        cached = self._runtime_env_cache.get(cache_key)
        if cached is None:
            cached = self._runtime_env_cache[cache_key] = renv.package(self, normalized)
        return cached

    _fn_digest_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _publish_function(self, fn) -> Tuple[str, Optional[bytes]]:
        # memoize the (pickle, sha1) per live callable: re-serializing the
        # same function on every submit cost ~200µs/task on the hot path.
        # Weak keying means a GC'd function frees its entry, so id reuse
        # can never alias two digests.
        if _weakrefable(fn):
            digest = self._fn_digest_cache.get(fn)
            if digest is not None and digest in self._published_fns:
                return digest, None
        blob = serialization.dumps_inline(fn)
        digest = hashlib.sha1(blob).hexdigest()
        if _weakrefable(fn):
            self._fn_digest_cache[fn] = digest
        if digest in self._published_fns:
            return digest, None
        # Publish to GCS KV so workers can fetch once and cache
        # (reference: _private/function_manager.py export pattern).
        try:
            self.gcs.call("KVPut", {"key": f"fn:{digest}", "value": blob, "overwrite": False})
            self._published_fns.add(digest)
            return digest, None
        except Exception:  # noqa: BLE001
            return digest, blob

    def _pack_arg(self, value, oob: bool = True):
        if isinstance(value, ObjectRef):
            return ("ref", (value.id, value.owner_addr))
        data = serialization.dumps_inline(value)
        runtime_metrics.add_serialized_bytes("args", len(data))
        if len(data) > global_config().max_inline_object_size:
            ref = self.put(value)
            self.reference_counter.add_local_ref(ref)  # hold until task done
            return ("ref", (ref.id, ref.owner_addr))
        if oob:
            # large-ish inline blobs ride the rpc layer's out-of-band frame
            # path (zero-copy to the socket).  oob=False for specs that are
            # re-pickled in transit (actor creation goes driver→GCS→worker;
            # a received memoryview cannot be pickled again).
            from ray_tpu_torch._private.rpc import oob_wrap

            return ("value", oob_wrap(data))
        return ("value", data)

    def _pin_args(self, spec: TaskSpec):
        for kind, payload in list(spec.args) + [(k2, p) for _, k2, p in spec.kwargs]:
            if kind == "ref":
                oid, owner = payload
                if owner == self.address:
                    self.reference_counter.add_submitted_ref(oid)

    def _unpin_args(self, spec: TaskSpec):
        for kind, payload in list(spec.args) + [(k2, p) for _, k2, p in spec.kwargs]:
            if kind == "ref":
                oid, owner = payload
                if owner == self.address:
                    self.reference_counter.remove_submitted_ref(oid)

    def _resolve_pg_raylet(self, spec: TaskSpec):
        info = self.gcs.call("GetPlacementGroup", {"pg_id": spec.strategy.placement_group_id})
        if info is None or info["state"] != "CREATED":
            # Wait for the PG to become ready.
            deadline = time.monotonic() + global_config().gcs_rpc_timeout_s
            while time.monotonic() < deadline:
                info = self.gcs.call("GetPlacementGroup", {"pg_id": spec.strategy.placement_group_id})
                if info is not None and info["state"] == "CREATED":
                    break
                time.sleep(0.02)
            else:
                raise RemoteError("placement group not ready")
        idx = spec.strategy.bundle_index if spec.strategy.bundle_index >= 0 else 0
        node_id = info["bundle_nodes"][idx]
        nodes = self.gcs.call("GetAllNodeInfo", None)
        for n in nodes:
            if n["node_id"] == node_id:
                return self.pool.get(tuple(n["address"]))
        raise RemoteError(f"placement group node {node_id} not found")

    def cancel_task(self, ref: "ObjectRef", force: bool = False) -> bool:
        """Cancel the task that produces ``ref`` (reference: ray.cancel).

        Queued tasks are removed from the raylet's queues; a RUNNING task
        gets KeyboardInterrupt injected at its next bytecode boundary
        (force=True kills the worker process instead).  Actor tasks are
        cancelled owner-side only (the result errors; in-flight execution
        may still finish server-side).  Returns False if already finished.
        """
        spec = self.task_manager.spec_for_object(ref.id)
        if spec is None or not self.task_manager.is_pending(spec.task_id):
            return False
        self._cancelled_tasks.add(spec.task_id)
        # re-check: if completion raced past the mark, withdraw it — a stale
        # mark would later poison lineage re-execution of this task_id
        if not self.task_manager.is_pending(spec.task_id):
            self._cancelled_tasks.discard(spec.task_id)
            return False
        # still queued owner-side (never pushed to a worker)? drop it here
        if spec.actor_id is None and self._submitter.try_cancel_queued(
                spec.task_id):
            return True
        # in flight on a worker? interrupt it there
        addr = self._task_exec_addr.get(spec.task_id)
        if addr is not None:
            try:
                self.pool.get(tuple(addr)).notify(
                    "CancelTask", {"task_id": spec.task_id, "force": force})
            except Exception:  # noqa: BLE001 — executor gone: the in-flight task died with it
                pass
        # maybe still queued at a raylet (the one that took the lease
        # request: PG routing / spillback may have left the local node)
        try:
            target = self._task_lease_raylet.get(spec.task_id, self.raylet)
            target.notify("CancelLease", {"task_id": spec.task_id})
        except Exception:  # noqa: BLE001 — raylet gone: the queued lease died with it
            pass
        return True

    def HandleCancelTask(self, req):
        """Executor side: interrupt the running task (reference: the
        cancellation path raising KeyboardInterrupt in the worker).  A task
        still QUEUED behind another on a (reused) lease is cancelled
        promptly: its reply goes out NOW and the executor skips it when it
        reaches the front of the FIFO."""
        task_id, force = req["task_id"], req.get("force", False)
        with self._exec_state_lock:
            if self.current_task_id == task_id:
                if force:
                    logger.warning("force-cancel: exiting worker for task %s",
                                   task_id)
                    os._exit(1)
                if self._exec_thread_id is not None:
                    import ctypes

                    ctypes.pythonapi.PyThreadState_SetAsyncExc(
                        ctypes.c_ulong(self._exec_thread_id),
                        ctypes.py_object(KeyboardInterrupt))
                return True
        with self._queue_lock:
            queued = self._queued_tokens.pop(task_id, None)
        if queued is None:
            return False  # finished (or not here): never hit a bystander
        reply_token, attempt, lease_id = queued
        self.server.send_reply(reply_token, {
            "status": "error",
            "error": TaskCancelledError("task was cancelled while queued"),
            "traceback": ""})
        with self._received_pushes_lock:
            self._received_pushes.discard((task_id.hex(), attempt))
        self._finish_lease_task(lease_id)
        return True

    def _handle_task_reply(self, spec: TaskSpec, reply: dict, worker_addr):
        if spec.task_id in self._cancelled_tasks:
            self._cancelled_tasks.discard(spec.task_id)
            self._fail_task(spec, TaskCancelledError(
                f"task {spec.name} was cancelled"))
            return
        if reply.get("status") == "error":
            err = TaskError(reply["error"], reply.get("traceback", ""), spec.name)
            if spec.retry_exceptions and spec.attempt < spec.max_retries:
                spec.attempt += 1
                self._submitter.submit(spec)
                return
            self._fail_task(spec, err)
            return
        abandoned_stream = False
        if spec.num_returns == "streaming":
            with self._store_lock:
                # all items were delivered (reliably, in order) before this
                # reply, so a closed stream is now fully finished
                abandoned_stream = spec.task_id in self._closed_streams
                self._closed_streams.discard(spec.task_id)
        for oid, kind, payload in reply["returns"]:
            if abandoned_stream:
                continue  # nobody will ever read the anchor
            if kind == "inline":
                with self._store_lock:
                    self.memory_store[oid] = serialization.loads_inline(payload)
                    self._store_cv.notify_all()
            else:  # plasma: payload = node_addr
                with self._store_lock:
                    self.object_locations[oid].add(tuple(payload))
                    self._store_cv.notify_all()
        with self.task_manager.lock:
            for oid in spec.return_ids():
                self.task_manager.reconstructing.discard(oid)
        self.task_manager.complete(spec.task_id)
        self._cancelled_tasks.discard(spec.task_id)
        self._task_lease_raylet.pop(spec.task_id, None)
        self._unpin_args(spec)
        self._record_task_event(spec, "FINISHED")

    def _fail_task(self, spec: TaskSpec, error: Exception):
        # Anything not already a raisable framework error gets wrapped in
        # TaskError so ray_tpu_torch.get RAISES it instead of returning it as the
        # object's value (get only raises TaskError + the died/lost family).
        if not isinstance(error, (TaskError, ActorDiedError, ObjectLostError,
                                  WorkerCrashedError, TaskCancelledError,
                                  ActorUnavailableError)):
            error = TaskError(error, "", spec.name)
        with self._store_lock:
            if (spec.num_returns == "streaming"
                    and spec.task_id in self._closed_streams):
                self._closed_streams.discard(spec.task_id)
            else:
                for oid in spec.return_ids():
                    self.object_errors[oid] = error
                    self._store_cv.notify_all()
        self.task_manager.complete(spec.task_id)
        self._cancelled_tasks.discard(spec.task_id)
        self._task_lease_raylet.pop(spec.task_id, None)
        self._task_exec_addr.pop(spec.task_id, None)
        self._unpin_args(spec)
        self._record_task_event(spec, "FAILED")

    def _record_task_event(self, spec: TaskSpec, state: str, extra: Optional[dict] = None):
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
        }
        if spec.trace_id is not None:
            ev["trace_id"] = spec.trace_id
            ev["span_id"] = spec.span_id
            ev["parent_span_id"] = spec.parent_span_id
        if state == "SUBMITTED":
            # owner-side pid/node: timeline() places the submit slice (and
            # the outgoing flow-event arrow) on the submitting process
            ev["pid"] = fast_getpid()
            ev["node_id"] = self.node_id.hex() if self.node_id else None
        if extra:
            ev.update(extra)
        self.append_task_events([ev])

    def _record_exec_event(self, spec: TaskSpec):
        """Executor-side RUNNING event with pid/node for timeline + state API."""
        self._record_task_event(spec, "RUNNING", extra={
            "pid": fast_getpid(),
            "node_id": self.node_id.hex() if self.node_id else None,
        })

    def append_task_events(self, events: List[dict], flush: bool = False):
        """Buffer task/span events; one batched flush per >=100 events
        (or on demand).  The single entry point for every writer — task
        lifecycle here, spans via tracing.emit_span."""
        with self._task_events_lock:
            self._task_events.extend(events)
            flush = flush or len(self._task_events) >= 100
        if flush:
            self.flush_task_events()

    def flush_task_events(self):
        with self._task_events_lock:
            events, self._task_events = self._task_events, []
            self._last_event_flush = time.monotonic()
        if events:
            try:
                self.gcs.notify("AddTaskEvents", {"events": events})
            except Exception:  # noqa: BLE001 — task events are lossy by contract (bounded sink)
                pass

    def maybe_flush_task_events(self, min_interval_s: float = 0.5):
        """Paced flush for per-task hot paths: one GCS notify per interval
        instead of one per executed task (the pre-fast-path behavior cost a
        control-plane RPC per task).  append_task_events still force-flushes
        at 100 buffered events; a skipped flush arms a one-shot timer so a
        burst's trailing events still land within the interval."""
        with self._task_events_lock:
            if not self._task_events:
                return
            remaining = min_interval_s - (time.monotonic()
                                          - self._last_event_flush)
            if remaining > 0:
                if not self._event_flush_timer_armed:
                    self._event_flush_timer_armed = True
                    t = threading.Timer(remaining, self._deferred_event_flush)
                    t.daemon = True
                    t.start()
                return
        self.flush_task_events()

    def _deferred_event_flush(self):
        with self._task_events_lock:
            self._event_flush_timer_armed = False
        if not self.shutting_down:
            self.flush_task_events()

    # ------------------------------------------------------------------
    # Task execution (worker side; reference: core_worker.cc:2804
    # ExecuteTask + _raylet.pyx task_execution_callback)
    # ------------------------------------------------------------------

    def HandlePushTask(self, req, reply_token=None):
        spec: TaskSpec = req["spec"]
        lease: dict = req["lease"]
        key = (spec.task_id.hex(), spec.attempt)
        with self._received_pushes_lock:
            if key in self._received_pushes:
                # duplicate of a live attempt (the owner's lost-push probe
                # resent it while the original frame was still in the server
                # backlog): the first frame's reply settles the owner
                return RpcServer.DELAYED_REPLY
            self._received_pushes.add(key)
        lease_id = lease.get("lease_id")
        with self._queue_lock:
            if lease_id in self._stale_leases:
                # the raylet revoked this lease (TTL reclaim / drain): the
                # owner must resubmit through a fresh lease
                with self._received_pushes_lock:
                    self._received_pushes.discard(key)
                return {"status": "lease_invalid"}
            self._queued_tokens[spec.task_id] = (reply_token, spec.attempt,
                                                 lease_id)
            if lease_id:
                self._lease_task_counts[lease_id] = (
                    self._lease_task_counts.get(lease_id, 0) + 1)
        req["_recv_ts"] = time.monotonic()
        self._exec_pool.submit(self._execute_task, req, reply_token)
        return RpcServer.DELAYED_REPLY

    def _finish_lease_task(self, lease_id: Optional[str]):
        with self._queue_lock:
            if not lease_id:
                return
            n = self._lease_task_counts.get(lease_id, 0) - 1
            if n > 0:
                self._lease_task_counts[lease_id] = n
            else:
                self._lease_task_counts.pop(lease_id, None)

    def HandleHasTask(self, req):
        """Owner-side lost-push probe: has this (task, attempt) been
        received here?  (push heal — see NormalTaskSubmitter
        ._probe_stale_pushes)."""
        with self._received_pushes_lock:
            return (req["task_id"], req.get("attempt", 0)) in self._received_pushes

    def HandleLeaseState(self, req):
        """Raylet TTL-reclaim probe: how many tasks of this lease are still
        queued or running here?  Non-zero answers extend the lease."""
        with self._queue_lock:
            return {"queued": self._lease_task_counts.get(req["lease_id"], 0)}

    def HandleStealTask(self, req):
        """Owner-side work stealing (reference: the normal-task submitter's
        work-stealing mode): give a task still QUEUED behind another back
        to the owner, who re-pushes it on an idle lease.  A task already
        running (or finished) is not stealable."""
        task_id = req["task_id"]
        with self._queue_lock:
            queued = self._queued_tokens.pop(task_id, None)
        if queued is None:
            return False
        reply_token, attempt, lease_id = queued
        self.server.send_reply(reply_token, {"status": "stolen"})
        with self._received_pushes_lock:
            self._received_pushes.discard((task_id.hex(), attempt))
        self._finish_lease_task(lease_id)
        return True

    def HandleLeaseRevoked(self, req):
        """The raylet reclaimed a lease this worker served: refuse any
        straggler push carrying it (the owner resubmits through a fresh
        lease).  The mark set is bounded — old marks only matter for the
        race window between reclaim and the owner noticing."""
        lease_id = req.get("lease_id")
        if lease_id:
            with self._queue_lock:
                self._stale_leases.add(lease_id)
                self._stale_lease_order.append(lease_id)
                while len(self._stale_lease_order) > 256:
                    self._stale_leases.discard(
                        self._stale_lease_order.popleft())
        return True

    def _execute_task(self, req, reply_token):
        spec: TaskSpec = req["spec"]
        lease: dict = req["lease"]
        lease_id = lease.get("lease_id")
        with self._queue_lock:
            if self._queued_tokens.pop(spec.task_id, None) is None:
                # cancelled while queued: the cancel path already replied
                # and cleaned up — never execute it
                return
            stale = lease_id in self._stale_leases
        if stale:
            # lease revoked while this push sat in the FIFO: the owner
            # resubmits through a fresh lease; the task must not run on
            # resources the raylet already released
            self.server.send_reply(reply_token, {"status": "lease_invalid"})
            with self._received_pushes_lock:
                self._received_pushes.discard((spec.task_id.hex(), spec.attempt))
            self._finish_lease_task(lease_id)
            return
        recv_ts = req.get("_recv_ts")
        queued_s = (time.monotonic() - recv_ts) if recv_ts else 0.0
        replied = False
        flight_recorder.record("task", spec.name,
                               f"start:{spec.task_id.hex()[:8]}a{spec.attempt}")
        try:
            self._record_exec_event(spec)
            bind_visible_accelerators(lease.get("resource_instances"))
            fn = self._load_function(spec)
            # exec state is live BEFORE arg unpacking: fetching a ref arg
            # blocks in get(), and the blocked-CPU release (deadlock
            # avoidance) needs the lease id; cancellation covering the fetch
            # matches the reference (tasks are cancellable while pulling deps)
            with self._exec_state_lock:
                self.current_task_id = spec.task_id
                self._exec_thread_id = threading.get_ident()
                self._exec_lease_id = lease.get("lease_id")
            try:
                # the submitter's trace context wraps arg fetch + user code +
                # return packing: nested submissions and spans chain under
                # THIS task's span (reference: tracing_helper restoring the
                # serialized context in the executor)
                with tracing.activate_from_spec(spec):
                    args = [self._unpack_arg(a) for a in spec.args]
                    kwargs = {k: self._unpack_arg((kind, p)) for k, kind, p in spec.kwargs}
                    exec_t0 = time.perf_counter()
                    result = fn(*args, **kwargs)
                    runtime_metrics.observe_task_execution(
                        time.perf_counter() - exec_t0, kind="task")
                    # return packing stays cancellable: a STREAMING task's
                    # user code runs inside _stream_returns' iteration, not
                    # fn()
                    returns = self._pack_returns(spec, result)
            finally:
                with self._exec_state_lock:
                    self.current_task_id = None
                    self._exec_thread_id = None
                    self._exec_lease_id = None
                    # deterministic cancel barrier: HandleCancelTask only
                    # injects under this lock while current_task_id matches,
                    # so after this block no NEW KI can arrive; an already-
                    # injected-but-undelivered KI is expunged here (NULL
                    # clears the pending async exc), so it can never land
                    # mid-send_reply and produce a second reply on the token.
                    # A KI delivered before the clear propagates out of this
                    # finally and takes the single cancelled-reply path.
                    import ctypes

                    ctypes.pythonapi.PyThreadState_SetAsyncExc(
                        ctypes.c_ulong(threading.get_ident()), None)
            self.server.send_reply(
                reply_token,
                {"status": "ok", "returns": returns, "queued_s": queued_s})
            replied = True
        except KeyboardInterrupt:
            # injected by HandleCancelTask. PyThreadState_SetAsyncExc delivery
            # is unbounded: the interrupt may land AFTER the ok reply was sent
            # — swallow it then (a second reply on the same token would
            # corrupt the caller's view of the task)
            if replied:
                return
            self.server.send_reply(
                reply_token,
                {"status": "error",
                 "error": TaskCancelledError(f"task {spec.name} was cancelled"),
                 "traceback": ""})
        except Exception as e:  # noqa: BLE001
            from ray_tpu_torch.util import rpdb

            if rpdb.post_mortem_enabled():
                # RAY_TPU_POST_MORTEM=1: hold the crash frame open for a
                # remote debugger before failing the task (reference:
                # RAY_DEBUG_POST_MORTEM)
                try:
                    rpdb.post_mortem(label=f"post-mortem:{spec.name}")
                except Exception:  # noqa: BLE001 — debugger hold is best-effort; the task still fails below
                    pass
            self.server.send_reply(
                reply_token,
                {"status": "error", "error": _picklable_error(e),
                 "traceback": traceback.format_exc()},
            )
        finally:
            flight_recorder.record(
                "task", spec.name,
                f"end:{spec.task_id.hex()[:8]}a{spec.attempt}")
            with self._received_pushes_lock:
                self._received_pushes.discard(
                    (spec.task_id.hex(), spec.attempt))
            self._finish_lease_task(lease_id)
            if not lease.get("reusable"):
                # legacy single-task lease: the worker returns itself; a
                # REUSABLE lease stays with the owner's cache (returned by
                # the owner on idleness, or TTL-reclaimed by the raylet)
                try:
                    self.raylet.notify("ReturnWorker", {"lease_id": lease_id})
                except BaseException:  # noqa: BLE001 (incl. late cancel KI)
                    pass
            self.maybe_flush_task_events()
            runtime_metrics.maybe_push()

    def _load_function(self, spec: TaskSpec):
        if spec.function_digest in self._fn_cache:
            return self._fn_cache[spec.function_digest]
        blob = spec.function_blob
        if blob is None:
            blob = self.gcs.call("KVGet", {"key": f"fn:{spec.function_digest}"})
            if blob is None:
                raise RuntimeError(f"function {spec.function_digest} not found in GCS KV")
        fn = serialization.loads_inline(blob)
        self._fn_cache[spec.function_digest] = fn
        return fn

    def _unpack_arg(self, packed):
        kind, payload = packed
        if kind == "value":
            return serialization.loads_inline(payload)
        oid, owner = payload
        ref = ObjectRef(oid, owner)
        if owner != self.address:
            self.reference_counter.on_ref_deserialized(ref)
        return self.get(ref)

    def _pack_returns(self, spec: TaskSpec, result):
        if spec.num_returns == "streaming":
            return self._stream_returns(spec, result)
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                raise ValueError(f"task {spec.name} declared {spec.num_returns} returns, produced {len(values)}")
        return [self._pack_one_return(oid, value, spec)
                for oid, value in zip(spec.return_ids(), values)]

    def _pack_one_return(self, oid: ObjectID, value, spec: TaskSpec):
        data = serialization.dumps_inline(value)
        runtime_metrics.add_serialized_bytes("returns", len(data))
        if len(data) <= global_config().max_inline_object_size:
            from ray_tpu_torch._private.rpc import oob_wrap

            # the reply crosses ONE hop (executor → owner) and the owner
            # deserializes immediately: safe for the out-of-band frame path
            return (oid, "inline", oob_wrap(data))
        from ray_tpu_torch._private.object_store import plasma_create_write_seal

        meta, raws = serialization.dumps_with_buffers(value)
        plasma_create_write_seal(self.raylet, oid, meta, raws, spec.owner_addr)
        return (oid, "plasma", self.raylet.address)

    def _stream_returns(self, spec: TaskSpec, result):
        """Drive a streaming-generator task: each yielded item becomes its
        own object, pushed to the owner AS PRODUCED; the reply carries only
        the completion anchor (item count) at index 0 (reference: streaming
        ObjectRefGenerator tasks)."""
        if not hasattr(result, "__next__") and not hasattr(result, "__iter__"):
            raise TypeError(
                f"task {spec.name} declared num_returns='streaming' but "
                f"returned non-iterable {type(result).__name__}")
        count = 0
        for item in result:
            count += 1
            entry = self._pack_one_return(
                ObjectID.from_task(spec.task_id, count), item, spec)
            # RELIABLE send: the anchor count rides the (retried) task reply,
            # so a silently-dropped item would strand the consumer at that
            # index forever — deliver each item with the same guarantees
            self.pool.get(tuple(spec.owner_addr)).call(
                "StreamingItem", {"item": entry, "task_id": spec.task_id},
                timeout=global_config().gcs_rpc_timeout_s)
        anchor = ObjectID.from_task(spec.task_id, 0)
        return [self._pack_one_return(anchor, count, spec)]

    def HandleStreamingItem(self, req):
        """Owner side: store one streamed item as it arrives (dropped when
        the consumer already abandoned the stream)."""
        oid, kind, payload = req["item"]
        with self._store_lock:
            closed = req.get("task_id") in self._closed_streams
            if not closed:
                if kind == "inline":
                    self.memory_store[oid] = serialization.loads_inline(payload)
                else:
                    self.object_locations[oid].add(tuple(payload))
                self._store_cv.notify_all()
        if closed and kind != "inline":
            # the consumer is gone; free the plasma copy immediately
            try:
                self.pool.get(tuple(payload)).notify(
                    "PlasmaFree", {"object_ids": [oid]})
            except Exception:  # noqa: BLE001 — consumer and copy both gone is fine
                pass
        return True

    # ------------------------------------------------------------------
    # Actors — client side (reference: core_worker.h:878,935)
    # ------------------------------------------------------------------

    def create_actor(self, cls, args, kwargs, *, name=None, num_returns=1, resources=None,
                     strategy=None, max_restarts=0, max_task_retries=0, max_concurrency=1,
                     concurrency_groups=None, lifetime=None, namespace="default",
                     runtime_env=None):
        from ray_tpu_torch._private.resources import ResourceSet
        from ray_tpu_torch._private.scheduler import SchedulingStrategy

        actor_id = ActorID.random()
        digest, blob = self._publish_function(cls)
        if blob is None and digest not in self._published_fns:
            blob = serialization.dumps_inline(cls)
        runtime_env = self._package_runtime_env(runtime_env)
        trace_id, parent_span_id, span_id = tracing.capture_for_submit()
        spec = TaskSpec(
            task_id=TaskID.random(),
            job_id=self.job_id,
            name=getattr(cls, "__name__", "Actor"),
            function_digest=digest,
            function_blob=blob,
            args=[self._pack_arg(a, oob=False) for a in args],
            kwargs=[(k, *self._pack_arg(v, oob=False))
                    for k, v in (kwargs or {}).items()],
            resources=ResourceSet(resources or {"CPU": 1}),
            strategy=strategy or SchedulingStrategy(),
            owner_addr=self.address,
            owner_worker_id=self.worker_id,
            actor_id=actor_id,
            actor_creation=True,
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            concurrency_groups=dict(concurrency_groups) if concurrency_groups else None,
            detached=(lifetime == "detached"),
            actor_name=name,
            runtime_env=runtime_env,
            trace_id=trace_id,
            span_id=span_id,
            parent_span_id=parent_span_id,
        )
        self._gcs_subscribe(f"ACTOR:{actor_id.hex()}")
        self.gcs.call("RegisterActor", {"spec": spec, "namespace": namespace})
        return actor_id, spec

    def _wait_actor_alive(self, actor_id: ActorID, timeout=None) -> Tuple[str, int]:
        timeout = timeout or global_config().actor_creation_timeout_s
        deadline = time.monotonic() + timeout
        with self._actor_lock:
            addr = self._actor_addr_cache.get(actor_id)
            if addr:
                return addr
        while time.monotonic() < deadline:
            info = self.gcs.call("GetActorInfo", {"actor_id": actor_id})
            if info is None:
                raise ActorDiedError(actor_id, "unknown actor")
            if info["state"] == "ALIVE" and info["address"]:
                addr = tuple(info["address"])
                with self._actor_lock:
                    self._actor_addr_cache[actor_id] = addr
                return addr
            if info["state"] == "DEAD":
                raise ActorDiedError(actor_id, info.get("death_cause", ""))
            with self._actor_lock:
                self._actor_cv.wait(timeout=0.05)
                addr = self._actor_addr_cache.get(actor_id)
                if addr:
                    return addr
        raise GetTimeoutError(f"actor {actor_id} not alive after {timeout}s")

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args, kwargs,
                          num_returns=1, max_task_retries=0, concurrency_group=None):
        trace_id, parent_span_id, span_id = tracing.capture_for_submit()
        spec = TaskSpec(
            task_id=TaskID.random(),
            job_id=self.job_id,
            name=method_name,
            function_digest="",
            function_blob=None,
            args=[self._pack_arg(a) for a in args],
            kwargs=[(k, *self._pack_arg(v)) for k, v in (kwargs or {}).items()],
            num_returns=num_returns,
            owner_addr=self.address,
            owner_worker_id=self.worker_id,
            actor_id=actor_id,
            actor_method=method_name,
            max_retries=max_task_retries,
            concurrency_group=concurrency_group,
            trace_id=trace_id,
            span_id=span_id,
            parent_span_id=parent_span_id,
        )
        self.task_manager.add_pending(spec)
        self._record_task_event(spec, "SUBMITTED")
        self._pin_args(spec)
        with self._actor_lock:
            pipeline = self._actor_pipelines.get(actor_id)
            if pipeline is None:
                pipeline = _ActorPipeline(self, actor_id)
                self._actor_pipelines[actor_id] = pipeline
        pipeline.submit(spec)
        if num_returns == "streaming":
            return ObjectRefGenerator(self, spec)
        refs = [ObjectRef(oid, self.address) for oid in spec.return_ids()]
        return refs[0] if num_returns == 1 else refs

    def kill_actor(self, actor_id: ActorID, no_restart=True):
        self.gcs.call("KillActor", {"actor_id": actor_id, "no_restart": no_restart})

    def get_named_actor(self, name: str, namespace="default"):
        info = self.gcs.call("GetNamedActor", {"name": name, "namespace": namespace})
        if info is None:
            raise ValueError(f"no actor named {name!r}")
        self._gcs_subscribe(f"ACTOR:{info['actor_id'].hex()}")
        return info

    # ------------------------------------------------------------------
    # Actors — server side (this worker hosts the actor)
    # ------------------------------------------------------------------

    def HandleCreateActor(self, req):
        spec: TaskSpec = req["spec"]
        lease: dict = req["lease"]
        # identity is live DURING __init__: constructor code (e.g. collective
        # group membership registration) must see which actor it runs in
        self.actor_id = spec.actor_id
        try:
            bind_visible_accelerators(lease.get("resource_instances"))
            cls = self._load_function(spec)
            with tracing.activate_from_spec(spec):
                args = [self._unpack_arg(a) for a in spec.args]
                kwargs = {k: self._unpack_arg((kind, p)) for k, kind, p in spec.kwargs}
                instance = cls(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            self.actor_id = None
            return {"ok": False, "error": f"{e}\n{traceback.format_exc()}"}
        self._actor_instance = instance
        self._actor_spec = spec
        self._actor_lease = lease
        self._actor_exec_pool = DaemonExecutor(
            max_workers=max(spec.max_concurrency, 1), thread_name_prefix="actor-exec"
        )
        # named concurrency groups: each gets its OWN pool so a saturated
        # group (e.g. blocked user methods) can never starve another (e.g.
        # health checks). reference: concurrency_group_manager.h — per-group
        # executors with dispatch by the task's group.
        self._actor_group_pools = {
            name: DaemonExecutor(max_workers=max(int(n), 1),
                                 thread_name_prefix=f"actor-cg-{name}")
            for name, n in (spec.concurrency_groups or {}).items()
        }
        return {"ok": True, "address": self.server.address}

    def _resolve_concurrency_group(self, spec) -> Optional[str]:
        """Per-call override wins, else the @ray_tpu_torch.method declaration on
        the actor class, else None (the default ordered path)."""
        if spec.concurrency_group is not None:
            return spec.concurrency_group
        if spec.actor_method and self._actor_instance is not None:
            fn = getattr(type(self._actor_instance), spec.actor_method, None)
            return getattr(fn, "_ray_tpu_concurrency_group", None)
        return None

    def HandlePushActorTask(self, req, reply_token=None):
        """Ordered per-caller arrival queue (reference: ActorSchedulingQueue /
        OutOfOrderActorSchedulingQueue).  The client pipeline sends tasks in
        (epoch, seq) order on one socket; we buffer any dispatch-reorder and
        submit to the execution pool strictly in order for max_concurrency==1.
        """
        if self._actor_instance is None:
            raise ActorUnavailableError("no actor instance on this worker")
        spec: TaskSpec = req["spec"]
        if self._actor_spec is not None and self._actor_spec.max_concurrency > 1:
            self._dispatch_actor_task(
                self._resolve_concurrency_group(spec), req, reply_token)
            return RpcServer.DELAYED_REPLY
        caller = spec.owner_worker_id.hex()
        epoch, seq = req.get("epoch", 1), spec.sequence_number
        with self._actor_seq_lock:
            st = self._actor_callers.setdefault(caller, {"epoch": 0, "next": 0, "pending": {}})
            if epoch < st["epoch"]:
                return {"status": "error", "error": ActorUnavailableError("stale epoch"), "traceback": ""}
            st["pending"][(epoch, seq)] = (req, reply_token)
            if seq == 1 and epoch > st["epoch"]:
                st["epoch"], st["next"] = epoch, 0
                st["pending"] = {k: v for k, v in st["pending"].items() if k[0] >= epoch}
            # every task (any group) flows through the per-caller seq window
            # so the arrival order is gapless; at RELEASE each task goes to
            # ITS pool — group tasks run concurrently in theirs and never
            # wait behind (or block) the default group's single slot
            while (st["epoch"], st["next"] + 1) in st["pending"]:
                st["next"] += 1
                r, tok = st["pending"].pop((st["epoch"], st["next"]))
                self._dispatch_actor_task(
                    self._resolve_concurrency_group(r["spec"]), r, tok)
        return RpcServer.DELAYED_REPLY

    def _dispatch_actor_task(self, group, req, reply_token):
        """Route a released actor task to its group's pool (default pool when
        group is None). An unknown group errors HERE — after the task's
        (epoch, seq) slot was consumed by the ordered queue — so the
        rejection can never wedge the caller's sequence window."""
        if group is not None:
            pool = self._actor_group_pools.get(group)
            if pool is None:
                self.server.send_reply(reply_token, {
                    "status": "error",
                    "error": ValueError(
                        f"unknown concurrency group {group!r} "
                        f"(declared: {sorted(self._actor_group_pools)})"),
                    "traceback": ""})
                return
            pool.submit(self._execute_actor_task, req, reply_token)
            return
        self._actor_exec_pool.submit(self._execute_actor_task, req, reply_token)

    def _execute_actor_task(self, req, reply_token):
        spec: TaskSpec = req["spec"]
        flight_recorder.record("actor_task", spec.name or spec.actor_method,
                               f"start:a{spec.attempt}")
        try:
            self._record_exec_event(spec)
            with tracing.activate_from_spec(spec):
                args = [self._unpack_arg(a) for a in spec.args]
                kwargs = {k: self._unpack_arg((kind, p)) for k, kind, p in spec.kwargs}
                exec_t0 = time.perf_counter()
                if spec.actor_method == "__ray_tpu_call__":
                    # Hidden protocol: run fn(instance, *args, **kwargs) on
                    # the actor (used by collectives/train to inject gang
                    # setup).
                    fn, args = args[0], args[1:]
                    result = fn(self._actor_instance, *args, **kwargs)
                else:
                    method = getattr(self._actor_instance, spec.actor_method)
                    result = method(*args, **kwargs)
                runtime_metrics.observe_task_execution(
                    time.perf_counter() - exec_t0, kind="actor")
                if hasattr(result, "__await__"):
                    import asyncio

                    result = asyncio.run(_await(result))
                returns = self._pack_returns(spec, result)
            self.server.send_reply(reply_token, {"status": "ok", "returns": returns})
        except Exception as e:  # noqa: BLE001
            self.server.send_reply(
                reply_token, {"status": "error", "error": e, "traceback": traceback.format_exc()}
            )
            from ray_tpu_torch.actor import ActorExitException

            if isinstance(e, ActorExitException):
                # intentional exit (exit_actor): the reply above is already
                # on the wire; now mark the actor dead-no-restart at the GCS
                # BEFORE the process dies so the raylet's crash report can't
                # trigger a restart.  Retry: the no-restart guarantee hinges
                # on this landing.
                deadline = time.monotonic() + 30
                while True:
                    try:
                        self.kill_actor(self.actor_id, no_restart=True)
                        break
                    except Exception:  # noqa: BLE001
                        if time.monotonic() > deadline:
                            logger.error("exit_actor: KillActor never "
                                         "reached the GCS; exiting anyway")
                            break
                        time.sleep(0.5)
                self.flush_task_events()  # os._exit skips the finally below
                os._exit(0)
        finally:
            flight_recorder.record("actor_task",
                                   spec.name or spec.actor_method, "end")
            self.maybe_flush_task_events()
            runtime_metrics.maybe_push()

    def HandleKillActor(self, req):
        logger.info("actor %s killed: %s", req.get("actor_id"), req.get("reason"))
        threading.Thread(target=self._exit_soon, daemon=True,
                         name="worker-kill-actor-exit").start()
        return True

    def HandleExit(self, req):
        threading.Thread(target=self._exit_soon, daemon=True,
                         name="worker-exit").start()
        return True

    def _exit_soon(self):
        time.sleep(0.05)
        os._exit(0)

    def HandlePing(self, req):
        return {"worker_id": self.worker_id.hex(), "actor_id": self.actor_id.hex() if self.actor_id else None}


async def _await(coro):
    return await coro


class _ActorPipeline:
    """Per-actor ordered task sender (reference: ActorTaskSubmitter).

    One daemon thread per (caller, actor): sends PushActorTask frames in
    (epoch, seq) order over one socket — pipelined, replies handled by future
    callbacks.  An epoch corresponds to one (actor incarnation, connection):
    it advances whenever the actor's address changes (restart) or a send/reply
    fails, at which point un-acked tasks are re-sequenced into the next epoch.
    A task whose reply was lost may have executed — it is charged one retry
    attempt; over-budget tasks fail with ActorUnavailableError.
    """

    def __init__(self, worker: CoreWorker, actor_id: ActorID):
        self.w = worker
        self.actor_id = actor_id
        self.lock = make_lock("_ActorPipeline.lock")
        self.cv = threading.Condition(self.lock)
        self.queue: List[TaskSpec] = []
        self.inflight: Dict[int, TaskSpec] = {}  # seq -> spec (current epoch)
        self.epoch = 1
        self.seq = 0
        self.current_addr: Optional[Tuple[str, int]] = None
        # addr -> failure ts for incarnations we observed failing: the GCS
        # keeps reporting a just-crashed actor ALIVE at its old address for
        # a moment — resending there would burn retries before the restart.
        # Entries EXPIRE (suspicion, not a verdict): a transient connection
        # blip to a healthy actor or a restart reusing the port must not
        # blacklist the address forever.
        self.bad_addrs: Dict[tuple, float] = {}
        self.BAD_ADDR_TTL_S = 5.0
        self.thread = threading.Thread(target=self._run, daemon=True, name=f"actor-pipeline-{actor_id.hex()[:8]}")
        self.thread.start()

    def submit(self, spec: TaskSpec):
        with self.lock:
            self.queue.append(spec)
            self.cv.notify_all()

    def _run(self):
        while not self.w.shutting_down:
            with self.lock:
                while not self.queue and not self.w.shutting_down:
                    self.cv.wait(timeout=1.0)
                if self.w.shutting_down:
                    return
            try:
                addr = self.w._wait_actor_alive(self.actor_id)
            except ActorDiedError as e:
                self._fail_all(e)
                continue
            except Exception as e:  # noqa: BLE001  (timeout waiting for alive)
                self._fail_all(ActorUnavailableError(str(e)))
                continue
            with self.lock:  # consistent with _on_failure's locked insert
                suspect_ts = self.bad_addrs.get(tuple(addr))
                suspect = (suspect_ts is not None
                           and time.monotonic() - suspect_ts < self.BAD_ADDR_TTL_S)
                if suspect_ts is not None and not suspect:
                    del self.bad_addrs[tuple(addr)]  # suspicion expired; retry
            if suspect:
                # probably a stale GCS view of a dead incarnation; wait for
                # the restart to publish a fresh address
                with self.w._actor_lock:
                    self.w._actor_addr_cache.pop(self.actor_id, None)
                time.sleep(0.1)
                continue
            with self.lock:
                if addr != self.current_addr:
                    # Actor restarted onto a new worker: new epoch; anything
                    # still un-acked on the old incarnation is re-queued.
                    self._rollover_locked(charge_inflight=True)
                    self.current_addr = addr
                if not self.queue:
                    continue
                spec = self.queue.pop(0)
                self.seq += 1
                seq, epoch = self.seq, self.epoch
                spec.sequence_number = seq
                self.inflight[seq] = spec
            try:
                fut = self.w.pool.get(addr).call_async("PushActorTask", {"spec": spec, "epoch": epoch})
            except ConnectionLost:
                self._on_failure(epoch, addr, uncharged_seq=seq)
                continue
            fut.add_done_callback(lambda f, s=seq, sp=spec, e=epoch, a=addr: self._on_reply(f, s, sp, e, a))

    def _rollover_locked(self, charge_inflight: bool, uncharged_seq: Optional[int] = None):
        """Advance to the next epoch, re-queueing un-acked tasks. Lock held."""
        resend = sorted(self.inflight.items())
        self.inflight.clear()
        self.epoch += 1
        self.seq = 0
        keep: List[TaskSpec] = []
        dead: List[TaskSpec] = []
        for s, sp in resend:
            if charge_inflight and s != uncharged_seq:
                sp.attempt += 1
            if sp.max_retries == -1 or sp.attempt <= sp.max_retries:
                keep.append(sp)
            else:
                dead.append(sp)
        self.queue = keep + self.queue
        self.cv.notify_all()
        if dead:
            threading.Thread(target=self._fail_specs, args=(dead,),
                             daemon=True,
                             name="actor-pipeline-fail-specs").start()

    def _fail_specs(self, specs):
        for sp in specs:
            self.w._fail_task(
                sp, ActorUnavailableError(f"actor task {sp.name} lost connection after {sp.attempt} attempt(s)")
            )

    def _on_failure(self, epoch: int, addr, uncharged_seq: Optional[int] = None):
        with self.lock:
            if epoch != self.epoch:
                # late failure from a torn-down epoch: the address may now
                # belong to the healthy restarted incarnation — don't suspect
                return
            self.bad_addrs[tuple(addr)] = time.monotonic()
            self.current_addr = None
            with self.w._actor_lock:
                self.w._actor_addr_cache.pop(self.actor_id, None)
            self._rollover_locked(charge_inflight=True, uncharged_seq=uncharged_seq)

    def _on_reply(self, fut, seq: int, spec: TaskSpec, epoch: int, addr):
        exc = fut.exception()
        with self.lock:
            stale = epoch != self.epoch
            if not stale:
                if exc is None:
                    self.inflight.pop(seq, None)
            else:
                if exc is not None:
                    return  # old epoch already torn down
                # Late success from a torn-down epoch: accept it and withdraw
                # the duplicate resend if it hasn't executed yet.
                if spec in self.queue:
                    self.queue.remove(spec)
                else:
                    for s, sp in list(self.inflight.items()):
                        if sp is spec:
                            self.inflight.pop(s, None)
        if exc is None:
            try:
                self.w._handle_task_reply(spec, fut.result(), addr)
            except Exception:  # noqa: BLE001
                logger.exception("actor task reply handling failed")
        else:
            self._on_failure(epoch, addr)

    def _fail_all(self, error: Exception):
        with self.lock:
            doomed = list(self.queue) + [sp for _, sp in sorted(self.inflight.items())]
            self.queue.clear()
            self.inflight.clear()
            self.current_addr = None
        for sp in doomed:
            self.w._fail_task(sp, error)


class _InflightPush:
    """One pushed-but-unreplied task on a cached lease."""

    __slots__ = ("spec", "futs", "pushed_at", "confirmed", "settled",
                 "steal_requested", "sched_delay")

    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.futs: list = []
        self.pushed_at = 0.0
        self.confirmed = False   # HasTask probe saw it (long-running task)
        self.settled = False     # a reply (or failure) was consumed
        self.steal_requested = False
        self.sched_delay = None  # owner-side submit→assignment, attempt 0


class _CachedLease:
    """A granted worker lease held by the owner for reuse (one worker)."""

    __slots__ = ("key", "lease", "lease_id", "worker_addr", "raylet_cli",
                 "worker_cli", "inflight", "idle_since", "valid",
                 "no_assign", "used", "exit_reason")

    def __init__(self, key, lease: dict, raylet_cli, worker_cli):
        self.key = key
        self.lease = lease
        self.lease_id = lease.get("lease_id")
        self.worker_addr = tuple(lease["worker_addr"])
        self.raylet_cli = raylet_cli
        self.worker_cli = worker_cli
        self.inflight: Dict[TaskID, _InflightPush] = {}
        self.idle_since = time.monotonic()
        self.valid = True
        self.no_assign = False   # draining raylet: finish in-flight, no new
        self.used = False        # a task was assigned at least once
        self.exit_reason: Optional[str] = None


class _KeyState:
    """Per-scheduling-key submission state (queue + cached leases)."""

    __slots__ = ("queue", "leases", "requested", "saturated", "saturated_at",
                 "spread")

    def __init__(self, spread: bool = False):
        self.queue: deque = deque()
        self.leases: List[_CachedLease] = []
        self.requested = 0       # lease units with an outstanding request
        # SPREAD-strategy keys bypass the cache: reusing a lease would
        # funnel tasks to one node, defeating the strategy's purpose —
        # every task gets a fresh (raylet-distributed) lease instead
        self.spread = spread
        # the last batched request came back SHORT (cluster capacity for
        # this key is exhausted): pipeline onto held leases instead of
        # queueing tasks owner-side for grants that won't come.  Cleared
        # when a lease is dropped (capacity may exist again) and re-probed
        # periodically while tasks still queue (the cluster may grow).
        self.saturated = False
        self.saturated_at = 0.0


class NormalTaskSubmitter:
    """Owner-side fast path for normal (non-actor) task submission.

    reference: the scheduling-key lease queues of NormalTaskSubmitter
    (normal_task_submitter.h:40-77).  Tasks are grouped by scheduling key
    (resource shape + runtime-env fingerprint + strategy); granted worker
    leases are CACHED per key and reused after a task finishes, with up to
    ``max_tasks_in_flight_per_worker`` tasks pipelined per leased worker
    (the worker executes FIFO), so the steady-state cost of a task is one
    PushTask round-trip instead of lease-request + push + return.  Lease
    demand is BATCHED: a key with N queued tasks asks for up to N leases
    (capped at 256) in ONE RequestWorkerLease call instead of N per-task
    RPCs — parallelism first; a short grant marks the key saturated,
    which engages pipelining and periodic re-probes.  Idle leases are
    returned after
    ``worker_lease_idle_timeout_s``; the raylet additionally reclaims
    leases whose TTL lapses unextended (owner death / lost extensions),
    after which a straggler push is refused with ``lease_invalid`` and the
    task resubmits through a fresh lease — never silently dropped.

    Fault paths: a dead worker fails ONLY its own queue (each task charged
    one retry attempt), lost pushes heal through the per-task HasTask
    ack-probe, and a draining raylet flips its leases to no-assign within
    one extension interval so new tasks land on survivors.
    """

    def __init__(self, worker: "CoreWorker"):
        self.w = worker
        self.lock = make_lock("NormalTaskSubmitter.lock")
        self.states: Dict[tuple, _KeyState] = {}
        # id(env) → (env, hash): the strong ref to env PINS the id — a
        # freed dict's id can be reused by a different env, so the entry
        # must keep its key's referent alive to stay sound
        self._env_key_cache: Dict[int, Tuple[dict, str]] = {}
        self._retries: list = []          # heap of (due, seq, spec)
        self._retry_seq = 0
        self._inflight_total = 0
        self._last_extend = 0.0
        # assignment → wire decoupling: _pump enqueues, the pusher thread
        # drains.  While one (expensive, ~100µs on this kernel) sendmsg is
        # in flight, concurrent submits pile up behind it and the next
        # drain coalesces them into one vectored write per lease — burst
        # submission pays ~one syscall per WORKER, not per task.
        self._send_q: deque = deque()
        self._send_ev = threading.Event()
        self._pusher = threading.Thread(
            target=self._pusher_loop, daemon=True,
            name="task-submitter-push")
        self._pusher.start()
        self._thread = threading.Thread(
            target=self._maintenance_loop, daemon=True,
            name="task-submitter-maint")
        self._thread.start()

    # -- scheduling key -------------------------------------------------

    def _key_for(self, spec: TaskSpec) -> tuple:
        from ray_tpu_torch._private.scheduler import SchedulingStrategy

        strat = spec.strategy or SchedulingStrategy()
        env = spec.runtime_env
        if not env:
            env_key = ""
        else:
            entry = self._env_key_cache.get(id(env))
            if entry is not None and entry[0] is env:
                env_key = entry[1]
            else:
                from ray_tpu_torch._private import runtime_env as renv

                if len(self._env_key_cache) > 4096:
                    self._env_key_cache.clear()
                env_key = renv.env_hash(renv.normalize(env))
                self._env_key_cache[id(env)] = (env, env_key)
        return (
            tuple(sorted(spec.resources.to_dict().items())),
            env_key,
            strat.kind,
            strat.node_id,
            strat.soft,
            str(strat.placement_group_id)
            if strat.placement_group_id is not None else None,
            strat.bundle_index,
            tuple(sorted((strat.labels or {}).items())),
        )

    # -- submission -----------------------------------------------------

    def submit(self, spec: TaskSpec):
        w = self.w
        if w.shutting_down:
            w._fail_task(spec, WorkerCrashedError("worker shutting down"))
            return
        key = self._key_for(spec)
        with self.lock:
            st = self.states.get(key)
            if st is None:
                st = self.states[key] = _KeyState(spread=(key[2] == "spread"))
            st.queue.append(spec)
        if spec.trace_id is not None:
            # per-task QUEUED/SCHEDULED phases moved owner-side with the
            # lease cache (the raylet only sees one representative spec per
            # batch); stamped for traced tasks — the tracing timeline needs
            # them, the untraced hot path shouldn't pay 2 events per task
            w._record_task_event(spec, "QUEUED")
        self._pump(key)

    def _pump(self, key):
        """Assign queued tasks to cached leases; request leases for the
        remainder.  Parallelism first: while the cluster may still grant
        leases (not saturated, no request in flight) each lease takes ONE
        task and the rest wait for fresh grants — a long task must not
        trap a later one behind it when a free worker was available.
        Pipelining (depth up to max_tasks_in_flight_per_worker) engages
        while a request is outstanding and once the raylet's grant came
        back short (capacity exhausted — queueing owner-side would just
        idle the workers we DO hold)."""
        cfg = global_config()
        max_if = max(1, cfg.max_tasks_in_flight_per_worker)
        pushes = []
        requests: List[int] = []
        with self.lock:
            st = self.states.get(key)
            if st is None:
                return
            # depth 1 until the raylet has demonstrated capacity exhaustion
            # (short grant): pipelining a task behind a possibly-long one
            # is only right when no free worker could be granted anyway
            depth = max_if if (st.saturated and not st.spread) else 1
            while st.queue:
                best = None
                best_n = None
                for lease in st.leases:
                    if not lease.valid or lease.no_assign:
                        continue
                    limit = depth if lease.lease.get("reusable") else 1
                    n = len(lease.inflight)
                    if n < limit and (best_n is None or n < best_n):
                        best, best_n = lease, n
                if best is None:
                    break
                spec = st.queue.popleft()
                entry = _InflightPush(spec)
                best.inflight[spec.task_id] = entry
                self._inflight_total += 1
                pushes.append((best, spec, entry, best.used))
                best.used = True
            if st.queue:
                if st.spread:
                    # fresh lease per task, requests covering the queue:
                    # the raylet's spread policy does the distributing
                    deficit = min(len(st.queue), 64) - st.requested
                    if deficit > 0:
                        st.requested += deficit
                        requests.append(deficit)
                elif cfg.worker_lease_reuse_enabled:
                    # ONE outstanding batched request per key: ask for a
                    # lease per queued task; the raylet grants what fits
                    # and the short grant flips this key to saturated.
                    # Saturated keys re-probe every few seconds (the
                    # cluster may have grown) without stalling pipelining.
                    now = time.monotonic()
                    reprobe = (st.saturated
                               and now - st.saturated_at > 5.0)
                    if st.requested == 0 and (not st.saturated or reprobe):
                        if reprobe:
                            st.saturated_at = now
                        count = min(len(st.queue), 256)
                        st.requested = count
                        requests.append(count)
                else:
                    # legacy A/B mode: per-task lease requests
                    deficit = min(len(st.queue), 8) - st.requested
                    if deficit > 0:
                        st.requested += deficit
                        requests.extend([1] * deficit)
        if pushes:
            now = time.monotonic()
            for lease, spec, entry, reused in pushes:
                runtime_metrics.add_lease_reuse("hit" if reused else "new")
                if spec.submit_ts and spec.attempt == 0:
                    # submit→start is completed at reply time by adding the
                    # worker-reported FIFO wait: a task pipelined behind a
                    # long one must not report ~0 scheduling latency
                    entry.sched_delay = now - spec.submit_ts
                if spec.trace_id is not None:
                    self.w._record_task_event(spec, "SCHEDULED")
                self._send_q.append((lease, spec, entry))
            self._send_ev.set()
        for count in requests:
            self.w._submit_pool.submit(self._request_leases, key, count)

    def _pusher_loop(self):
        while True:
            self._send_ev.wait(timeout=0.5)
            if self.w.shutting_down:
                return
            self._send_ev.clear()
            items = []
            while True:
                try:
                    items.append(self._send_q.popleft())
                except IndexError:
                    break
            if not items:
                continue
            by_lease: Dict[int, tuple] = {}
            for lease, spec, entry in items:
                by_lease.setdefault(id(lease), (lease, []))[1].append(
                    (spec, entry))
            for lease, group in by_lease.values():
                try:
                    self._push_batch(lease, group)
                except Exception:  # noqa: BLE001 — one bad batch must not
                    # kill the (only) pusher thread: every later submission
                    # would enqueue forever with no error
                    logger.exception("push batch of %d tasks failed",
                                     len(group))

    def _push_batch(self, lease: _CachedLease, items):
        """Push every (spec, entry) bound to this lease in ONE vectored
        socket write — pipelined tasks to the same worker share a syscall."""
        w = self.w
        for spec, _ in items:
            w._task_exec_addr[spec.task_id] = lease.worker_addr
            w._task_lease_raylet[spec.task_id] = lease.raylet_cli
        try:
            futs = lease.worker_cli.call_async_batch(
                [("PushTask", {"spec": spec, "lease": lease.lease})
                 for spec, _ in items])
        except Exception as e:  # noqa: BLE001 — ConnectionLost, or a spec
            # that won't encode: fail over per task (retries are charged;
            # a deterministic encode error exhausts them and surfaces)
            with self.lock:
                for spec, entry in items:
                    if (not entry.settled
                            and lease.inflight.pop(spec.task_id, None)
                            is not None):
                        entry.settled = True
                        self._inflight_total -= 1
            for spec, _ in items:
                try:
                    self._on_push_error(lease, spec, e)
                except Exception:  # noqa: BLE001
                    logger.exception("push failover failed for %s", spec.name)
            return
        now = time.monotonic()
        for (spec, entry), fut in zip(items, futs):
            entry.futs.append(fut)
            entry.pushed_at = now
            fut.add_done_callback(
                lambda f, l=lease, s=spec: self._on_reply(l, s, f))

    # -- reply / failure handling ---------------------------------------

    def _on_reply(self, lease: _CachedLease, spec: TaskSpec, fut):
        exc = fut.exception()
        with self.lock:
            entry = lease.inflight.get(spec.task_id)
            if entry is None or entry.settled:
                return  # duplicate resend reply; the first one settled it
            entry.settled = True
            lease.inflight.pop(spec.task_id, None)
            self._inflight_total -= 1
            if not lease.inflight:
                lease.idle_since = time.monotonic()
        w = self.w
        w._task_exec_addr.pop(spec.task_id, None)
        if exc is not None:
            self._on_push_error(lease, spec, exc)
            return
        reply = fut.result()
        if isinstance(reply, dict) and reply.get("status") == "lease_invalid":
            # raylet reclaimed the lease under us (TTL after lost
            # extensions): the task never ran — resubmit uncharged
            self._invalidate_lease(lease)
            self.submit(spec)
            return
        if isinstance(reply, dict) and reply.get("status") == "stolen":
            # work stealing: the task was pulled back off a backlogged
            # worker's queue — resubmit uncharged; the idle lease that
            # initiated the steal picks it up
            self.submit(spec)
            return
        if not lease.lease.get("reusable"):
            self._invalidate_lease(lease)
        else:
            with self.lock:
                st = self.states.get(lease.key)
                spread = st.spread if st is not None else False
            if spread:
                self._invalidate_lease(lease, return_worker=True)
        if entry.sched_delay is not None and isinstance(reply, dict):
            # owner-side submit→assignment plus the worker-reported FIFO
            # wait (both intervals local to one clock — no cross-host skew)
            runtime_metrics.observe_submit_to_start(
                entry.sched_delay + float(reply.get("queued_s") or 0.0))
        try:
            w._handle_task_reply(spec, reply, lease.worker_addr)
        except Exception:  # noqa: BLE001
            logger.exception("task reply handling failed for %s", spec.name)
        self._pump(lease.key)
        self._rebalance(lease.key)

    def _lease_exit_reason(self, lease: _CachedLease) -> str:
        if lease.exit_reason is None:
            try:
                lease.exit_reason = lease.raylet_cli.call(
                    "GetWorkerExitReason",
                    {"worker_addr": lease.worker_addr},
                    timeout=2, retry_deadline=0.0) or ""
            except Exception:  # noqa: BLE001
                lease.exit_reason = ""
        return lease.exit_reason

    def _on_push_error(self, lease: _CachedLease, spec: TaskSpec, exc):
        """The leased worker died (or its socket did): fail over ONLY the
        tasks on this lease — each is charged one attempt and retried
        through a fresh lease, exactly once per death (no duplicates: the
        worker is gone, nothing queued there survives)."""
        w = self.w
        w._task_exec_addr.pop(spec.task_id, None)
        reason = self._lease_exit_reason(lease)
        self._invalidate_lease(lease)
        if spec.task_id in w._cancelled_tasks:
            w._cancelled_tasks.discard(spec.task_id)
            w._fail_task(spec, TaskCancelledError(
                f"task {spec.name} was cancelled"))
            return
        if reason == "oom":
            err: Exception = OutOfMemoryError(
                f"worker {lease.worker_addr} running {spec.name} was killed "
                "by the memory monitor (node memory over threshold)")
        else:
            err = WorkerCrashedError(
                f"worker {lease.worker_addr} died while running {spec.name}: "
                f"{exc}")
        self._retry_or_fail(spec, err)

    def _retry_or_fail(self, spec: TaskSpec, err: Exception):
        w = self.w
        if spec.max_retries != -1 and spec.attempt >= max(spec.max_retries, 0):
            err_cls = (OutOfMemoryError if isinstance(err, OutOfMemoryError)
                       else WorkerCrashedError)
            w._fail_task(spec, err_cls(
                f"task {spec.name} failed after {spec.attempt + 1} "
                f"attempts: {err}"))
            return
        spec.attempt += 1
        logger.info("retrying task %s (attempt %d): %s",
                    spec.name, spec.attempt, err)
        if isinstance(err, OutOfMemoryError):
            # slower backoff: give node memory pressure time to clear so
            # retries aren't immediately re-killed
            delay = min(1.0 * (2 ** min(spec.attempt, 5)), 30.0)
        else:
            delay = min(0.05 * (2 ** min(spec.attempt, 6)), 2.0)
        import heapq

        with self.lock:
            self._retry_seq += 1
            heapq.heappush(self._retries,
                           (time.monotonic() + delay, self._retry_seq, spec))

    # -- lease lifecycle -------------------------------------------------

    def _invalidate_lease(self, lease: _CachedLease,
                          return_worker: bool = False):
        with self.lock:
            if not lease.valid:
                return
            lease.valid = False
            flight_recorder.record("lease", "invalidate", lease.lease_id)
            st = self.states.get(lease.key)
            if st is not None:
                if lease in st.leases:
                    st.leases.remove(lease)
                # a dropped lease frees resources: the next pump may get
                # fresh grants again
                st.saturated = False
        if return_worker:
            try:
                lease.raylet_cli.notify("ReturnWorker",
                                        {"lease_id": lease.lease_id})
            except Exception:  # noqa: BLE001 — raylet gone: TTL reclaim covers the lease
                pass

    def _request_leases(self, key, count: int):
        try:
            self._request_leases_body(key, count)
        except Exception:  # noqa: BLE001
            logger.exception("lease request for key %s failed", key)
        finally:
            with self.lock:
                st = self.states.get(key)
                if st is not None:
                    st.requested = max(0, st.requested - count)
            self._pump(key)
            self._rebalance(key)

    def _request_leases_body(self, key, count: int):
        w = self.w
        with self.lock:
            st = self.states.get(key)
            spec = st.queue[0] if st and st.queue else None
        if spec is None:
            return
        runtime_metrics.inc_lease_request()
        target = w.raylet
        hops = 0
        rejections = 0
        while not w.shutting_down:
            try:
                if (hops == 0 and spec.strategy
                        and spec.strategy.kind == "placement_group"):
                    target = w._resolve_pg_raylet(spec)
                reply = target.call(
                    "RequestWorkerLease",
                    {"spec": spec, "for_actor": False, "num_leases": count},
                    timeout=None)
            except (ConnectionLost, RemoteError) as e:
                reply = {"rejected": True, "reason": str(e)}
            if "spillback" in reply and "leases" not in reply:
                hops += 1
                if hops > 16:
                    reply = {"rejected": True, "reason": "lease spillback loop"}
                else:
                    target = w.pool.get(tuple(reply["spillback"]))
                    continue
            if reply.get("rejected"):
                rejections += 1
                survivors = self._charge_rejection(
                    key, reply.get("reason", ""))
                if not survivors:
                    return
                time.sleep(min(0.05 * (2 ** min(rejections, 6)), 2.0))
                target = w.raylet
                hops = 0
                with self.lock:
                    st = self.states.get(key)
                    spec = st.queue[0] if st and st.queue else None
                if spec is None:
                    return
                continue
            leases = reply.get("leases") or [reply]
            spill = reply.get("spillback") if "leases" in reply else None
            with self.lock:
                st = self.states.get(key)
                if st is None:
                    st = self.states[key] = _KeyState(spread=(key[2] == "spread"))
                if spill is None:
                    # final grant of this round: short means the cluster
                    # can't serve more leases for this key right now
                    st.saturated = len(leases) < count
                    st.saturated_at = time.monotonic()
                for ld in leases:
                    flight_recorder.record("lease", "grant",
                                           ld.get("lease_id"))
                    st.leases.append(_CachedLease(
                        key, ld,
                        raylet_cli=w.pool.get(tuple(ld["raylet_addr"])),
                        worker_cli=w.pool.get(tuple(ld["worker_addr"]))))
            if spill is not None and len(leases) < count:
                # partial local grant + a pointer at the node holding the
                # next-best capacity: keep requesting the remainder there
                hops += 1
                if hops > 16:
                    return
                count -= len(leases)
                target = w.pool.get(tuple(spill))
                self._pump(key)
                continue
            return

    def _charge_rejection(self, key, reason: str) -> int:
        """A rejected lease request charges every queued task of the key
        one attempt (mirroring the per-task retry accounting the old
        per-task lease path had); over-budget tasks fail with the
        rejection reason.  Returns how many tasks survive to retry."""
        w = self.w
        with self.lock:
            st = self.states.get(key)
            if st is None:
                return 0
            specs = list(st.queue)
            st.queue.clear()
        survivors, doomed, cancelled = [], [], []
        for sp in specs:
            if sp.task_id in w._cancelled_tasks:
                cancelled.append(sp)
            elif sp.max_retries != -1 and sp.attempt >= max(sp.max_retries, 0):
                doomed.append(sp)
            else:
                sp.attempt += 1
                survivors.append(sp)
        with self.lock:
            st = self.states.get(key)
            if st is not None:
                st.queue.extendleft(reversed(survivors))
        for sp in cancelled:
            w._cancelled_tasks.discard(sp.task_id)
            w._fail_task(sp, TaskCancelledError(
                f"task {sp.name} was cancelled"))
        for sp in doomed:
            w._fail_task(sp, WorkerCrashedError(
                f"task {sp.name} failed after {sp.attempt + 1} attempts: "
                f"lease rejected: {reason}"))
        return len(survivors)

    def _rebalance(self, key):
        """Work stealing (reference: the submitter's work-stealing mode):
        when a lease idles with nothing queued owner-side while a peer
        lease has tasks stacked behind a running one, pull the most
        recently pushed (least likely to have started) task back — the
        worker refuses if it already started.  Prevents the pipelining
        gamble from stranding short tasks behind a long one once capacity
        frees up elsewhere."""
        steals = []
        with self.lock:
            st = self.states.get(key)
            if st is None or st.queue:
                return
            idle = [l for l in st.leases
                    if l.valid and not l.no_assign and not l.inflight
                    and l.lease.get("reusable")]
            if not idle:
                return
            victims = sorted(
                (l for l in st.leases if l.valid and len(l.inflight) > 1),
                key=lambda l: -len(l.inflight))
            vi = 0
            for _ in idle:
                while vi < len(victims):
                    victim = victims[vi]
                    candidates = [e for e in victim.inflight.values()
                                  if not e.steal_requested and not e.settled]
                    if len(victim.inflight) <= 1 or not candidates:
                        vi += 1
                        continue
                    # most recently pushed = deepest in the worker's FIFO,
                    # least likely to have started
                    entry = max(candidates, key=lambda e: e.pushed_at)
                    entry.steal_requested = True
                    steals.append((victim, entry.spec.task_id))
                    break
                else:
                    break
        for victim, task_id in steals:
            try:
                victim.worker_cli.notify("StealTask", {"task_id": task_id})
            except Exception:  # noqa: BLE001 — victim gone: the steal becomes moot
                pass

    # -- owner-side cancellation ----------------------------------------

    def try_cancel_queued(self, task_id: TaskID) -> bool:
        """Remove a task still queued owner-side (never pushed); fails it
        with TaskCancelledError.  Returns False when it already left the
        queue (pushed or finished)."""
        found = None
        with self.lock:
            for st in self.states.values():
                for sp in st.queue:
                    if sp.task_id == task_id:
                        st.queue.remove(sp)
                        found = sp
                        break
                if found is not None:
                    break
            if found is None:
                for i, (_, _, sp) in enumerate(self._retries):
                    if sp.task_id == task_id:
                        import heapq

                        self._retries.pop(i)
                        heapq.heapify(self._retries)
                        found = sp
                        break
        if found is None:
            return False
        self.w._cancelled_tasks.discard(task_id)
        self.w._fail_task(found, TaskCancelledError(
            f"task {found.name} was cancelled"))
        return True

    # -- maintenance -----------------------------------------------------

    def _maintenance_loop(self):
        import heapq

        while True:
            time.sleep(0.1)
            w = self.w
            if w.shutting_down:
                self.release_all_leases()
                return
            try:
                now = time.monotonic()
                due = []
                with self.lock:
                    while self._retries and self._retries[0][0] <= now:
                        due.append(heapq.heappop(self._retries)[2])
                for spec in due:
                    self.submit(spec)
                self._retire_idle_leases(now)
                # liveness sweep: a key whose queue outlived its leases
                # (drain flipped them no-assign, retire dropped them, no
                # reply left to re-pump) must still get lease requests —
                # the saturation re-probe only fires inside _pump
                with self.lock:
                    queued_keys = [k for k, st in self.states.items()
                                   if st.queue]
                for key in queued_keys:
                    self._pump(key)
                cfg = global_config()
                interval = max(0.5, cfg.worker_lease_ttl_s / 4.0)
                if now - self._last_extend >= interval:
                    self._last_extend = now
                    self._extend_leases()
                self._probe_stale_pushes(now)
                runtime_metrics.set_tasks_in_flight(self._inflight_total)
            except Exception:  # noqa: BLE001
                logger.exception("task-submitter maintenance pass failed")

    def _retire_idle_leases(self, now: float):
        cfg = global_config()
        idle_after = cfg.worker_lease_idle_timeout_s
        retire = []
        with self.lock:
            for key, st in list(self.states.items()):
                for lease in list(st.leases):
                    if lease.inflight:
                        continue
                    if (lease.no_assign or not lease.valid
                            or not lease.lease.get("reusable")
                            or not cfg.worker_lease_reuse_enabled
                            or now - lease.idle_since > idle_after):
                        lease.valid = False
                        st.leases.remove(lease)
                        retire.append(lease)
                        # a dropped lease frees resources: the next pump
                        # may get fresh grants (mirrors _invalidate_lease)
                        st.saturated = False
                if not st.leases and not st.queue and not st.requested:
                    del self.states[key]
        for lease in retire:
            try:
                lease.raylet_cli.notify("ReturnWorker",
                                        {"lease_id": lease.lease_id})
            except Exception:  # noqa: BLE001 — raylet gone: TTL reclaim covers the lease
                pass

    def _extend_leases(self):
        """One ExtendLease call per raylet covering every held lease; the
        reply doubles as the invalidation/drain poll — a draining raylet
        flips its leases to no-assign HERE, so the owner stops pushing
        within one extension interval."""
        with self.lock:
            by_raylet: Dict[Any, List[_CachedLease]] = {}
            for st in self.states.values():
                for lease in st.leases:
                    if lease.valid and lease.lease.get("reusable"):
                        by_raylet.setdefault(lease.raylet_cli, []).append(lease)
        repump = set()
        for cli, leases in by_raylet.items():
            try:
                reply = cli.call(
                    "ExtendLease",
                    {"lease_ids": [l.lease_id for l in leases]},
                    timeout=2, retry_deadline=0.0)
            except Exception:  # noqa: BLE001 — unreachable raylet: its
                continue  # TTL reclaim converges; pushes surface errors
            if not isinstance(reply, dict):
                continue
            invalid = set(reply.get("invalid") or ())
            draining = bool(reply.get("draining"))
            for lease in leases:
                if lease.lease_id in invalid:
                    self._invalidate_lease(lease)
                    repump.add(lease.key)
                elif draining and not lease.no_assign:
                    with self.lock:
                        lease.no_assign = True
                    repump.add(lease.key)
        for key in repump:
            self._pump(key)

    def _probe_stale_pushes(self, now: float):
        """Lost-push heal (owner side of the PR-4 HasTask protocol), per
        pipelined task: a push unacknowledged past task_push_ack_timeout_s
        is probed; a worker that never saw this (task, attempt) gets the
        push RESENT on the same lease.  Duplicates are impossible: the
        worker registers receipt before executing and ignores repeat
        frames for a live attempt, and a finished task's reply frame
        precedes the probe reply on the same FIFO socket."""
        timeout = max(global_config().task_push_ack_timeout_s, 0.1)
        probes = []
        with self.lock:
            for st in self.states.values():
                for lease in st.leases:
                    for entry in lease.inflight.values():
                        if (not entry.confirmed and not entry.settled
                                and entry.pushed_at
                                and now - entry.pushed_at > timeout):
                            probes.append((lease, entry))
        for lease, entry in probes:
            spec = entry.spec
            try:
                seen = lease.worker_cli.call(
                    "HasTask",
                    {"task_id": spec.task_id.hex(), "attempt": spec.attempt},
                    timeout=5, retry_deadline=0.0)
            except Exception:  # noqa: BLE001 — probe inconclusive; a dead
                continue  # socket surfaces ConnectionLost on the futures
            if entry.settled:
                continue
            if seen:
                entry.confirmed = True
            elif not any(f.done() for f in entry.futs):
                logger.warning(
                    "push of task %s (attempt %d) to %s was lost; resending",
                    spec.name, spec.attempt, lease.worker_addr)
                try:
                    fut = lease.worker_cli.call_async(
                        "PushTask", {"spec": spec, "lease": lease.lease})
                except ConnectionLost:
                    continue
                entry.futs.append(fut)
                entry.pushed_at = now
                fut.add_done_callback(
                    lambda f, l=lease, s=spec: self._on_reply(l, s, f))

    def release_all_leases(self):
        """Best-effort return of every cached lease (shutdown path); the
        raylet's TTL reclaim covers anything the notifies miss."""
        with self.lock:
            leases = [l for st in self.states.values() for l in st.leases]
            for st in self.states.values():
                st.leases.clear()
        for lease in leases:
            lease.valid = False
            try:
                lease.raylet_cli.notify("ReturnWorker",
                                        {"lease_id": lease.lease_id})
            except Exception:  # noqa: BLE001 — raylet gone: TTL reclaim covers the lease
                pass

    def stats(self) -> dict:
        with self.lock:
            return {
                "keys": len(self.states),
                "cached_leases": sum(len(st.leases)
                                     for st in self.states.values()),
                "queued": sum(len(st.queue) for st in self.states.values()),
                "in_flight": self._inflight_total,
            }


_PENDING = object()
_global_worker: Optional[CoreWorker] = None


def get_global_worker() -> CoreWorker:
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _global_worker


def set_global_worker(worker: Optional[CoreWorker]):
    global _global_worker
    _global_worker = worker


def get(refs, timeout=None):
    return get_global_worker().get(refs, timeout=timeout)
