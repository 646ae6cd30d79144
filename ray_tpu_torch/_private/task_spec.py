"""Task and actor specifications + user-facing error types.

TPU-native equivalent of the reference's TaskSpecification
(reference: src/ray/common/task/task_spec.h) and exception hierarchy
(reference: python/ray/exceptions.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.scheduler import SchedulingStrategy


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    name: str
    # Function payload: cloudpickled callable, cached in GCS KV by digest so
    # repeated submissions ship only the 40-char key
    # (reference: _private/function_manager.py export/import pattern).
    function_digest: str
    function_blob: Optional[bytes]  # present on first submission, else None
    # Positional/kw args: values are either inline serialized bytes or ObjectIDs.
    args: List[Tuple[str, Any]] = field(default_factory=list)  # ("value", bytes) | ("ref", (ObjectID, owner_addr))
    kwargs: List[Tuple[str, str, Any]] = field(default_factory=list)  # (key, kind, payload)
    num_returns: int = 1
    resources: ResourceSet = field(default_factory=lambda: ResourceSet({"CPU": 1}))
    strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 3
    retry_exceptions: bool = False
    attempt: int = 0
    # owner-side submit time (monotonic, OWNER clock only): consumed by the
    # owner when the lease is granted to derive submit→start latency
    submit_ts: float = 0.0
    # distributed-trace context (reference: tracing_helper serializing the
    # OpenTelemetry context into the spec): trace_id is the whole causal
    # chain's id, span_id is THIS task's span, parent_span_id is the
    # submitter's active span.  None when tracing is disabled.
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_span_id: Optional[str] = None
    owner_addr: Optional[Tuple[str, int]] = None
    owner_worker_id: Optional[WorkerID] = None
    runtime_env: Optional[dict] = None
    # Actor fields
    actor_id: Optional[ActorID] = None           # set for actor tasks
    actor_creation: bool = False                 # this task creates an actor
    actor_method: Optional[str] = None
    sequence_number: int = 0                     # per-caller ordering for actor tasks
    max_concurrency: int = 1
    # named concurrency groups (reference: src/ray/core_worker/task_execution/
    # concurrency_group_manager.h; python/ray/actor.py:384-447): the creation
    # spec carries name -> max_concurrency, each actor task may carry the
    # group it dispatches to (per-call override or @ray_tpu_torch.method default)
    concurrency_groups: Optional[Dict[str, int]] = None
    concurrency_group: Optional[str] = None
    max_restarts: int = 0
    max_task_retries: int = 0
    detached: bool = False
    actor_name: Optional[str] = None

    def return_ids(self) -> List[ObjectID]:
        if self.num_returns == "streaming":
            # index 0 is the stream's completion anchor (item count / error);
            # yielded items take indices 1..n (reference: dynamic return ids
            # of streaming generators)
            return [ObjectID.from_task(self.task_id, 0)]
        return [ObjectID.from_task(self.task_id, i) for i in range(self.num_returns)]


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """Wraps an exception raised by user task code; re-raised at ray.get."""

    def __init__(self, cause: Exception, traceback_str: str, task_name: str = ""):
        super().__init__(f"task {task_name!r} failed: {cause!r}")
        self.cause = cause
        self.traceback_str = traceback_str


class WorkerCrashedError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    """Task's worker was killed by the raylet MemoryMonitor (reference:
    src/ray/common/memory_monitor.h:52 + OOM-retriable task kills)."""
    pass


class ActorDiedError(RayTpuError):
    def __init__(self, actor_id=None, reason: str = ""):
        super().__init__(f"actor {actor_id} died: {reason}")
        self.actor_id = actor_id
        self.reason = reason


class ActorUnavailableError(RayTpuError):
    pass


class ObjectLostError(RayTpuError):
    def __init__(self, object_id=None):
        super().__init__(f"object {object_id} lost and could not be reconstructed")
        self.object_id = object_id


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass
