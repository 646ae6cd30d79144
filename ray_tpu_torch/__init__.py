"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA H100s.

It mirrors the JAX package's layout (``ops``, ``models``, ``llm``,
``parallel``, ``_private``) so each module's counterpart is easy to find,
imports no JAX and nothing of ``ray_tpu``, and runs on CUDA unless a
caller asks for the CPU.  Each Pallas TPU kernel on a ported path becomes a
hand-written kernel under ``ops/csrc``.  The runtime core (tasks, actors,
objects, placement groups) is a copy of the JAX package's, with the card as
the ``GPU`` resource:

    import ray_tpu_torch

    ray_tpu_torch.init(num_gpus=1)

    @ray_tpu_torch.remote(num_gpus=1)
    class Server:
        def ids(self):
            return ray_tpu_torch.get_gpu_ids()

ROADMAP.md lists what is ported and what is still to come.
"""

from __future__ import annotations

import inspect
import os
import threading
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch._private.task_spec import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    OutOfMemoryError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch._private.worker import (
    DRIVER,
    CoreWorker,
    ObjectRef,
    ObjectRefGenerator,
    get_global_worker,
    set_global_worker,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"

_init_lock = threading.Lock()
_local_node = None  # the in-process head Node when we started one


def init(
    address: Optional[Tuple[str, int]] = None,
    *,
    num_cpus: Optional[float] = None,
    num_tpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    object_store_memory: Optional[int] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    _raylet_addr: Optional[Tuple[str, int]] = None,
    _gcs_addr: Optional[Tuple[str, int]] = None,
) -> CoreWorker:
    """Start (or connect to) a cluster and attach this process as the driver."""
    global _local_node
    from ray_tpu_torch._private import worker as worker_mod

    with _init_lock:
        if worker_mod._global_worker is not None:
            if ignore_reinit_error:
                return worker_mod._global_worker
            raise RuntimeError("ray_tpu_torch.init() already called; use shutdown() first")
        if address == "auto":
            # resolved BEFORE the ray:// check so RAY_TPU_ADDRESS may point
            # at either a head node or a client server
            address = os.environ.get("RAY_TPU_ADDRESS")
            if not address:
                raise ValueError(
                    'init(address="auto") requires the RAY_TPU_ADDRESS '
                    "environment variable (host:port of a running head node, "
                    "or ray://host:port of a client server)")
        if isinstance(address, str) and address.startswith("ray://"):
            # Client (proxy) mode: drive the cluster through an in-cluster
            # ClientServer (reference: python/ray/util/client/, ray:// URIs).
            raise NotImplementedError(
                "ray:// client mode (util/client) is not ported yet: "
                "ROADMAP A16")
        if isinstance(address, str):
            from ray_tpu_torch._private.utils import parse_host_port

            address = parse_host_port(address)
        if _raylet_addr is None:
            if address is not None:
                # Connect to an existing cluster: use the head node's raylet.
                from ray_tpu_torch._private.rpc import RpcClient

                gcs = RpcClient(tuple(address))
                # graftlint: allow(blocking-under-lock) — init is one-shot
                # and serialized by design: a concurrent init() must wait
                # for the first one's cluster handshake either way
                nodes = gcs.call("GetAllNodeInfo", None)
                head = next((n for n in nodes if n.get("is_head")), nodes[0] if nodes else None)
                if head is None:
                    raise RuntimeError("cluster has no nodes")
                _raylet_addr = tuple(head["address"])
                _gcs_addr = tuple(address)
                gcs.close()
            else:
                from ray_tpu_torch._private.node import Node

                res = dict(resources or {})
                if num_cpus is not None:
                    res["CPU"] = float(num_cpus)
                if num_tpus is not None:
                    res["TPU"] = float(num_tpus)
                if num_gpus is not None:
                    res["GPU"] = float(num_gpus)
                _local_node = Node(
                    head=True,
                    resources=res or None,
                    labels=labels,
                    object_store_memory=object_store_memory,
                )
                _raylet_addr = _local_node.raylet_address
                _gcs_addr = _local_node.gcs_address
        w = CoreWorker(mode=DRIVER, raylet_addr=_raylet_addr, gcs_addr=_gcs_addr)
        set_global_worker(w)
        if log_to_driver and not os.environ.get("RAY_TPU_WORKER_QUIET"):
            w.subscribe_worker_logs()
        return w


def is_initialized() -> bool:
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod._global_worker is not None


def shutdown():
    global _local_node
    from ray_tpu_torch._private import worker as worker_mod

    with _init_lock:
        w = worker_mod._global_worker
        if w is not None:
            w.shutdown()
            set_global_worker(None)
        if _local_node is not None:
            _local_node.shutdown()
            _local_node = None


def remote(*args, **kwargs):
    """Decorator turning a function into a RemoteFunction / class into an ActorClass."""

    def make(target):
        if inspect.isclass(target):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    if args:
        raise TypeError("@ray_tpu_torch.remote takes keyword options only, e.g. @ray_tpu_torch.remote(num_tpus=4)")
    return make


def get(refs, timeout: Optional[float] = None):
    return get_global_worker().get(refs, timeout=timeout)


def put(value) -> ObjectRef:
    return get_global_worker().put(value)


def wait(refs, *, num_returns: int = 1, timeout: Optional[float] = None, fetch_local: bool = True):
    return get_global_worker().wait(refs, num_returns=num_returns, timeout=timeout, fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    get_global_worker().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False) -> bool:
    """Cancel the task producing ``ref`` (reference: ray.cancel — queued
    tasks are dropped, running ones interrupted; force kills the worker).
    Pending results raise TaskCancelledError from get()."""
    return get_global_worker().cancel_task(ref, force=force)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    info = get_global_worker().get_named_actor(name, namespace)
    return ActorHandle(info["actor_id"])


def nodes():
    return get_global_worker().gcs.call("GetAllNodeInfo", None)


def cluster_resources() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n in nodes():
        if n["state"] != "ALIVE":
            continue
        for k, v in n["resources"]["total"].items():
            out[k] = out.get(k, 0) + v
    return out


def available_resources() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n in nodes():
        if n["state"] != "ALIVE":
            continue
        for k, v in n["resources"]["available"].items():
            out[k] = out.get(k, 0) + v
    return out


def get_tpu_ids() -> list:
    """Chip indices assigned to this worker (reference analog: get_gpu_ids,
    worker.py:1104), derived from TPU_VISIBLE_CHIPS set at lease binding."""
    from ray_tpu_torch._private.accelerators.tpu import TPUAcceleratorManager

    ids = TPUAcceleratorManager.get_current_process_visible_accelerator_ids()
    return [int(i) for i in ids] if ids else []


def get_gpu_ids() -> list:
    """Card indices assigned to this worker (the counterpart of
    get_tpu_ids), from CUDA_VISIBLE_DEVICES set at lease binding."""
    from ray_tpu_torch._private.accelerators.nvidia_gpu import (
        NvidiaGPUAcceleratorManager,
    )

    ids = NvidiaGPUAcceleratorManager.get_current_process_visible_accelerator_ids()
    return [int(i) for i in ids] if ids else []


def get_runtime_context():
    from ray_tpu_torch.runtime_context import RuntimeContext

    return RuntimeContext(get_global_worker())


def timeline(filename=None):
    """Export a Chrome trace of all task executions (reference: ray.timeline)."""
    from ray_tpu_torch._private.timeline import timeline as _timeline

    return _timeline(filename)


__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "nodes",
    "cluster_resources",
    "available_resources",
    "get_tpu_ids",
    "get_gpu_ids",
    "get_runtime_context",
    "timeline",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorHandle",
    "RayTpuError",
    "TaskError",
    "ActorDiedError",
    "ActorUnavailableError",
    "ObjectLostError",
    "GetTimeoutError",
    "OutOfMemoryError",
    "WorkerCrashedError",
    "TaskCancelledError",
]
