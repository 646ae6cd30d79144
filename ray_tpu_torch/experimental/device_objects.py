"""Device-resident objects: refs travel in-band, tensors stay on device
(port of the JAX package's ``experimental/device_objects.py``).

reference: python/ray/experimental/gpu_object_manager/ (RDT — "GPU
objects"): tensors produced on an accelerator are NOT copied into the
host object store; a small ref (id + owner + dtype/shape metadata) travels
through the normal task/actor path, and the data moves out-of-band only
when a consumer needs it — over collectives when a group links producer
and consumer, else host transfer.

On the card: plasma is host RAM, and a CUDA tensor cannot be "put"
cheaply.  A DeviceRef keeps the tensor in the owning actor's process (on
its card); ``device_get`` on another actor fetches it: through
``ray_tpu_torch.util.collective`` send/recv when both actors share a
collective group (NCCL between cards with the nccl backend), else through
one host round trip.  ``last_fetch_path`` says which ran ("local",
"group" or "host").
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from typing import Any, Dict, Optional, Tuple

# per-process device object store: obj_id -> tensor
_STORE: Dict[str, Any] = {}
_LOCK = threading.Lock()
# how this process's last device_get was served
last_fetch_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DeviceRef:
    """In-band handle to a device-resident tensor (reference: RDT object
    ref).

    Only metadata is serialized — never the tensor.  ``owner_addr`` lets any
    process (driver included) serve fetches; ``owner_actor_id`` is preferred
    when set because actor addresses survive restarts via the GCS.
    """

    object_id: str
    owner_actor_id: Optional[str]  # hex; None = non-actor owner
    shape: Tuple[int, ...]
    dtype: str
    owner_addr: Optional[Tuple[str, int]] = None
    device: str = "cpu"  # the owner's device type: "cuda" or "cpu"

    def __repr__(self):
        return (f"DeviceRef({self.object_id[:8]}…, shape={self.shape}, "
                f"dtype={self.dtype}, device={self.device})")


def _current_actor_id() -> Optional[str]:
    from ray_tpu_torch._private.worker import get_global_worker

    try:
        w = get_global_worker()
    except RuntimeError:  # usable without init (purely local refs)
        return None
    aid = getattr(w, "actor_id", None) if w is not None else None
    return aid.hex() if aid is not None else None


def _owner_addr_and_register() -> Optional[Tuple[str, int]]:
    """This process's RPC address; also registers the fetch handler once so
    any peer (driver/task worker owners included) can serve device_get."""
    from ray_tpu_torch._private.worker import get_global_worker

    try:
        w = get_global_worker()
    except RuntimeError:
        return None
    if w is None:
        return None
    w.server.register("DeviceFetch", _handle_device_fetch)  # idempotent
    return tuple(w.address)


def _handle_device_fetch(req):
    with _LOCK:
        value = _STORE.get(req["object_id"])
    if value is None:
        raise KeyError(f"device object {req['object_id']} not found on owner")
    return value.cpu()


def _on_this_side(host, ref: DeviceRef):
    """A host copy as the fetcher's tensor: on the card when the owner's
    was and this process has one."""
    import torch

    if ref.device == "cuda" and torch.cuda.is_available():
        return host.cuda()
    return host


def device_put(tensor) -> DeviceRef:
    """Pin a tensor (or numpy array, as a CPU tensor) in THIS process's
    device store."""
    import torch

    tensor = torch.as_tensor(tensor)
    ref = DeviceRef(
        object_id=uuid.uuid4().hex,
        owner_actor_id=_current_actor_id(),
        shape=tuple(tensor.shape),
        dtype=str(tensor.dtype).split(".")[1],
        owner_addr=_owner_addr_and_register(),
        device=tensor.device.type,
    )
    with _LOCK:
        _STORE[ref.object_id] = tensor
    return ref


def device_get(ref: DeviceRef, *, group_name: Optional[str] = None,
               src_rank: Optional[int] = None):
    """Resolve a DeviceRef to a tensor in THIS process.

    Local refs return the stored tensor directly (zero copy).  Remote refs
    transfer out-of-band: over the named collective group when given
    (its send/recv — NCCL between cards), else via a host round-trip
    through the owning actor.
    """
    global last_fetch_path
    with _LOCK:
        if ref.object_id in _STORE:
            last_fetch_path = "local"
            return _STORE[ref.object_id]
    if (group_name is None) != (src_rank is None):
        raise ValueError(
            "device_get needs BOTH group_name and src_rank for a collective "
            "fetch — a silent host fallback would strand the paired "
            "device_send and desync the group's p2p sequence")
    if group_name is not None:
        from ray_tpu_torch.util import collective as col

        value = col.recv(src_rank, group_name=group_name)
        last_fetch_path = "group"
    elif ref.owner_actor_id is not None:
        import ray_tpu_torch
        from ray_tpu_torch._private.ids import ActorID
        from ray_tpu_torch.actor import ActorHandle, ActorMethod

        owner = ActorHandle(ActorID(ref.owner_actor_id))
        host = ray_tpu_torch.get(
            ActorMethod(owner, "__ray_tpu_call__").remote(
                _fetch_to_host, ref.object_id))
        value = _on_this_side(host, ref)
        last_fetch_path = "host"
    elif ref.owner_addr is not None:
        from ray_tpu_torch._private.worker import get_global_worker

        w = get_global_worker()
        host = w.pool.get(tuple(ref.owner_addr)).call(
            "DeviceFetch", {"object_id": ref.object_id}, timeout=60)
        value = _on_this_side(host, ref)
        last_fetch_path = "host"
    else:
        raise ValueError(f"{ref}: not local and has no owner to fetch from")
    with _LOCK:
        _STORE[ref.object_id] = value  # cache locally (immutable objects)
    return value


def device_send(ref: DeviceRef, *, dst_rank: int, group_name: str):
    """Owner-side half of a collective transfer: push the tensor to
    ``dst_rank`` of ``group_name`` (pair with device_get on the receiver)."""
    from ray_tpu_torch.util import collective as col

    with _LOCK:
        value = _STORE.get(ref.object_id)
    if value is None:
        raise KeyError(f"{ref} not in this process's device store")
    col.send(value, dst_rank, group_name)


def device_free(ref: DeviceRef):
    """Drop this process's copy (owner drop frees the device memory)."""
    with _LOCK:
        _STORE.pop(ref.object_id, None)


def _fetch_to_host(instance, object_id: str):
    """Runs on the owning actor via __ray_tpu_call__: a host copy."""
    with _LOCK:
        value = _STORE.get(object_id)
    if value is None:
        raise KeyError(f"device object {object_id} not found on owner")
    return value.cpu()


def store_size() -> int:
    with _LOCK:
        return len(_STORE)
