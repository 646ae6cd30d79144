"""AcceleratorContext: pluggable vendor registry for channel communicators
(port of the JAX package's ``experimental/channel/accelerator_context.py``).

reference: python/ray/experimental/channel/accelerator_context.py:18,45,84 —
the registry where a vendor (or a framework like this one) plugs its
communicator.  The port registers a ``cuda`` context (its communicator
rides the collective groups: the nccl backend's NCCL between cards) beside
``cpu``; a tensor channel between two processes on ONE card moves its CUDA
leaves through CUDA IPC instead (``cuda_tensor_channel.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Type

from ray_tpu_torch.experimental.channel.communicator import (
    CollectiveGroupCommunicator,
    Communicator,
)

_lock = threading.Lock()
_registry: Dict[str, Type[Communicator]] = {}
_current: Optional[str] = None


def register_accelerator_context(name: str,
                                 communicator_cls: Type[Communicator]):
    """Register a communicator implementation under a vendor/platform name
    (reference: AcceleratorContext.register)."""
    with _lock:
        _registry[name] = communicator_cls


def set_accelerator_context(name: str):
    with _lock:
        if name not in _registry:
            raise ValueError(f"no accelerator context {name!r}; "
                             f"registered: {sorted(_registry)}")
        global _current
        _current = name


def _detect_default() -> str:
    """cuda when this process may use a card, else cpu — without a CUDA
    call where CUDA is not initialized yet: a process that must not touch
    the card (the zygote, which forks the workers) asks the visible-device
    list and the driver's /proc entries (or nvidia-smi in a subprocess)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return "cuda" if torch.cuda.device_count() > 0 else "cpu"
    from ray_tpu_torch._private.accelerators.nvidia_gpu import (
        NvidiaGPUAcceleratorManager,
    )

    try:
        n = NvidiaGPUAcceleratorManager.get_current_node_num_accelerators()
    except Exception:  # noqa: BLE001 — no driver, no card
        n = 0
    return "cuda" if n > 0 else "cpu"


def get_accelerator_context() -> Type[Communicator]:
    """The communicator class for the current platform (reference:
    AcceleratorContext.get)."""
    with _lock:
        name = _current or _detect_default()
        cls = _registry.get(name)
    if cls is None:
        raise ValueError(f"no accelerator context registered for {name!r}")
    return cls


def current_context_name() -> str:
    with _lock:
        return _current or _detect_default()


# default registrations: the card's communicator plugs into the same
# registry slot the reference reserves for vendors
register_accelerator_context("cpu", CollectiveGroupCommunicator)
register_accelerator_context("cuda", CollectiveGroupCommunicator)
