"""Accelerator registry + node resource autodetection.

reference: python/ray/_private/accelerators/__init__.py:14-36 (registry) and
_private/utils.py:269-279 (visible-device binding at task start).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager
from ray_tpu_torch._private.accelerators.nvidia_gpu import NvidiaGPUAcceleratorManager
from ray_tpu_torch._private.accelerators.tpu import TPUAcceleratorManager

_MANAGERS: Dict[str, AcceleratorManager] = {
    "TPU": TPUAcceleratorManager,
    "GPU": NvidiaGPUAcceleratorManager,
}


def get_all_accelerator_managers() -> List[AcceleratorManager]:
    return list(_MANAGERS.values())


def get_accelerator_manager(resource_name: str) -> Optional[AcceleratorManager]:
    return _MANAGERS.get(resource_name)


def register_accelerator_manager(manager: AcceleratorManager):
    """Third-party plugin hook (reference: the registry pattern at
    accelerators/__init__.py:14-36 — one manager per vendor family)."""
    _MANAGERS[manager.get_resource_name()] = manager


def detect_node_resources_and_labels() -> Tuple[Dict[str, float], Dict[str, str]]:
    """Autodetect this machine's schedulable resources + labels."""
    resources: Dict[str, float] = {}
    labels: Dict[str, str] = {}
    num_cpus = os.cpu_count() or 1
    resources["CPU"] = float(os.environ.get("RAY_TPU_NUM_CPUS", num_cpus))
    try:
        import psutil  # type: ignore

        mem = psutil.virtual_memory().total
    except ImportError:
        try:
            mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        except (ValueError, OSError):
            mem = 8 * 1024**3
    resources["memory"] = float(mem)
    for mgr in _MANAGERS.values():
        n = mgr.get_current_node_num_accelerators()
        if n > 0:
            resources[mgr.get_resource_name()] = float(n)
            resources.update(mgr.get_current_node_additional_resources())
            labels.update(mgr.get_current_node_labels())
            acc_type = mgr.get_current_node_accelerator_type()
            if acc_type:
                resources[f"accelerator_type:{acc_type}"] = 1.0
    return resources, labels


def bind_visible_accelerators(resource_instances: Dict[str, list]) -> None:
    """Set visible-device env vars from lease-assigned instance ids before
    user code runs (reference: _raylet.pyx:2176-2182 → utils.py:269-279)."""
    for name, ids in (resource_instances or {}).items():
        mgr = get_accelerator_manager(name)
        if mgr is not None and ids:
            mgr.set_current_process_visible_accelerator_ids([str(i) for i in ids])
