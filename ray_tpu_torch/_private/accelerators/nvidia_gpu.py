"""NVIDIA GPU accelerator manager.

reference: python/ray/_private/accelerators/nvidia_gpu.py — resource name
"GPU", autodetect via pynvml when present (gated; this TPU-first image
ships none) falling back to /proc/driver/nvidia/gpus, visible devices via
CUDA_VISIBLE_DEVICES.  Included so heterogeneous clusters (TPU pods + GPU
node groups) schedule both under one framework.
"""

from __future__ import annotations

import glob
import os
import subprocess
from typing import Dict, List, Optional

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


class NvidiaGPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> Optional[str]:
        return CUDA_VISIBLE_DEVICES_ENV

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        count = NvidiaGPUAcceleratorManager._detect_physical_count()
        # a CUDA_VISIBLE_DEVICES restriction caps what this node may
        # advertise (reference: ray clamps autodetected GPUs to the list)
        visible = NvidiaGPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        if visible is not None:
            count = min(count, len(visible))
        return count

    @staticmethod
    def _detect_physical_count() -> int:
        try:
            import pynvml  # type: ignore

            pynvml.nvmlInit()
            try:
                return int(pynvml.nvmlDeviceGetCount())
            finally:
                pynvml.nvmlShutdown()
        except Exception:  # noqa: BLE001 — no pynvml / no driver
            pass
        n = len(glob.glob("/proc/driver/nvidia/gpus/*"))
        if n:
            return n
        # containers may hide /proc/driver/nvidia; ask nvidia-smi in a
        # subprocess so this process never initialises CUDA (a raylet that
        # later forks or a driver that owns the card must not)
        try:
            out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                 text=True, timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            return 0
        if out.returncode != 0:
            return 0
        return sum(line.startswith("GPU ") for line in out.stdout.splitlines())

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        try:
            import pynvml  # type: ignore

            pynvml.nvmlInit()
            try:
                if pynvml.nvmlDeviceGetCount() < 1:
                    return None
                handle = pynvml.nvmlDeviceGetHandleByIndex(0)
                name = pynvml.nvmlDeviceGetName(handle)
                if isinstance(name, bytes):
                    name = name.decode()
                return name.replace("NVIDIA ", "").split(" PCIe")[0].strip()
            finally:
                pynvml.nvmlShutdown()
        except Exception:  # noqa: BLE001
            return None

    @staticmethod
    def validate_resource_request_quantity(quantity: float) -> tuple:
        return (True, None)  # GPUs are fractional-friendly

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        raw = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if raw is None:
            return None
        return [] if raw in ("", "NoDevFiles") else raw.split(",")

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        if os.environ.get("RAY_TPU_NOSET_CUDA_VISIBLE_DEVICES"):
            return
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(i) for i in ids)

    @staticmethod
    def get_current_node_additional_resources() -> Dict[str, float]:
        return {}

    @staticmethod
    def get_current_node_labels() -> Dict[str, str]:
        return {}
