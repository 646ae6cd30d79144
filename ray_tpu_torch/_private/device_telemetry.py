"""Device telemetry of the port: the part a serve replica reads.

``serve/_private/replica.py`` publishes its callable's ``utilization()``
row to the GCS KV when telemetry is enabled, under ``util_kv_key``.  This
module holds that constant and those two functions, copied from
``ray_tpu/_private/device_telemetry.py`` (``tests/test_torch_serve_copies.py``
holds each to its original).  The rest of the reference module (HBM
accounting, engine telemetry, the compile watch, MFU and roofline) reads
JAX's devices and live arrays; its CUDA twin is ROADMAP A12.
"""

from __future__ import annotations

# GCS KV namespace of the per-replica utilization rows
UTIL_KV_PREFIX = "util:"


def enabled() -> bool:
    from ray_tpu_torch._private.config import global_config

    return bool(global_config().device_telemetry_enabled)


def util_kv_key(app: str, deployment: str, replica: str) -> str:
    return f"{UTIL_KV_PREFIX}{app}/{deployment}/{replica}"
