"""User-facing train configs.

reference: python/ray/air/config.py — ScalingConfig :99 (num_workers :154,
use_gpu :155, resources_per_worker :156, accelerator_type :158), RunConfig,
FailureConfig, CheckpointConfig. The port trains on the card: ``use_gpu``
(on by default) books ``{"GPU": chips_per_worker or 1}`` per worker, the
counterpart of the JAX package's ``use_tpu``; ``use_tpu``, ``topology``
and ``tpu_slice`` refuse (the port has no TPU).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many training workers, with what resources, in what shape.

    One worker per card by default: ``num_workers`` sizes the gang and
    ``chips_per_worker`` gives a worker several cards.  ``use_gpu=False``
    trains on the CPU (the tests).
    """

    num_workers: int = 1
    use_tpu: bool = False
    use_gpu: bool = True  # {"GPU": chips_per_worker or 1} per worker
    chips_per_worker: Optional[int] = None
    topology: Optional[str] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    accelerator_type: Optional[str] = None
    placement_strategy: str = "PACK"
    tpu_slice: Optional[str] = None  # pin the gang to one named slice

    def __post_init__(self):
        asked = [name for name, v in (("use_tpu", self.use_tpu),
                                      ("topology", self.topology),
                                      ("tpu_slice", self.tpu_slice)) if v]
        if asked:
            raise ValueError(
                f"ScalingConfig({', '.join(asked)}=...): the port has no TPU; "
                "it trains on NVIDIA cards (use_gpu=True, chips_per_worker) "
                "or on the CPU (use_gpu=False)")

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = float(self.chips_per_worker or 1)
        if self.accelerator_type:
            res[f"accelerator_type:{self.accelerator_type}"] = 0.001
        return res

    @property
    def total_workers(self) -> int:
        if self.topology:
            return hosts_in_topology(self.topology, self.chips_per_worker or 4)
        return self.num_workers


def hosts_in_topology(topology: str, chips_per_host: int = 4) -> int:
    """Host count for a TPU topology string like "4x4x8" (chips = product of
    dims; v4/v5p hosts expose 4 chips — reference analog:
    accelerators/tpu.py:316 get_num_workers_in_pod)."""
    import math

    dims = [int(d) for d in topology.lower().split("x")]
    chips = math.prod(dims)
    return max(1, chips // chips_per_host)


@dataclasses.dataclass
class FailureConfig:
    """reference: air/config.py FailureConfig (max_failures)."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """reference: air/config.py CheckpointConfig (num_to_keep, attr ordering).

    TPU-native extension — the continuous async snapshot subsystem
    (train/_internal/snapshot.py), engaged when the train loop reports
    state pytrees (``train.report(metrics, state=...)``):

    - ``full_snapshot_interval``: every Nth snapshot writes ALL leaves;
      the ones between are deltas that reference unchanged leaves in an
      earlier manifest, so the interval bounds how long a delta chain can
      grow (and how much retention must protect).
    - ``optimizer_state_interval``: optimizer-state leaves (top-level key
      in ``optimizer_key_prefixes``) are written every Nth snapshot only;
      in between, delta manifests reference the last written version even
      if it changed — params are still captured every snapshot.
    - ``peer_replicas``: push each member's newest host-RAM shard copy to
      a ring neighbor so a preempted member restores from peer RAM inside
      the drain window instead of from storage.
    """

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    full_snapshot_interval: int = 8
    optimizer_state_interval: int = 1
    peer_replicas: bool = False


@dataclasses.dataclass
class RunConfig:
    """reference: air/config.py RunConfig (name, storage_path, failure/ckpt)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None

    def resolved_storage_path(self) -> str:
        from ray_tpu_torch.train._internal.checkpoint_util import (
            is_remote_path,
            normalize_local_path,
        )

        base = self.storage_path or os.path.expanduser("~/ray_tpu_results")
        if is_remote_path(base):
            raise ValueError(
                f"RunConfig(storage_path={base!r}): remote storage (fsspec) "
                "is not ported to ray_tpu_torch; use a local path")
        return os.path.abspath(normalize_local_path(base))
