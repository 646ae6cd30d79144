"""Placement groups: gang resource reservation.

reference: python/ray/util/placement_group.py (strategies :17-20, API
:146-164; 2-phase prepare/commit on raylets node_manager.cc:1761,1777).

TPU extension: ``placement_group(..., tpu_slice="name")`` restricts bundle
placement to hosts of one pod slice (label ``ray.io/tpu-slice-name``), making
the slice the gang-scheduling atom (SURVEY.md hard-part #2).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundle_specs = bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self):
        """ObjectRef that resolves to this PG once all bundles are reserved.

        reference parity (python/ray/util/placement_group.py:146-164):
        ``ray_tpu_torch.get(pg.ready())`` blocks until placement succeeds. Use
        :meth:`wait` for the boolean/polling form.
        """
        import ray_tpu_torch

        pg = self

        @ray_tpu_torch.remote(num_cpus=0)
        def _pg_ready():
            if not pg.wait():
                raise RuntimeError(
                    f"placement group {pg.id.hex()} was removed before "
                    "placement completed")
            return pg

        return _pg_ready.remote()

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        deadline = (None if timeout_seconds is None
                    else time.monotonic() + timeout_seconds)
        from ray_tpu_torch._private.worker import get_global_worker

        w = get_global_worker()
        while True:
            info = w.gcs.call("GetPlacementGroup", {"pg_id": self.id})
            if info is not None and info["state"] == "CREATED":
                return True
            if info is not None and info["state"] == "REMOVED":
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.02)

    def bundle_nodes(self):
        from ray_tpu_torch._private.worker import get_global_worker

        info = get_global_worker().gcs.call("GetPlacementGroup", {"pg_id": self.id})
        return info["bundle_nodes"] if info else []

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: Optional[str] = None,
    lifetime: Optional[str] = None,
    tpu_slice: Optional[str] = None,
) -> PlacementGroup:
    from ray_tpu_torch._private.worker import get_global_worker

    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    w = get_global_worker()
    pg_id = PlacementGroupID.random()
    w.gcs.call(
        "CreatePlacementGroup",
        {
            "pg_id": pg_id,
            "bundles": bundles,
            "strategy": strategy,
            "name": name,
            "lifetime": lifetime,
            "slice_label": tpu_slice,
        },
    )
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup):
    from ray_tpu_torch._private.worker import get_global_worker

    get_global_worker().gcs.call("RemovePlacementGroup", {"pg_id": pg.id})


def get_placement_group(name: str) -> Optional[PlacementGroup]:
    from ray_tpu_torch._private.worker import get_global_worker

    info = get_global_worker().gcs.call("GetNamedPlacementGroup", {"name": name})
    if info is None:
        return None
    return PlacementGroup(info["pg_id"], info["bundles"])
