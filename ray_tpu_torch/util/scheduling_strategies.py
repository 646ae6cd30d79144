"""User-facing scheduling strategies.

reference: python/ray/util/scheduling_strategies.py
(PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy,
NodeLabelSchedulingStrategy).
"""

from __future__ import annotations

from typing import Dict, Optional

from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.scheduler import SchedulingStrategy


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group, placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(
            kind="placement_group",
            placement_group_id=self.placement_group.id,
            bundle_index=self.placement_group_bundle_index,
        )


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id, soft: bool = False):
        self.node_id = node_id if isinstance(node_id, NodeID) else NodeID(node_id)
        self.soft = soft

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(kind="node_affinity", node_id=self.node_id, soft=self.soft)


class NodeLabelSchedulingStrategy:
    def __init__(self, hard: Optional[Dict[str, str]] = None, soft: Optional[Dict[str, str]] = None):
        self.hard = hard or {}
        self.soft = soft or {}

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(kind="node_label", labels=self.hard)
