"""ray_tpu_torch.util — placement groups, scheduling strategies, actor pool, queue,
collectives, metrics (reference: python/ray/util/)."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_placement_group,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.queue import Queue
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "ActorPool",
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "get_placement_group",
    "Queue",
    "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
]
