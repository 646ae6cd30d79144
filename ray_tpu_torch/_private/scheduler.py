"""Cluster-level node selection.

TPU-native rebuild of the reference's distributed scheduler
(reference: src/ray/raylet/scheduling/cluster_resource_scheduler.h:45,
policy/hybrid_scheduling_policy.h:29-49 for the scoring algorithm,
policy/spread_scheduling_policy.cc, policy/node_affinity_scheduling_policy.cc,
policy/bundle_scheduling_policy.cc for placement-group bundles).

Every raylet and the GCS each hold a ``ClusterResourceScheduler`` fed by the
resource-gossip plane (syncer), so scheduling decisions are local and
spillback-based exactly like the reference.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.config import global_config
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.resources import NodeResources, ResourceSet

_SCHED_LIB_CACHE: list = []


def _sched_lib():
    """Native hybrid scorer, loaded once; None -> pure-Python fallback.
    Gated by the enable_native_scheduler config field so the toggle
    distributes cluster-wide via the config blob like every other knob."""
    if not global_config().enable_native_scheduler:
        return None
    if not _SCHED_LIB_CACHE:
        from ray_tpu_torch._native import load_sched_policy

        _SCHED_LIB_CACHE.append(load_sched_policy())
    return _SCHED_LIB_CACHE[0]


@dataclass
class SchedulingStrategy:
    """Normalized scheduling strategy carried in a TaskSpec.

    kind: "default" (hybrid) | "spread" | "node_affinity" | "placement_group"
          | "node_label"
    """

    kind: str = "default"
    node_id: Optional[NodeID] = None          # node_affinity
    soft: bool = False                        # node_affinity
    placement_group_id: object = None         # placement_group
    bundle_index: int = -1                    # placement_group
    labels: Optional[Dict[str, str]] = None   # node_label (hard constraints)


class ClusterResourceScheduler:
    """Holds a view of every node's resources; picks the best node.

    The hybrid policy (reference: hybrid_scheduling_policy.h:29-49):
    prefer the local node if it can run the task now; otherwise score
    candidate nodes by max-resource-utilization, classify into
    below/above ``spread_threshold``, pick randomly among the top-k
    lowest-scoring feasible nodes (k = max(top_k_absolute,
    top_k_fraction * num_nodes)).
    """

    def __init__(self, local_node_id: Optional[NodeID] = None):
        self.local_node_id = local_node_id
        self.nodes: Dict[NodeID, NodeResources] = {}
        # nodes announced as DRAINING (preemption / maintenance): still in
        # the view (running leases keep their resources booked) but excluded
        # from every placement decision — new work must land on survivors
        self._draining: set = set()
        # guards the nodes MAP (RPC threads add/remove while the scheduling
        # thread iterates — dict-size-changed races otherwise); the
        # NodeResources values stay mutable-in-place (GIL-atomic swaps)
        self._nodes_lock = threading.Lock()
        self._rng = random.Random(0xA11CE)

    # -- view maintenance --------------------------------------------------

    def add_or_update_node(self, node_id: NodeID, resources: NodeResources):
        with self._nodes_lock:
            self.nodes[node_id] = resources

    def update_available(self, node_id: NodeID, available: Dict[str, float]):
        with self._nodes_lock:
            node = self.nodes.get(node_id)
        if node is not None:
            node.available = ResourceSet(available)

    def remove_node(self, node_id: NodeID):
        with self._nodes_lock:
            self.nodes.pop(node_id, None)
            self._draining.discard(node_id)

    def set_draining(self, node_id: NodeID, draining: bool = True):
        with self._nodes_lock:
            if draining:
                self._draining.add(node_id)
            else:
                self._draining.discard(node_id)

    def is_draining(self, node_id: NodeID) -> bool:
        with self._nodes_lock:
            return node_id in self._draining

    def _nodes_snapshot(self) -> Dict[NodeID, NodeResources]:
        with self._nodes_lock:
            return {nid: n for nid, n in self.nodes.items()
                    if nid not in self._draining}

    # -- selection ---------------------------------------------------------

    def get_best_schedulable_node(
        self,
        demand: ResourceSet,
        strategy: Optional[SchedulingStrategy] = None,
        prefer_node: Optional[NodeID] = None,
        requires_available: bool = True,
    ) -> Optional[NodeID]:
        strategy = strategy or SchedulingStrategy()
        if strategy.kind == "node_affinity":
            with self._nodes_lock:
                node = self.nodes.get(strategy.node_id)
                if strategy.node_id in self._draining:
                    node = None  # a draining node takes no new work
            if node is not None and node.feasible(demand):
                if not requires_available or node.can_allocate(demand):
                    return strategy.node_id
                if strategy.soft:
                    pass  # fall through to hybrid
                else:
                    return strategy.node_id  # queue there anyway (hard affinity)
            if not strategy.soft:
                return None
        candidates = self._feasible(demand, strategy.labels)
        if not candidates:
            return None
        if strategy.kind == "spread":
            return self._spread(candidates, demand)
        return self._hybrid(candidates, demand, prefer_node or self.local_node_id)

    def _feasible(self, demand: ResourceSet, labels) -> List[Tuple[NodeID, NodeResources]]:
        return [
            (nid, n)
            for nid, n in self._nodes_snapshot().items()
            if n.feasible(demand) and n.matches_labels(labels)
        ]

    # below this node count the ctypes marshalling costs more than the
    # Python sort it replaces; the native scorer pays off on big clusters
    _NATIVE_MIN_NODES = 64

    def _hybrid(self, candidates, demand, prefer_node) -> Optional[NodeID]:
        cfg = global_config()
        native = _sched_lib() if len(candidates) >= self._NATIVE_MIN_NODES else None
        if native is not None:
            return self._hybrid_native(native, cfg, candidates, demand, prefer_node)
        # Local-first: if the preferred node can run it right now, take it.
        for nid, n in candidates:
            if nid == prefer_node and n.can_allocate(demand):
                return nid
        available = [(nid, n) for nid, n in candidates if n.can_allocate(demand)]
        pool = available or candidates  # queue on a feasible node if none free
        scored = sorted(pool, key=lambda kv: (kv[1].utilization(), kv[0].hex()))
        k = max(cfg.scheduler_top_k_absolute, int(len(scored) * cfg.scheduler_top_k_fraction))
        top = scored[: max(k, 1)]
        return self._rng.choice(top)[0]

    def _hybrid_native(self, lib, cfg, candidates, demand, prefer_node) -> Optional[NodeID]:
        """Native top-k scorer (ray_tpu_torch/_native/sched_policy.cc); candidates
        are already feasibility+label filtered, so feasible[i] is all-ones."""
        import ctypes

        n = len(candidates)
        feasible = (ctypes.c_ubyte * n)(*([1] * n))
        can_alloc = (ctypes.c_ubyte * n)(
            *[1 if node.can_allocate(demand) else 0 for _, node in candidates])
        util = (ctypes.c_double * n)(
            *[node.utilization() for _, node in candidates])
        prefer_idx = -1
        if prefer_node is not None:
            for i, (nid, _) in enumerate(candidates):
                if nid == prefer_node:
                    prefer_idx = i
                    break
        choice = lib.hybrid_choose(
            feasible, can_alloc, util, n, prefer_idx,
            cfg.scheduler_top_k_absolute, cfg.scheduler_top_k_fraction,
            self._rng.getrandbits(63))
        return candidates[choice][0] if choice >= 0 else None

    def get_best_schedulable_nodes(
        self,
        demand: ResourceSet,
        strategy: Optional[SchedulingStrategy] = None,
        count: int = 1,
        prefer_node: Optional[NodeID] = None,
    ) -> List[NodeID]:
        """Batch placement for batched lease requests: up to ``count`` node
        picks for identical ``demand`` units, scored against ONE snapshot
        with capacity decremented per pick (so a batch doesn't pile onto a
        node that only fits one unit).  Returns fewer than ``count`` when
        capacity runs out — and an empty list only when the demand is
        infeasible everywhere (callers keep it queued, like the single-node
        path)."""
        strategy = strategy or SchedulingStrategy()
        if count <= 1 or strategy.kind == "node_affinity":
            nid = self.get_best_schedulable_node(demand, strategy,
                                                 prefer_node=prefer_node)
            return [nid] if nid is not None else []
        prefer_node = prefer_node or self.local_node_id
        scratch = {
            nid: _MutableNode(n)
            for nid, n in self._nodes_snapshot().items()
            if n.feasible(demand) and n.matches_labels(strategy.labels)
        }
        if not scratch:
            return []
        picks: List[NodeID] = []
        pick_counts: Dict[NodeID, int] = {}
        spread = strategy.kind == "spread"
        for _ in range(count):
            if (not spread and prefer_node in scratch
                    and scratch[prefer_node].try_one(demand)):
                picks.append(prefer_node)
                pick_counts[prefer_node] = pick_counts.get(prefer_node, 0) + 1
                continue
            fitting = [(nid, mn) for nid, mn in scratch.items()
                       if demand.is_subset_of(mn.remaining)]
            if not fitting:
                break
            if spread:
                # spread semantics must hold WITHIN the batch too: rank by
                # how many units this batch already put on the node first
                nid, mn = min(fitting, key=lambda kv: (
                    pick_counts.get(kv[0], 0), kv[1].node.utilization(),
                    kv[0].hex()))
            else:
                nid, mn = min(fitting, key=lambda kv: (
                    kv[1].node.utilization(), kv[0].hex()))
            mn.try_one(demand)
            picks.append(nid)
            pick_counts[nid] = pick_counts.get(nid, 0) + 1
        if not picks:
            # nothing can run NOW but the shape is feasible: queue one unit
            # on the least-utilized feasible node (hybrid-policy fallback)
            nid = self.get_best_schedulable_node(demand, strategy,
                                                 prefer_node=prefer_node)
            return [nid] if nid is not None else []
        return picks

    def _spread(self, candidates, demand) -> Optional[NodeID]:
        available = [(nid, n) for nid, n in candidates if n.can_allocate(demand)]
        pool = available or candidates
        scored = sorted(pool, key=lambda kv: (kv[1].utilization(), self._rng.random()))
        return scored[0][0]

    # -- placement-group bundle scheduling ---------------------------------
    # reference: bundle_scheduling_policy.cc; strategies from common.proto:1017-1026

    def schedule_bundles(
        self,
        bundles: Sequence[ResourceSet],
        strategy: str,
        slice_label: Optional[str] = None,
    ) -> Optional[List[NodeID]]:
        """Map each bundle to a node, or None if infeasible.

        STRICT_PACK: all on one node. STRICT_SPREAD: all distinct nodes.
        PACK: best-effort few nodes. SPREAD: best-effort distinct.

        TPU extension: if ``slice_label`` is set, only nodes whose
        ``ray.io/tpu-slice-name`` label equals it are candidates, so a gang
        lands on exactly one pod slice (SURVEY.md hard-part #2).
        """
        nodes = {
            nid: _MutableNode(n)
            for nid, n in self._nodes_snapshot().items()
            if slice_label is None or n.labels.get("ray.io/tpu-slice-name") == slice_label
        }
        if strategy == "STRICT_PACK":
            for nid, mn in sorted(nodes.items(), key=lambda kv: kv[1].node.utilization()):
                if mn.try_all(bundles):
                    return [nid] * len(bundles)
            return None
        if strategy in ("STRICT_SPREAD", "SPREAD"):
            placement = self._spread_bundles(nodes, bundles, strict=(strategy == "STRICT_SPREAD"))
            return placement
        # PACK: greedy first-fit-decreasing onto fewest nodes.
        order = sorted(range(len(bundles)), key=lambda i: -sum(v for _, v in bundles[i].items()))
        placement: List[Optional[NodeID]] = [None] * len(bundles)
        used_order: List[NodeID] = []
        for i in order:
            placed = False
            for nid in used_order:
                if nodes[nid].try_one(bundles[i]):
                    placement[i] = nid
                    placed = True
                    break
            if not placed:
                for nid, mn in sorted(nodes.items(), key=lambda kv: kv[1].node.utilization()):
                    if nid in used_order:
                        continue
                    if mn.try_one(bundles[i]):
                        placement[i] = nid
                        used_order.append(nid)
                        placed = True
                        break
            if not placed:
                return None
        return placement  # type: ignore[return-value]

    def _spread_bundles(self, nodes, bundles, strict: bool) -> Optional[List[NodeID]]:
        placement: List[Optional[NodeID]] = [None] * len(bundles)
        used = set()
        for i, b in enumerate(bundles):
            candidates = sorted(nodes.items(), key=lambda kv: (kv[0] in used, kv[1].node.utilization()))
            placed = False
            for nid, mn in candidates:
                if strict and nid in used:
                    continue
                if mn.try_one(b):
                    placement[i] = nid
                    used.add(nid)
                    placed = True
                    break
            if not placed:
                return None
        return placement  # type: ignore[return-value]


class _MutableNode:
    """Scratch capacity tracker used during bundle packing."""

    def __init__(self, node: NodeResources):
        self.node = node
        self.remaining = ResourceSet.from_raw(dict(node.available.items()))

    def try_one(self, demand: ResourceSet) -> bool:
        if demand.is_subset_of(self.remaining):
            self.remaining = self.remaining - demand
            return True
        return False

    def try_all(self, demands) -> bool:
        snapshot = ResourceSet.from_raw(dict(self.remaining.items()))
        for d in demands:
            if not self.try_one(d):
                self.remaining = snapshot
                return False
        return True
