"""Resource accounting primitives.

TPU-native rebuild of the reference's scheduling data model
(reference: src/ray/common/scheduling/resource_set.h:33 ResourceSet,
:143 NodeResourceSet, scheduling_ids.h:33-44 predefined resources,
fixed_point.h FixedPoint arithmetic).

Quantities are stored as integers in units of 1/10000 (the reference's
FixedPoint uses the same resolution) so fractional resources never drift.
``TPU`` is a predefined resource alongside CPU/memory — the central design
change from the reference, where accelerators are generic custom resources
with GPU special-cases in the policy layer.
"""

from __future__ import annotations

from typing import Dict, ItemsView, Iterable, Mapping, Optional

PRECISION = 10000

CPU = "CPU"
TPU = "TPU"
GPU = "GPU"  # accepted for API compatibility; no special-casing anywhere
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"

PREDEFINED = (CPU, TPU, GPU, MEMORY, OBJECT_STORE_MEMORY)

# Resources that represent individually addressable units (chip ids); the
# raylet hands out instance indices for these at lease time so the worker can
# carve its visible-device env (reference: _raylet.pyx:2176-2182).
UNIT_INSTANCE_RESOURCES = (TPU, GPU)


def _fp(v: float) -> int:
    return round(v * PRECISION)


class ResourceSet:
    """A demand or capacity: {resource_name: fixed-point quantity}."""

    __slots__ = ("_res",)

    def __init__(self, mapping: Optional[Mapping[str, float]] = None, _raw: Optional[Dict[str, int]] = None):
        if _raw is not None:
            self._res = {k: v for k, v in _raw.items() if v != 0}
        else:
            self._res = {k: _fp(v) for k, v in (mapping or {}).items() if _fp(v) != 0}

    @classmethod
    def from_raw(cls, raw: Dict[str, int]) -> "ResourceSet":
        return cls(_raw=raw)

    def get(self, name: str) -> float:
        return self._res.get(name, 0) / PRECISION

    def get_raw(self, name: str) -> int:
        return self._res.get(name, 0)

    def names(self):
        return self._res.keys()

    def items(self) -> ItemsView[str, int]:
        return self._res.items()

    def to_dict(self) -> Dict[str, float]:
        return {k: v / PRECISION for k, v in self._res.items()}

    def is_empty(self) -> bool:
        return not self._res

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other._res.get(k, 0) >= v for k, v in self._res.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._res)
        for k, v in other._res.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet.from_raw(out)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._res)
        for k, v in other._res.items():
            out[k] = out.get(k, 0) - v
        return ResourceSet.from_raw(out)

    def clamped_nonnegative(self) -> "ResourceSet":
        return ResourceSet.from_raw({k: max(v, 0) for k, v in self._res.items()})

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._res == other._res

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"

    def __reduce__(self):
        return (ResourceSet.from_raw, (dict(self._res),))


class NodeResources:
    """Total + available capacity of one node, plus labels.

    reference: NodeResourceSet (resource_set.h:143) + node labels
    (label_selector.h).  Unit-instance resources additionally track which
    instance ids (chip indices) are free, so TPU chips are allocated in
    ICI-topology-aligned blocks (tpu.py:16 TPU_VALID_CHIP_OPTIONS).
    """

    def __init__(self, total: ResourceSet, labels: Optional[Dict[str, str]] = None):
        self.total = total
        self.available = ResourceSet.from_raw(dict(total.items()))
        self.labels = dict(labels or {})
        # unit resources: the fixed-point capacity left on each instance, so
        # fractional demands (num_gpus=0.5) share one instance id
        self.instance_avail: Dict[str, list] = {}
        for name in UNIT_INSTANCE_RESOURCES:
            n = int(total.get(name))
            if n:
                self.instance_avail[name] = [PRECISION] * n

    def feasible(self, demand: ResourceSet) -> bool:
        return demand.is_subset_of(self.total)

    def can_allocate(self, demand: ResourceSet) -> bool:
        return demand.is_subset_of(self.available)

    def allocate(self, demand: ResourceSet) -> Optional[Dict[str, list]]:
        """Deduct; returns {unit_resource: [instance ids]} or None."""
        if not self.can_allocate(demand):
            return None
        instances: Dict[str, list] = {}
        for name in UNIT_INSTANCE_RESOURCES:
            want = demand.get_raw(name)
            if want:
                avail = self.instance_avail.get(name, [])
                if want < PRECISION:  # a share of one instance: first fit
                    ids = [i for i, a in enumerate(avail) if a >= want][:1]
                    need = 1
                else:
                    need = want // PRECISION
                    ids = [i for i, a in enumerate(avail) if a == PRECISION][:need]
                if len(ids) < need:
                    return None
                instances[name] = ids
        for name, ids in instances.items():
            share = min(demand.get_raw(name), PRECISION)
            for i in ids:
                self.instance_avail[name][i] -= share
        self.available = self.available - demand
        return instances

    def release(self, demand: ResourceSet, instances: Optional[Dict[str, list]] = None):
        self.available = self.available + demand
        # Clamp against total (defensive; double-release is a bug upstream).
        for k, v in list(self.available.items()):
            if v > self.total.get_raw(k):
                self.available._res[k] = self.total.get_raw(k)
        for name, ids in (instances or {}).items():
            share = min(demand.get_raw(name), PRECISION)
            avail = self.instance_avail.get(name, [])
            for i in ids:
                if i < len(avail):
                    avail[i] = min(avail[i] + share, PRECISION)

    def utilization(self) -> float:
        """max over resources of fraction-used; the hybrid policy's score
        (reference: hybrid_scheduling_policy.h:29-49)."""
        best = 0.0
        for k, total in self.total.items():
            if total <= 0:
                continue
            used = total - self.available.get_raw(k)
            best = max(best, used / total)
        return best

    def matches_labels(self, selector: Optional[Dict[str, str]]) -> bool:
        if not selector:
            return True
        return all(self.labels.get(k) == v for k, v in selector.items())

    def snapshot(self) -> dict:
        return {
            "total": self.total.to_dict(),
            "available": self.available.to_dict(),
            "labels": dict(self.labels),
        }
