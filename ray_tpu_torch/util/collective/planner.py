"""Topology-aware collective planner (TACCL-flavored, arxiv 2111.04867),
a copy of the JAX package's over an explicit topology descriptor:

- :class:`Topology` records the per-rank latency-domain (host) ids and the
  link classes + α-β figures of the intra- and inter-domain links.
  Backends build it from real metadata (group-member node identity in
  ``NCCLGroup`` and ``StoreGroup``; the intra-node class of a group of
  cards is their NVLink/IPC link) and refine the β terms with a one-shot link probe at
  group init, cached per group and refreshed on membership change.
- :func:`plan_allreduce` selects among ring / recursive-halving-doubling
  (tree) / 3-phase hierarchical / flat per (message size, world, link
  class) using the α-β cost model — the TACCL observation that the right
  schedule follows topology and message size, not a fixed hierarchy.
- :func:`plan_explain` is the debug surface: the candidate cost table, the
  winner, and the reason, for operators asking "why did it pick that".

Every decision is cached (plans are pure functions of hashable inputs) so
the hot-path cost of a repeated decision is one dict hit — budget-gated
under 5µs by test_perf_smoke.  Decisions are counted into
``ray_tpu_collective_plan_total{algorithm,reason}`` by the backends (only
when a compression spec is in force: the stock path books nothing, keeping
compression-off metric output byte-identical).

The slice-alignment rule: hierarchical schedules
group ranks into contiguous blocks, so they are only legal when the
topology's domains ARE contiguous equal-size rank blocks.  When they are
not (uneven slices, interleaved placement), the planner REFUSES the
hierarchy with reason ``unaligned_slices`` instead of silently running the
"intra" phase over DCN.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# link classes, fastest to slowest
LINK_NVLINK = "nvlink"  # cards of one host: NVLink, or CUDA IPC on one card
LINK_ICI = "ici"    # intra-slice TPU interconnect
LINK_DCN = "dcn"    # inter-slice / inter-host datacenter network
LINK_HOST = "host"  # host loopback / store-actor relay (CPU test clusters)

# default α (per-message-step latency, seconds) and β⁻¹ (bandwidth,
# bytes/s) seeds per link class — deliberately coarse priors: ratios, not
# measurements of any card or network (none was taken for them); the
# per-group probe replaces the bandwidth with a measured figure.  Ratios
# are what matter: the fast intra-node link is ~10x DCN bandwidth at ~10x
# lower launch latency, and the store relay pays an actor round trip per
# step.  NVLink takes ICI's priors.
DEFAULT_ALPHA = {LINK_NVLINK: 1e-6, LINK_ICI: 1e-6, LINK_DCN: 2.5e-5,
                 LINK_HOST: 4e-4}
DEFAULT_BANDWIDTH = {LINK_NVLINK: 4.0e10, LINK_ICI: 4.0e10, LINK_DCN: 3.0e9,
                     LINK_HOST: 1.0e9}

# recursive halving-doubling exchanges non-neighbor pairs, which share
# physical links on a torus/fat-tree: its bandwidth term pays a contention
# factor relative to the neighbor-only ring (the standard reason NCCL
# prefers rings at large sizes and trees at small ones)
TREE_CONTENTION = 2.0


def _default_alpha(link: str) -> float:
    return DEFAULT_ALPHA.get(link, DEFAULT_ALPHA[LINK_HOST])


def _default_bw(link: str) -> float:
    return DEFAULT_BANDWIDTH.get(link, DEFAULT_BANDWIDTH[LINK_HOST])


@dataclasses.dataclass(frozen=True)
class Topology:
    """Explicit collective topology: who sits where, over which links.

    slice_ids:  per-rank latency-domain id (TPU slice index, or host/node
                identity for the store backend), length == world_size.
    intra_link / inter_link: link class names (for explain/metrics).
    intra_bw / inter_bw: measured or default bandwidth, bytes/s.
    intra_alpha / inter_alpha: per-step launch latency, seconds.
    version:    bumped on membership change — plan caches key on it, so a
                refreshed probe invalidates stale decisions.
    """

    world_size: int
    slice_ids: Tuple[int, ...] = ()
    intra_link: str = LINK_HOST
    inter_link: str = LINK_DCN
    intra_bw: float = DEFAULT_BANDWIDTH[LINK_HOST]
    inter_bw: float = DEFAULT_BANDWIDTH[LINK_DCN]
    intra_alpha: float = DEFAULT_ALPHA[LINK_HOST]
    inter_alpha: float = DEFAULT_ALPHA[LINK_DCN]
    version: int = 0

    def __post_init__(self):
        if self.slice_ids and len(self.slice_ids) != self.world_size:
            raise ValueError(
                f"slice_ids length {len(self.slice_ids)} != world_size "
                f"{self.world_size}")

    @classmethod
    def flat(cls, world_size: int, link: str = LINK_HOST, **kw) -> "Topology":
        """Single latency domain (one slice / one host / CPU tests)."""
        kw.setdefault("intra_link", link)
        kw.setdefault("intra_bw", _default_bw(link))
        kw.setdefault("intra_alpha", _default_alpha(link))
        return cls(world_size=world_size,
                   slice_ids=tuple([0] * world_size), **kw)

    @classmethod
    def from_slice_ids(cls, slice_ids, intra_link: str = LINK_ICI,
                       inter_link: str = LINK_DCN, **kw) -> "Topology":
        """Real topology from per-rank domain ids (device slice_index /
        member node identity), normalized to small ints in first-seen
        order so equal layouts hash equal."""
        seen: Dict[object, int] = {}
        norm = []
        for s in slice_ids:
            if s not in seen:
                seen[s] = len(seen)
            norm.append(seen[s])
        kw.setdefault("intra_bw", _default_bw(intra_link))
        kw.setdefault("inter_bw", _default_bw(inter_link))
        kw.setdefault("intra_alpha", _default_alpha(intra_link))
        kw.setdefault("inter_alpha", _default_alpha(inter_link))
        return cls(world_size=len(norm), slice_ids=tuple(norm),
                   intra_link=intra_link, inter_link=inter_link, **kw)

    @property
    def num_slices(self) -> int:
        return len(set(self.slice_ids)) if self.slice_ids else 1

    def slice_groups(self) -> Dict[int, Tuple[int, ...]]:
        """domain id -> ranks in that domain."""
        groups: Dict[int, list] = {}
        for rank, sid in enumerate(self.slice_ids):
            groups.setdefault(sid, []).append(rank)
        return {sid: tuple(rs) for sid, rs in groups.items()}

    def aligned_slice_size(self) -> Optional[int]:
        """Members per slice IF the domains form contiguous equal-size rank
        blocks (the layout every hierarchical schedule assumes: rank r is
        member r%ss of slice r//ss).  None when they don't — the caller
        must refuse the hierarchy rather than run an "intra" phase across
        a real domain boundary."""
        if not self.slice_ids or self.num_slices <= 1:
            return None
        if self.world_size % self.num_slices != 0:
            return None
        ss = self.world_size // self.num_slices
        for rank, sid in enumerate(self.slice_ids):
            if sid != self.slice_ids[(rank // ss) * ss]:
                return None
            if rank % ss and sid != self.slice_ids[rank - 1]:
                return None
        return ss

    def slice_aligned(self, slice_size: int) -> bool:
        """True when partitioning ranks into contiguous ``slice_size``
        blocks never puts two domains inside one block.  A single-domain
        topology is aligned for ANY valid partition (there is no boundary
        to violate — explicit slice_size hierarchies on one host stay
        legal, as before)."""
        if slice_size <= 0 or self.world_size % slice_size:
            return False
        if self.num_slices <= 1:
            return True
        for start in range(0, self.world_size, slice_size):
            block = self.slice_ids[start:start + slice_size]
            if len(set(block)) != 1:
                return False
        return True


def topology_for_devices(devices, intra_link: Optional[str] = None) -> Topology:
    """Topology for a group of torch devices (``torch.device`` or their
    names) — e.g. the cards of one tensor-parallel serving engine.  One
    process sees the cards of one host, so they form one latency domain;
    the intra link is NVLink when every member is a CUDA device and host
    loopback otherwise (CPU tests), so the α-β model prices decode's small
    latency-bound collectives on the link class they actually cross."""
    import torch

    devs = [torch.device(d) for d in devices]
    if intra_link is None:
        intra_link = (LINK_NVLINK if devs and all(
            d.type == "cuda" for d in devs) else LINK_HOST)
    sids = [0] * len(devs)
    return Topology.from_slice_ids(sids or (0,), intra_link=intra_link)


# ---------------------------------------------------------------------------
# α-β cost model.  t(algorithm) = steps·α + bytes_on_slowest_link·β.  The
# model only needs to ORDER the candidates correctly per regime; absolute
# seconds are not a promise (plan_explain labels them "modeled").
# ---------------------------------------------------------------------------


def _cost_flat(nbytes: int, t: Topology) -> float:
    """Direct exchange / single fused op: one step, every rank receives
    (n-1) payloads over its link (the store full-gather shape; XLA's stock
    psum is better than this, but flat is only ever chosen when the
    message is too small for decomposition to pay)."""
    n = t.world_size
    alpha, bw = _slowest(t)
    return alpha + (n - 1) * nbytes / bw


def _cost_ring(nbytes: int, t: Topology) -> float:
    """Bandwidth-optimal ring (reduce-scatter + allgather): 2(n-1) steps,
    2(n-1)/n · S per link."""
    n = t.world_size
    alpha, bw = _slowest(t)
    return 2 * (n - 1) * alpha + 2 * (n - 1) / n * nbytes / bw


def _cost_tree(nbytes: int, t: Topology) -> float:
    """Recursive halving-doubling: 2·log2(n) steps at ring-equal volume,
    but non-neighbor pairs pay the contention factor.  Infinite for
    non-power-of-two worlds (the schedule needs clean halving)."""
    n = t.world_size
    if n & (n - 1):
        return float("inf")
    alpha, bw = _slowest(t)
    log2n = n.bit_length() - 1
    return (2 * log2n * alpha
            + TREE_CONTENTION * 2 * (n - 1) / n * nbytes / bw)


def _cost_hierarchical(nbytes: int, t: Topology, slice_size: int) -> float:
    """3-phase: intra reduce-scatter + allgather (ring-shaped, fast link)
    and the 1/slice_size shard exchanged across domains (slow link)."""
    n = t.world_size
    ss = max(slice_size, 1)
    nslices = n // ss
    shard = nbytes / ss
    intra = (2 * (ss - 1) * t.intra_alpha
             + 2 * (ss - 1) / max(ss, 1) * nbytes / t.intra_bw)
    inter = (t.inter_alpha
             + (nslices - 1) / max(nslices, 1) * shard * 2 / t.inter_bw)
    return intra + inter


def _slowest(t: Topology) -> Tuple[float, float]:
    """(α, bw) of the slowest link the group spans — what a non-topology-
    aware (flat/ring/tree over all ranks) schedule is bound by."""
    if t.num_slices > 1:
        return (max(t.intra_alpha, t.inter_alpha),
                min(t.intra_bw, t.inter_bw))
    return t.intra_alpha, t.intra_bw


_COSTS = {
    "flat": _cost_flat,
    "ring": _cost_ring,
    "tree": _cost_tree,
}


# ---------------------------------------------------------------------------
# Planner proper
# ---------------------------------------------------------------------------

# decision cache: plans are pure in (nbytes, world, topology, spec,
# allowed); topology.version folds membership/probe refreshes into the key
_PLAN_CACHE: Dict[Tuple, object] = {}
_PLAN_CACHE_MAX = 4096


def _resolve_hierarchy(topology: Topology, spec) -> Tuple[int, str]:
    """(slice_size, reason): slice_size <= 1 means the hierarchy is
    refused, with the reason naming why (counted into the plan metric)."""
    world = topology.world_size
    want = spec.slice_size
    if want is not None:
        if not (1 < want < world) or world % want:
            return 1, "invalid_slice_size"
        if not topology.slice_aligned(want):
            return 1, "unaligned_slices"
        return want, "explicit_slice_size"
    ss = topology.aligned_slice_size()
    if ss is None:
        if topology.num_slices > 1:
            # a real multi-domain topology whose domains are uneven or
            # interleaved: the old sqrt fallback would happily group
            # ranks across the boundary and run "ICI" phases over DCN
            return 1, "unaligned_slices"
        return 1, "single_slice"
    if ss <= 1 or ss >= world:
        return 1, "degenerate_slices"
    return ss, "dcn_boundary"


def plan_allreduce(nbytes: int, topology: Topology, spec, *,
                   allowed: Optional[Tuple[str, ...]] = None):
    """The planner: one Plan per (message size, topology, spec).

    ``allowed`` names the algorithms the calling backend implements
    (default: all).  Returns a :class:`compression.Plan` whose ``reason``
    explains the decision; ``plan.is_stock`` keeps its meaning (take
    the exact pre-compression code path).
    """
    from ray_tpu_torch.util.collective import compression as comp

    key = (nbytes, topology, spec, allowed)
    try:
        hit = _PLAN_CACHE.get(key)
    except TypeError:  # unhashable caller-supplied spec subclass — plan raw
        hit = None
        key = None
    if hit is not None:
        return hit
    plan = _plan_uncached(nbytes, topology, spec, allowed, comp)
    if key is not None:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.clear()
        _PLAN_CACHE[key] = plan
    return plan


def _plan_uncached(nbytes, topology, spec, allowed, comp):
    def stock(reason):
        return dataclasses.replace(comp._STOCK_PLAN, reason=reason)

    if spec is None:
        return stock("no_spec")
    if topology.world_size <= 1:
        return stock("solo")
    if nbytes < spec.min_bytes:
        return stock("below_min_bytes")
    if allowed is None:
        allowed = (comp.ALG_FLAT, comp.ALG_RING, comp.ALG_TREE,
                   comp.ALG_HIERARCHICAL)
    scheme = spec.scheme

    # -- hierarchy resolution (topology-gated, never a divisor guess) ------
    hier = spec.hierarchical
    refusal = ""
    slice_size = 1
    if hier is None:
        hier = topology.num_slices > 1 or spec.slice_size is not None
    elif hier is False and scheme == comp.SCHEME_NONE:
        # resolve_spec("none"): scheme none + hierarchical False is the
        # documented force-stock escape hatch — no codec, no algorithm
        # planning, byte-identical to compression-off.  (scheme none with
        # hierarchical=None still gets ring/tree planning below.)
        return stock("forced_stock")
    if hier:
        slice_size, why = _resolve_hierarchy(topology, spec)
        if slice_size <= 1:
            hier = False
            refusal = why
    if hier and comp.ALG_HIERARCHICAL in allowed:
        return comp.Plan(comp.ALG_HIERARCHICAL, scheme, slice_size, spec,
                         reason=("explicit_slice_size"
                                 if spec.slice_size is not None
                                 else "dcn_boundary"))

    # -- flat-topology (or hierarchy-refused) algorithm choice -------------
    if scheme == comp.SCHEME_INT8:
        # the EQuARX two-phase program IS the bandwidth-optimal quantized
        # schedule (all_to_all + all_gather ≈ ring volume at 1/4 bytes);
        # there is no quantized ring/tree variant to trade against
        return comp.Plan(comp.ALG_FLAT, scheme, 1, spec,
                         reason=refusal or "quantized_two_phase")
    costs = {alg: fn(nbytes, topology) for alg, fn in _COSTS.items()
             if alg in allowed}
    if not costs:
        return stock(refusal or "no_algorithm")
    best = min(costs, key=costs.get)
    if best == comp.ALG_FLAT:
        return stock(refusal or "latency_bound")
    reason = refusal or (
        "latency_bound" if best == comp.ALG_TREE else "bandwidth_bound")
    return comp.Plan(best, comp.SCHEME_NONE, 1, spec, reason=reason)


def plan_explain(nbytes: int, topology: Topology, spec, *,
                 allowed: Optional[Tuple[str, ...]] = None) -> dict:
    """Debug surface: the full candidate table behind one decision.

    Returns {chosen, reason, scheme, slice_size, topology:{...},
    modeled_cost_s:{algorithm: seconds}} — costs are the α-β model's
    ordering device, not a latency promise.
    """
    from ray_tpu_torch.util.collective import compression as comp

    plan = plan_allreduce(nbytes, topology, spec, allowed=allowed)
    costs = {alg: fn(nbytes, topology) for alg, fn in _COSTS.items()}
    ss = topology.aligned_slice_size()
    if ss:
        costs[comp.ALG_HIERARCHICAL] = _cost_hierarchical(nbytes, topology, ss)
    return {
        "nbytes": int(nbytes),
        "chosen": plan.algorithm,
        "scheme": plan.scheme,
        "slice_size": plan.slice_size,
        "reason": plan.reason,
        "is_stock": plan.is_stock,
        "topology": {
            "world_size": topology.world_size,
            "num_slices": topology.num_slices,
            "aligned_slice_size": ss,
            "intra_link": topology.intra_link,
            "inter_link": topology.inter_link,
            "intra_bw_gbps": round(topology.intra_bw / 1e9, 3),
            "inter_bw_gbps": round(topology.inter_bw / 1e9, 3),
            "version": topology.version,
        },
        "modeled_cost_s": {a: (None if c == float("inf") else round(c, 9))
                           for a, c in sorted(costs.items())},
    }


def record_plan(algorithm: str, reason: str) -> None:
    """Book one plan decision (backends call this only when a compression
    spec is in force — the stock no-spec path must book nothing)."""
    try:
        from ray_tpu_torch._private import runtime_metrics

        runtime_metrics.inc_collective_plan(algorithm, reason)
    except Exception:  # noqa: BLE001 — telemetry must never fail an op
        pass
