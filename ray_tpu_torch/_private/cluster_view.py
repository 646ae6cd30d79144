"""Versioned cluster-view sync — the protocol shared by every view mirror.

TPU-native analog of the reference RaySyncer's versioned resource gossip
(reference: src/ray/common/ray_syncer/ray_syncer.h:40-74 — NodeState
carries a monotonic version; receivers apply only what changed).  The GCS
stamps a version on every node-state mutation and keeps a bounded
changelog; a reporter sends its ``known_version`` and receives one of:

- ``{"view_version": v}`` — nothing changed (the steady-state reply:
  constant size regardless of cluster size),
- ``{"view_version": v, "delta": {nid: snap}, "tombstones": [nid]}`` —
  only nodes touched since ``known_version``; removals arrive ONLY as
  explicit tombstones,
- ``{"view_version": v, "cluster_view": {nid: snap}}`` — a full snapshot
  (registration, version gap, changelog overflow); the receiver sweeps
  nodes absent from it.

The application logic lives here, in one place, because two mirrors use
it: the real ``Raylet`` (store backed by its ``ClusterResourceScheduler``)
and the mega-cluster harness's skeleton raylets (plain-dict store,
``_private/sim_cluster.py``) — convergence proofs in the harness exercise
the same protocol code the production raylet runs.

The cardinal rule encoded here: the remove-anything-unseen sweep fires on
FULL SNAPSHOTS ONLY.  A delta names the nodes it touched and nothing else;
sweeping on a delta would evict every quiet peer in the cluster.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence


class ViewStore:
    """What a cluster-view mirror must expose to ``apply_sync_reply``.

    ``upsert``/``remove`` must be idempotent; the caller holds whatever
    lock guards the underlying view for the whole apply call.
    """

    def upsert(self, node_id: Any, snap: Dict[str, Any]) -> None:
        raise NotImplementedError

    def remove(self, node_id: Any) -> None:
        raise NotImplementedError

    def ids(self) -> Iterable[Any]:
        raise NotImplementedError


class DictViewStore(ViewStore):
    """View mirror over a plain dict (skeleton raylets, tests)."""

    def __init__(self, view: Dict[Any, dict]):
        self.view = view

    def upsert(self, node_id, snap):
        self.view[node_id] = snap

    def remove(self, node_id):
        self.view.pop(node_id, None)

    def ids(self):
        return self.view.keys()


def apply_sync_reply(reply: dict, store: ViewStore, self_node_id,
                     current_version: int = -1) -> int:
    """Apply one sync reply to ``store``; returns the mirror's new version.

    Snapshot application replaces the view (upsert everything present,
    sweep everything absent).  Delta application touches ONLY the named
    nodes: upserts from ``delta``, removals from ``tombstones`` — the
    sweep must never fire here.  The reporter's own node is skipped in
    both directions (its local resources are authoritative locally).

    A reply with no version (an old GCS) resets the mirror to ``-1`` on a
    snapshot, so the next report asks for a full view again — the mixed-
    version cluster degrades to the pre-delta full-broadcast behavior.
    """
    version = reply.get("view_version")
    if "cluster_view" in reply:
        view = reply["cluster_view"]
        for nid, snap in view.items():
            if nid != self_node_id:
                store.upsert(nid, snap)
        for nid in list(store.ids()):
            if nid != self_node_id and nid not in view:
                store.remove(nid)
        return -1 if version is None else version
    delta = reply.get("delta")
    tombstones = reply.get("tombstones")
    if delta:
        for nid, snap in delta.items():
            if nid != self_node_id:
                store.upsert(nid, snap)
    if tombstones:
        for nid in tombstones:
            if nid != self_node_id:
                store.remove(nid)
    return current_version if version is None else version


def tree_partition(targets: Sequence, fanout: int) -> List[list]:
    """Split ``targets`` into at most ``fanout`` contiguous groups (sizes
    within one of each other).  Each group's head is the relay the sender
    pushes to; the rest of the group is that relay's subtree.  fanout <= 0
    means flat: every target is its own group (direct push, the A/B
    baseline)."""
    n = len(targets)
    if n == 0:
        return []
    k = max(1, min(fanout, n)) if fanout > 0 else n
    size, extra = divmod(n, k)
    groups, i = [], 0
    for g in range(k):
        step = size + (1 if g < extra else 0)
        if step:
            groups.append(list(targets[i:i + step]))
            i += step
    return groups
