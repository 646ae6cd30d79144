"""Named store actor used for collective rendezvous + the STORE data plane.

reference: python/ray/util/collective/collective_group/nccl_collective_group.py:30-82
(Rendezvous via a named store actor holding the NCCLUniqueID; store name from
const.py get_store_name). Here the same pattern serves (a) publishing the
jax.distributed coordinator address for the XLA backend, and (b) the full
data plane for the STORE backend.

Prompt abort (preemption-aware fault tolerance): group members register
their identity (actor id + node id) on join; a background monitor inside
the store actor polls the GCS and, when a member dies or its node starts
DRAINING, poisons the group — every blocked ``store_wait`` (and every write)
sees the abort sentinel within seconds and raises ``CollectiveAbortError``
instead of hanging to the stock timeout.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.util.collective.types import CollectiveAbortError

logger = logging.getLogger(__name__)

STORE_ACTOR_NAME = "_ray_tpu_collective_store"

# sentinel value store methods return for a poisoned group — store_wait and
# the write-side helpers turn it into a CollectiveAbortError at the caller
ABORT_SENTINEL = "__ray_tpu_collective_abort__"


def is_abort(value) -> bool:
    return (isinstance(value, tuple) and len(value) == 2
            and value[0] == ABORT_SENTINEL)


class _CollectiveStoreActor:
    """KV + barrier + gather primitives, garbage-collected by read counts."""

    def __init__(self):
        self._kv: Dict[Any, Any] = {}
        self._gathers: Dict[Tuple, Dict[int, Any]] = {}
        self._gather_reads: Dict[Tuple, set] = {}
        self._barriers: Dict[Tuple, set] = {}
        self._barrier_reads: Dict[Tuple, set] = {}
        self._groups: Dict[str, dict] = {}
        # group_name -> abort reason (poisoned until re-declared)
        self._aborts: Dict[str, str] = {}
        # group_name -> rank -> {"actor_id": hex|None, "node_id": hex|None}
        self._members: Dict[str, Dict[int, dict]] = {}
        self._monitor_started = False
        # -- per-member arrival monitor (hang & straggler diagnosis) -------
        # every collective round's key records who arrived when; a round
        # stuck with missing ranks is the hang signature, and completed
        # rounds feed a per-(group, rank) arrival-lag EWMA (persistent
        # stragglers score high).  Injectable clock for hermetic tests.
        self._clock = time.monotonic
        # key -> {"first": t, "by_rank": {rank: t}, "expected": int|None}
        self._arrivals: Dict[Tuple, dict] = {}
        self._lag_ewma: Dict[Tuple[str, int], float] = {}

    # -- arrival monitor ----------------------------------------------------
    def _stamp_arrival(self, key: Tuple, rank: int,
                       expected: Optional[int] = None,
                       expected_ranks=None):
        """``rank`` is always the member's GROUP-GLOBAL rank (subgroup
        rounds translate their subranks before stamping — lag EWMAs and
        blocking-member resolution are keyed by global rank).
        ``expected_ranks`` names the global ranks a subgroup round waits
        for; plain rounds use ``expected`` (a count over range(world))."""
        if not (isinstance(key, tuple) and len(key) >= 2):
            return
        now = self._clock()
        ent = self._arrivals.get(key)
        if ent is None:
            ent = self._arrivals[key] = {
                "first": now, "by_rank": {}, "expected": expected,
                "ranks": None}
        ent["by_rank"].setdefault(rank, now)
        if expected_ranks is not None:
            ent["ranks"] = list(expected_ranks)
            ent["expected"] = len(ent["ranks"])
        elif expected is not None:
            ent["expected"] = expected
        exp = ent["expected"]
        if exp is not None and len(ent["by_rank"]) >= exp:
            self._complete_round(key, ent)

    def _note_expected(self, key: Tuple, expected: int):
        """collect() polls carry the round's world size — a round whose
        contribute side never learned it (gather rounds) gets it from the
        first waiting reader, so missing ranks become computable."""
        ent = self._arrivals.get(key)
        if ent is not None and ent.get("expected") is None:
            ent["expected"] = expected
            if len(ent["by_rank"]) >= expected:
                self._complete_round(key, ent)

    def _complete_round(self, key: Tuple, ent: dict):
        """All members arrived: fold per-member lag (vs the round's first
        arrival) into the persistent straggler EWMA and drop the entry."""
        self._arrivals.pop(key, None)
        group = key[0]
        first = ent["first"]
        try:
            from ray_tpu_torch._private.config import global_config

            alpha = global_config().straggler_ewma_alpha
        except Exception:  # noqa: BLE001
            alpha = 0.2
        for rank, t in ent["by_rank"].items():
            lag = max(t - first, 0.0)
            k = (group, rank)
            prev = self._lag_ewma.get(k)
            ewma = lag if prev is None else (alpha * lag + (1 - alpha) * prev)
            self._lag_ewma[k] = ewma
            try:
                from ray_tpu_torch._private import runtime_metrics

                runtime_metrics.set_straggler_lag(group, rank, ewma)
            except Exception:  # noqa: BLE001 — lag gauge is telemetry; the monitor stays correct
                pass

    def straggler_report(self, group_name: Optional[str] = None) -> dict:
        """Live arrival view for ``state.diagnose()``: per group, the
        pending rounds (kind+seq, who arrived, who is missing, how long the
        round has waited) and the persistent per-rank arrival-lag EWMA.
        Missing ranks are resolved against the round's expected count when
        known, else the group's declared world size."""
        now = self._clock()
        groups: Dict[str, dict] = {}

        def _group_entry(g: str) -> dict:
            return groups.setdefault(g, {
                "pending": [],
                "lag_ewma_s": {},
                "members": dict(self._members.get(g, {})),
                "world_size": (self._groups.get(g) or {}).get("world_size"),
                "aborted": self._aborts.get(g),
            })

        for key, ent in list(self._arrivals.items()):
            g = key[0]
            if group_name is not None and g != group_name:
                continue
            d = _group_entry(g)
            expected = ent.get("expected") or d["world_size"]
            arrived = sorted(ent["by_rank"])
            ranks = ent.get("ranks")
            if ranks:  # subgroup round: members are named, not range()
                missing = sorted(set(ranks) - set(arrived))
            else:
                missing = (sorted(set(range(expected)) - set(arrived))
                           if expected else [])
            d["pending"].append({
                "op": key[1] if len(key) > 1 else "?",
                "seq": key[2] if len(key) > 2 else None,
                "waiting_s": round(now - ent["first"], 3),
                "arrived": arrived,
                "missing": missing,
                "expected": expected,
            })
        for (g, rank), ewma in self._lag_ewma.items():
            if group_name is not None and g != group_name:
                continue
            _group_entry(g)["lag_ewma_s"][rank] = round(ewma, 4)
        # groups with members but no activity still appear (identity map
        # is what diagnose uses to name a missing member's actor/node)
        for g in list(self._members):
            if group_name is None or g == group_name:
                _group_entry(g)
        return {"groups": groups}

    # -- group declaration / join ------------------------------------------
    def declare_group(self, group_name: str, world_size: int, backend: str):
        self._groups[group_name] = {"world_size": world_size, "backend": backend}
        # a fresh declaration is an explicit re-init: clear the poison and
        # any stale state the aborted incarnation left behind
        if group_name in self._aborts:
            self._aborts.pop(group_name, None)
            self._clear_group_state(group_name)
        self._members.pop(group_name, None)
        # a re-declared group restarts its seq counters: stale pending
        # rounds can never complete and their keys would collide with the
        # new incarnation's first rounds (lag EWMAs survive — rank identity
        # is stable across re-inits, and the persistent-straggler score is
        # exactly the cross-restart signal)
        self._arrivals = {k: v for k, v in self._arrivals.items()
                          if not (isinstance(k, tuple) and k
                                  and k[0] == group_name)}
        return True

    def get_group(self, group_name: str):
        return self._groups.get(group_name)

    def join_member(self, group_name: str, rank: int, member: dict):
        """A rank announces its identity so the liveness monitor can abort
        the group promptly when this member dies or its node drains."""
        self._members.setdefault(group_name, {})[rank] = dict(member or {})
        self._ensure_monitor()
        return True

    def get_members(self, group_name: str) -> Dict[int, dict]:
        """rank -> {"actor_id", "node_id"} for a joined group — the
        topology source for the store backend's planner (ranks sharing a
        node form one latency domain)."""
        return dict(self._members.get(group_name, {}))

    def leave_group(self, group_name: str, rank: int):
        members = self._members.get(group_name)
        if members is not None:
            members.pop(rank, None)
            if not members:
                self._members.pop(group_name, None)
        return True

    # -- abort plumbing -----------------------------------------------------
    def abort_group(self, group_name: str, reason: str):
        """Poison the group: blocked waiters see the sentinel on their next
        poll, and the group's in-flight state is dropped so a re-init starts
        from a clean slate."""
        if group_name in self._aborts:
            return True
        self._aborts[group_name] = reason
        self._members.pop(group_name, None)
        self._clear_group_state(group_name)
        return True

    def get_abort(self, group_name: str) -> Optional[str]:
        return self._aborts.get(group_name)

    def _clear_group_state(self, group_name: str):
        """Drop gathers/barriers/p2p entries keyed by this group (every
        collective key is a tuple whose [0] is the group name)."""
        def _keep(key) -> bool:
            return not (isinstance(key, tuple) and key and key[0] == group_name)

        self._gathers = {k: v for k, v in self._gathers.items() if _keep(k)}
        self._gather_reads = {k: v for k, v in self._gather_reads.items() if _keep(k)}
        self._barriers = {k: v for k, v in self._barriers.items() if _keep(k)}
        self._barrier_reads = {k: v for k, v in self._barrier_reads.items() if _keep(k)}
        self._kv = {k: v for k, v in self._kv.items() if _keep(k)}
        self._arrivals = {k: v for k, v in self._arrivals.items() if _keep(k)}

    def _abort_for(self, key):
        """Sentinel when ``key`` belongs to a poisoned group, else None."""
        if not self._aborts:
            return None
        if isinstance(key, tuple) and key:
            reason = self._aborts.get(key[0])
            if reason is not None:
                return (ABORT_SENTINEL, reason)
        return None

    # -- liveness monitor ---------------------------------------------------
    def _ensure_monitor(self):
        if self._monitor_started:
            return
        try:
            from ray_tpu_torch._private.worker import get_global_worker

            get_global_worker()  # only meaningful inside a live worker
        except Exception:  # noqa: BLE001 — unit tests instantiate the class
            return  # bare; they drive _check_members directly
        self._monitor_started = True
        threading.Thread(target=self._monitor_loop, daemon=True,
                         name="collective-store-monitor").start()

    def _monitor_loop(self):
        from ray_tpu_torch._private.config import global_config
        from ray_tpu_torch._private.worker import get_global_worker

        interval = global_config().collective_abort_poll_interval_s
        while True:
            time.sleep(interval)
            if not self._members:
                continue
            try:
                w = get_global_worker()
                nodes = w.gcs.call("GetAllNodeInfo", {},
                                   timeout=2, retry_deadline=0.0) or []
                actors = w.gcs.call("ListActors", {},
                                    timeout=2, retry_deadline=0.0) or []
            except Exception:  # noqa: BLE001 — GCS unreachable; retry
                continue
            try:
                node_states = {n["node_id"].hex(): n["state"] for n in nodes}
                actor_states = {a["actor_id"].hex(): a["state"]
                                for a in actors}
                self._check_members(node_states, actor_states)
            except Exception:  # noqa: BLE001 — the monitor must survive
                # races with join/leave mutations; a dead monitor would
                # silently restore the hang-to-timeout behavior
                logger.exception("collective store liveness check failed")

    def _check_members(self, node_states: Dict[str, str],
                       actor_states: Dict[str, str]):
        """Abort every group with a dead/restarting member or a member on a
        draining/dead node (pure: callable from tests with synthetic maps).
        Iterates over copies — join_member/leave_group mutate these dicts
        from the actor's RPC threads while the monitor thread scans."""
        for group_name, members in list(self._members.items()):
            for rank, m in list(members.items()):
                aid, nid = m.get("actor_id"), m.get("node_id")
                if aid is not None and actor_states.get(aid) in ("DEAD",
                                                                "RESTARTING"):
                    self.abort_group(
                        group_name,
                        f"rank {rank} (actor {aid[:8]}) is "
                        f"{actor_states[aid]}")
                    break
                if nid is not None and node_states.get(nid) in ("DRAINING",
                                                                "DEAD"):
                    self.abort_group(
                        group_name,
                        f"rank {rank}'s node {nid[:8]} is "
                        f"{node_states[nid]}")
                    break

    # -- plain KV (rendezvous) ---------------------------------------------
    def put(self, key, value):
        hit = self._abort_for(key)
        if hit is not None:
            return hit
        self._kv[key] = value
        return True

    def get(self, key):
        hit = self._abort_for(key)
        if hit is not None:
            return hit
        return self._kv.get(key)

    def pop(self, key):
        hit = self._abort_for(key)
        if hit is not None:
            return hit
        return self._kv.pop(key, None)

    # -- gather: world_size ranks each contribute; all read; then GC -------
    def contribute(self, key: Tuple, rank: int, value,
                   arrival_rank=None, expected_ranks=None):
        """``rank`` keys the gathered value (a subrank inside hierarchical
        subgroup rounds); ``arrival_rank`` is the contributor's group-global
        rank for the arrival monitor, with ``expected_ranks`` naming the
        global ranks the round waits for — so diagnose/straggler EWMAs
        always speak global ranks."""
        hit = self._abort_for(key)
        if hit is not None:
            return hit
        self._gathers.setdefault(key, {})[rank] = value
        self._stamp_arrival(key, arrival_rank if arrival_rank is not None
                            else rank, expected_ranks=expected_ranks)
        return True

    def collect(self, key: Tuple, world_size: int, reader_rank: int,
                expected_readers: Optional[int] = None):
        """Returns rank->value dict once all contributions are in, else None.
        Entry is deleted after every expected reader has read it —
        ``world_size`` readers by default; chunked-ring rounds have a
        single reader per chunk key (the chunk's owner) and pass
        ``expected_readers=1`` so their entries GC immediately."""
        hit = self._abort_for(key)
        if hit is not None:
            return hit
        self._note_expected(key, world_size)
        entry = self._gathers.get(key)
        if entry is None or len(entry) < world_size:
            return None
        reads = self._gather_reads.setdefault(key, set())
        reads.add(reader_rank)
        result = entry
        if len(reads) >= (expected_readers or world_size):
            self._gathers.pop(key, None)
            self._gather_reads.pop(key, None)
        return result

    # -- barrier -----------------------------------------------------------
    def barrier_arrive(self, key: Tuple, rank: int, world_size: int):
        hit = self._abort_for(key)
        if hit is not None:
            return hit
        arrived = self._barriers.setdefault(key, set())
        arrived.add(rank)
        self._stamp_arrival(key, rank, expected=world_size)
        return len(arrived) >= world_size

    def barrier_done(self, key: Tuple, rank: int, world_size: int):
        hit = self._abort_for(key)
        if hit is not None:
            return hit
        arrived = self._barriers.get(key)
        if arrived is None or len(arrived) < world_size:
            return False
        reads = self._barrier_reads.setdefault(key, set())
        reads.add(rank)
        if len(reads) >= world_size:
            self._barriers.pop(key, None)
            self._barrier_reads.pop(key, None)
        return True


def get_or_create_store():
    """Get the cluster-wide collective store actor, creating it if needed."""
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get_actor(STORE_ACTOR_NAME)
    except Exception:  # noqa: BLE001 — no store yet: create below
        pass
    try:
        cls = ray_tpu_torch.remote(_CollectiveStoreActor).options(
            name=STORE_ACTOR_NAME, lifetime="detached", num_cpus=0
        )
        return cls.remote()
    except Exception:  # noqa: BLE001
        # Lost the creation race; the winner's actor is registered by now.
        return ray_tpu_torch.get_actor(STORE_ACTOR_NAME)


def check_abort(value):
    """Raise CollectiveAbortError when a store reply is the abort sentinel;
    otherwise pass the value through."""
    if is_abort(value):
        raise CollectiveAbortError(f"collective group aborted: {value[1]}")
    return value


def store_wait(store, method: str, args: tuple, timeout: Optional[float] = None,
               poll_interval: float = 0.002):
    """Poll a store method until it returns a non-None/True value.

    Raises CollectiveAbortError as soon as the group is poisoned (member
    death/drain) — promptly, not at the stock timeout."""
    import ray_tpu_torch

    deadline = None if timeout is None else time.monotonic() + timeout
    interval = poll_interval
    while True:
        out = ray_tpu_torch.get(getattr(store, method).remote(*args))
        if is_abort(out):
            raise CollectiveAbortError(f"collective group aborted: {out[1]}")
        if out is not None and out is not False:
            return out
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(f"collective store wait timed out on {method}{args}")
        time.sleep(interval)
        interval = min(interval * 1.5, 0.05)
