"""Live KV migration: move decode streams between replicas, zero drops.

The P/D handoff (llm/disagg.py) proved KV blocks move between replicas
mid-request; this module generalizes it into decode -> decode migration,
the actuator that makes drains, rebalances, and autoscaler scale-downs
fast instead of as slow as the longest generation in flight (reference
posture: llm-d / vLLM KV-transfer disaggregation, plus arxiv 2510.20171's
"at scale the failure path is the common path").

One stream moves through five phases, each independently recoverable:

  pause/export   source drains the in-flight chunk and exports the live
                 KV cover + token history (engine slot and blocks free
                 IMMEDIATELY — the expensive resource is released even
                 though the source still relays bytes).
  transfer       the handoff travels to a candidate destination (object
                 transport: it rides the import call's payload).
  import         destination scatters the KV and resumes at the exact
                 position (or re-prefills prompt+history — recompute).
  splice         the source installs a relay feeding the client's
                 ORIGINAL waiter buffer from the destination stream; the
                 client never observes the switch.
  free           implicit: export already freed the source's slot/blocks.

Failure ladder (every rung leaves the stream alive):
  export fails          -> stream healed back onto the source engine.
  transfer fails        -> KV still in hand: restore into the source's
                           own engine (exact, instant) and splice locally.
  dest refuses/import   -> next candidate; then candidates again with
  fails                    recompute allowed; then local restore.
  dest dies mid-relay   -> the splice degrades once to local recompute
                           from prompt + delivered history.
  source dies           -> the stream's owner retries via the normal
                           handle resubmit path (out of scope here).
Every non-clean outcome books outcome="fallback"; "lost" must stay zero.

Chaos: ``testing_migration_fault`` ("<phase>:<mode>", e.g. "import:fail",
"import:refuse") injects a deterministic fault at that phase on every
REMOTE/candidate attempt.  The terminal local-restore rung is exempt —
it models this replica's own engine, which is demonstrably alive — so
chaos proves degradation, never fabricates stream loss.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

PHASES = ("export", "transfer", "import", "splice")

# evacuations move whole engines' worth of streams; same generous bound
# as the P/D handoff path
_EVACUATE_TIMEOUT_S = 600.0


class InjectedFault(RuntimeError):
    """Raised by the testing_migration_fault chaos knob."""


def _fault_mode(phase: str) -> str:
    from ray_tpu_torch._private.config import global_config

    spec = global_config().testing_migration_fault
    if not spec:
        return ""
    p, _, mode = spec.partition(":")
    return (mode or "fail") if p == phase else ""


def _fault(phase: str) -> None:
    if _fault_mode(phase) == "fail":
        raise InjectedFault(f"injected migration fault: {phase}:fail")


# -- destination abstraction -------------------------------------------------


class LocalDest:
    """An in-process LLMServer destination (local mode, tests, bench)."""

    kind = "local"

    def __init__(self, server):
        self._s = server

    def import_migration(self, handoff, allow_recompute=False):
        return self._s.import_migration(handoff,
                                        allow_recompute=allow_recompute)

    def resume_iter(self, wkey):
        return self._s.resume_stream(wkey)

    def cancel(self, wkey):
        try:
            self._s.cancel_stream(wkey)
        except Exception:  # noqa: BLE001 — cancel is best-effort cleanup
            pass


class ActorDest:
    """A ServeReplica actor destination, addressed by actor-id hex (the
    controller's survivor set travels as hexes; handles reconstruct —
    the same pattern the router uses)."""

    kind = "actor"

    def __init__(self, actor_or_hex):
        if isinstance(actor_or_hex, str):
            from ray_tpu_torch.actor import ActorHandle
            from ray_tpu_torch._private.ids import ActorID

            self._h = ActorHandle(ActorID(actor_or_hex))
        else:
            self._h = actor_or_hex

    def import_migration(self, handoff, allow_recompute=False):
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._h.handle_request.remote(
                "import_migration", (handoff, allow_recompute), {}),
            timeout=_EVACUATE_TIMEOUT_S)

    def resume_iter(self, wkey):
        import ray_tpu_torch

        gen = self._h.handle_request_streaming.options(
            num_returns="streaming").remote(
                "resume_stream", (list(wkey),), {})
        return (ray_tpu_torch.get(ref) for ref in gen)

    def cancel(self, wkey):
        try:
            import ray_tpu_torch

            ray_tpu_torch.get(self._h.handle_request.remote(
                "cancel_stream", (list(wkey),), {}), timeout=5)
        except Exception:  # noqa: BLE001 — cancel is best-effort cleanup
            pass


# -- the per-stream phase machine --------------------------------------------


def migrate_stream(server, rid: int, dests: List[Any],
                   reason: str = "manual") -> str:
    """Move one live base-engine stream off ``server`` through the phase
    machine above.  Returns the booked outcome: "migrated" (KV moved and
    spliced cleanly), "fallback" (a phase failed but the stream survived
    via next-candidate / recompute / local restore), or "skipped" (the
    stream finished or left the exportable state first — nothing moved,
    nothing booked)."""
    from ray_tpu_torch._private import runtime_metrics

    t_total = time.monotonic()

    # -- pause/export (source slot + blocks free on success) --
    t0 = time.monotonic()
    try:
        _fault("export")
        handoff = server.export_stream(rid)
    except InjectedFault:
        # export never ran: the stream keeps decoding on the source —
        # survived without moving, the definition of a fallback
        runtime_metrics.record_kv_migration(reason, "fallback")
        return "fallback"
    except (KeyError, RuntimeError):
        # finished / not exportable right now; export_stream healed any
        # partial state — the stream is untouched
        return "skipped"
    runtime_metrics.observe_kv_migration_phase(
        "export", time.monotonic() - t0)
    handoff["reason"] = reason
    handoff["mig_id"] = f"{id(server):x}:{rid}"

    outcome = "migrated"

    # -- transfer (object transport: staging is the import call itself;
    #    a transfer fault means no candidate is reachable) --
    t1 = time.monotonic()
    candidates = list(dests)
    try:
        _fault("transfer")
    except InjectedFault:
        candidates = []
        outcome = "fallback"
    runtime_metrics.observe_kv_migration_phase(
        "transfer", time.monotonic() - t1)

    # -- import: candidate ladder (exact KV import first, then the same
    #    candidates with recompute allowed), then local restore --
    res = None
    dest = None
    for allow_recompute in (False, True):
        for cand in candidates:
            t2 = time.monotonic()
            try:
                mode = _fault_mode("import")
                if mode == "fail":
                    raise InjectedFault(
                        "injected migration fault: import:fail")
                r = (None if mode == "refuse"
                     else cand.import_migration(
                         handoff, allow_recompute=allow_recompute))
            except Exception:  # noqa: BLE001 — dead/refusing dest: next rung
                outcome = "fallback"
                continue
            runtime_metrics.observe_kv_migration_phase(
                "import", time.monotonic() - t2)
            if r is None:
                outcome = "fallback"
                continue
            res, dest = r, cand
            break
        if res is not None:
            break
    if res is None:
        # no destination took it — the KV is still in hand, so restore
        # into the source's own engine: an exact, instant resume (the
        # blocks just freed cover it).  The stream stays here; the
        # planner simply failed to move it.
        outcome = "fallback"
        res, dest = _local_restore(server, handoff)

    # -- splice: relay the destination stream into the client's original
    #    waiter buffer --
    t3 = time.monotonic()
    try:
        if dest is not None and dest.kind != "self":
            _fault("splice")
        _install_splice(server, rid, res, dest, handoff)
    except Exception:  # noqa: BLE001 — splice fault/failure: abandon the dest copy, keep local
        outcome = "fallback"
        if dest is not None and res is not None and res.get("wkey"):
            dest.cancel(res["wkey"])
        res, dest = _local_restore(server, handoff)
        _install_splice(server, rid, res, dest, handoff)
    runtime_metrics.observe_kv_migration_phase(
        "splice", time.monotonic() - t3)

    runtime_metrics.record_kv_migration(reason, outcome)
    runtime_metrics.observe_kv_migration_phase(
        "total", time.monotonic() - t_total)
    return outcome


class _SelfDest(LocalDest):
    """The source acting as its own destination (local restore)."""

    kind = "self"


def _local_restore(server, handoff):
    """Terminal ladder rung: re-import (or worst-case recompute) the
    handoff into the source's OWN engine.  Exempt from chaos injection —
    it models this replica's live engine; its import path is the one
    that just exported, so capacity is there by construction."""
    res = server.import_migration(handoff, allow_recompute=True)
    return res, _SelfDest(server)


def _install_splice(server, rid, res, dest, handoff):
    if res is None or res.get("wkey") is None:
        # nothing to relay: either even local restore refused (engine
        # variants without an import surface) or the budget/stop boundary
        # landed exactly on the handoff.  The waiter already holds the
        # full exported history — finish it rather than hang the client.
        server._finish_migrated(rid)
        return
    server._splice(rid, dest.resume_iter(res["wkey"]),
                   lambda: dest.cancel(res["wkey"]), handoff)


# -- evacuation entry point ---------------------------------------------------


def evacuate(server, dests, reason: str = "drain",
             max_streams: Optional[int] = None,
             dest_servers=None) -> Dict[str, int]:
    """Migrate ``server``'s live base-engine streams to the given
    destinations (actor-id hexes and/or in-process LLMServer objects).
    Used by the controller's migrate-first drain path and the rebalance
    trigger; every stream survives — worst case it stays via local
    restore."""
    cands: List[Any] = [LocalDest(s) for s in (dest_servers or [])]
    cands += [ActorDest(d) for d in (dests or [])]
    rids = server.migratable_streams()
    if max_streams is not None:
        rids = rids[:max_streams]
    out = {"migrated": 0, "fallback": 0, "skipped": 0}
    for rid in rids:
        o = migrate_stream(server, rid, cands, reason=reason)
        out[o] = out.get(o, 0) + 1
    return out


# -- the controller-side planner ----------------------------------------------


class MigrationPlanner:
    """Controller-driven victim/destination selection and actuation.

    Two triggers feed it: the drain path (evacuate_replicas — a draining
    decode replica moves its streams to same-deployment survivors
    instead of waiting them out) and the queue-depth rebalance tick
    (divergence over serve_migration_rebalance_threshold for
    serve_migration_rebalance_ticks consecutive ticks moves a bounded
    batch from the hottest replica to the coldest).  A per-replica
    token bucket (serve_migration_max_rate_per_s) caps how fast streams
    can leave any one replica, so planner oscillation can never thrash
    the pool."""

    def __init__(self, submit=None):
        # async executor for actuations (the controller's start pool):
        # evacuation RPCs can run for minutes and must never ride the
        # reconcile thread.  None (tests) actuates inline.
        self._submit = submit
        self._next_tick = 0.0
        self._streak: Dict[tuple, int] = {}
        # actor hex -> (tokens, last-refill ts); the rebalance rate cap
        self._bucket: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        from ray_tpu_torch._private.config import global_config

        return global_config().serve_migration_enabled

    # -- drain evacuation --

    def evacuate_replicas(self, app: str, dep: str, victims: List[Any],
                          survivor_hexes: List[str]) -> None:
        """Move every live stream off ``victims`` (replica handles) onto
        same-deployment survivors.  Runs OFF the controller's reconcile
        thread (the drain submit path).  Per victim: mark it evacuating
        in the KV (mark_dead exemption), delete its digest row (routers
        stop sending new prompts), evacuate, unmark.  A victim that
        can't evacuate (non-LLM callable, already dead) just falls back
        to the ordinary wait-out drain."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.handle import digest_kv_key, migration_kv_key

        for h in victims:
            try:
                hex_ = h._actor_id.hex()
            except AttributeError:
                continue
            dests = [s for s in survivor_hexes if s != hex_]
            mkey = migration_kv_key(app, dep, hex_)
            _kv_put(mkey, b"1")
            # routers must stop choosing this replica for new prompts the
            # moment evacuation starts (satellite of the _begin_drain
            # KVDel: same row, migrate-first timing)
            _kv_del(digest_kv_key(app, dep, hex_))
            try:
                out = ray_tpu_torch.get(
                    h.handle_request.remote(
                        "evacuate_streams", (dests, "drain"), {}),
                    timeout=_EVACUATE_TIMEOUT_S)
                logger.info("serve: evacuated %s/%s replica %s: %s",
                            app, dep, hex_[:12], out)
            except Exception:  # noqa: BLE001 — wait-out drain is the fallback
                logger.info(
                    "serve: %s/%s replica %s has no evacuation path; "
                    "drain waits out its streams", app, dep, hex_[:12])
            finally:
                _kv_del(mkey)

    # -- rebalance --

    def rebalance_tick(self, snapshot: Dict[tuple, List[Any]]) -> int:
        """One planner tick over {(app, dep): [replica handles]}:
        queue-depth divergence with hysteresis, actuated under the rate
        cap.  Returns the number of streams submitted for movement (the
        moves themselves run on the submit executor when one was
        given)."""
        now = time.monotonic()
        with self._lock:
            if now < self._next_tick:
                return 0
            self._next_tick = now + 1.0
        if not self.enabled:
            return 0
        from ray_tpu_torch._private.config import global_config

        cfg = global_config()
        moves = 0
        for (app, dep), handles in snapshot.items():
            if len(handles) < 2:
                self._streak.pop((app, dep), None)
                continue
            qlens = _fetch_qlens(app, dep)
            rows = [(h, qlens.get(_hex(h))) for h in handles]
            rows = [(h, q) for h, q in rows if q is not None]
            if len(rows) < 2:
                continue
            rows.sort(key=lambda hq: hq[1])
            (cold, qmin), (hot, qmax) = rows[0], rows[-1]
            if qmax - qmin < cfg.serve_migration_rebalance_threshold:
                self._streak.pop((app, dep), None)
                continue
            streak = self._streak.get((app, dep), 0) + 1
            self._streak[(app, dep)] = streak
            if streak < cfg.serve_migration_rebalance_ticks:
                continue
            self._streak.pop((app, dep), None)
            n = self._rate_allow(_hex(hot),
                                 cfg.serve_migration_rebalance_batch,
                                 cfg.serve_migration_max_rate_per_s)
            if n <= 0:
                continue
            if self._submit is not None:
                self._submit(self._actuate_rebalance, app, dep, hot,
                             cold, n)
                moves += n
            else:
                moves += self._actuate_rebalance(app, dep, hot, cold, n)
        return moves

    def _actuate_rebalance(self, app, dep, hot, cold, n) -> int:
        import ray_tpu_torch
        from ray_tpu_torch.serve.handle import migration_kv_key

        hex_ = _hex(hot)
        mkey = migration_kv_key(app, dep, hex_)
        _kv_put(mkey, b"1")
        try:
            out = ray_tpu_torch.get(
                hot.handle_request.remote(
                    "evacuate_streams", ([_hex(cold)], "rebalance", n), {}),
                timeout=_EVACUATE_TIMEOUT_S)
            logger.info("serve: rebalanced %s/%s %s -> %s: %s", app, dep,
                        hex_[:12], _hex(cold)[:12], out)
            return sum(out.values()) if isinstance(out, dict) else 1
        except Exception:  # noqa: BLE001 — a hot replica that can't move streams just stays hot
            return 0
        finally:
            _kv_del(mkey)

    def _rate_allow(self, hex_: str, want: int, rate: float) -> int:
        """Token-bucket rate cap: streams allowed to leave ``hex_`` now
        (burst = one second's worth, floor 1)."""
        now = time.monotonic()
        cap = max(1.0, rate)
        with self._lock:
            tokens, t0 = self._bucket.get(hex_, (cap, now))
            tokens = min(cap, tokens + (now - t0) * max(rate, 0.0))
            take = min(want, int(tokens))
            self._bucket[hex_] = (tokens - take, now)
        return take


def _hex(handle) -> str:
    try:
        return handle._actor_id.hex()
    except AttributeError:
        return ""


def _fetch_qlens(app: str, dep: str) -> Dict[str, float]:
    """Per-replica queue depth from the digest rows (the same rows
    that feed the router's probe cache — depth plus, via the PR 16
    utilization fold, the free-block signal the import side re-checks
    anyway at admission)."""
    import json

    from ray_tpu_torch.serve.handle import DIGEST_KV_PREFIX

    out: Dict[str, float] = {}
    try:
        from ray_tpu_torch._private.worker import get_global_worker

        gcs = get_global_worker().gcs
        prefix = f"{DIGEST_KV_PREFIX}{app}:{dep}:"
        keys = gcs.call("KVKeys", {"prefix": prefix},
                        timeout=2, retry_deadline=0.0) or []
        blobs = gcs.call("KVMultiGet", {"keys": keys},
                         timeout=2, retry_deadline=0.0) or {}
        for key, blob in blobs.items():
            try:
                d = json.loads(blob)
                if d.get("qlen") is not None:
                    out[key[len(prefix):]] = float(d["qlen"])
            except Exception:  # noqa: BLE001 — one bad row, not all
                continue
    except Exception:  # noqa: BLE001 — no GCS (local mode): no rebalance signal
        pass
    return out


def _kv_put(key: str, value: bytes) -> None:
    try:
        from ray_tpu_torch._private.worker import get_global_worker

        get_global_worker().gcs.call(
            "KVPut", {"key": key, "value": value},
            timeout=2, retry_deadline=0.0)
    except Exception:  # noqa: BLE001 — marker rows are best-effort
        pass


def _kv_del(key: str) -> None:
    try:
        from ray_tpu_torch._private.worker import get_global_worker

        get_global_worker().gcs.call("KVDel", {"key": key},
                                     timeout=2, retry_deadline=0.0)
    except Exception:  # noqa: BLE001 — cleanup is best-effort
        pass
