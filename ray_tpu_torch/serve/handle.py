"""DeploymentHandle + cache-aware router over power-of-two-choices.

reference: python/ray/serve/handle.py (DeploymentHandle, DeploymentResponse)
and _private/request_router/pow_2_router.py:27 — choose_replicas :52 probes
the queue length of two random replicas and picks the shorter.

Beyond the reference: **cache-aware routing**.  Replicas whose callable
exposes ``prefix_digest()`` (LLM servers: the paged engine's chain-hash
set, loaded LoRA adapter ids, live depth) publish a compact, throttled,
versioned digest to the GCS KV (serve/_private/replica.py).  The router
reads all of a deployment's digests (TTL-cached, two KV RPCs per refresh
window), computes the request prompt's chain hashes with the SAME stable
hash the engine registers (llm/prefix_hash.py), and routes to the replica
holding the longest matching prefix chain — composing with LoRA adapter
affinity (serve/multiplex.py model ids).  Cold prefixes, overloaded
winners (cached queue length beyond ``serve_prefix_overload_slack`` of the
field), and digest staleness (rows whose replica left the live set) all
fall back to pow-2-choices; a drained winner rides the existing
resubmit-once path, so degradation never drops a request.

Queue-length probes are TTL-cached (``serve_route_probe_ttl_s``) and fed
by digest rows for free, so steady-state routing costs zero probe RPCs at
high QPS.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.analysis.lock_witness import make_lock
from ray_tpu_torch._private.prefix_hash import (
    longest_chain_match,
    prefix_chain_hashes,
)

# GCS KV namespace for per-replica prefix digests (replica.py publishes,
# the router and controller cleanup consume)
DIGEST_KV_PREFIX = "serveprefix:"
# chain links the router hashes per candidate block size — bounds the
# route-decision cost on very long prompts (64 blocks x bs>=16 covers
# >1k-token prefixes, far past typical shared-prefix lengths)
_MAX_ROUTE_CHAIN = 64


def digest_kv_key(app: str, deployment: str, actor_hex: str) -> str:
    return f"{DIGEST_KV_PREFIX}{app}:{deployment}:{actor_hex}"


# GCS KV namespace for replicas mid-evacuation (the KV-migration planner
# writes a row at evacuation start and deletes it when the replica's
# streams have moved): routers consult it so a migration pause is never
# booked as a death (mark_dead), and new prompts stop routing to the
# evacuating replica (its digest row is deleted alongside)
MIGRATING_KV_PREFIX = "servemig:"


def migration_kv_key(app: str, deployment: str, actor_hex: str) -> str:
    return f"{MIGRATING_KV_PREFIX}{app}:{deployment}:{actor_hex}"


def _extract_prompt(args: tuple, kwargs: dict):
    """(prompt_token_ids | None, model_id | None) from a handle call.

    Only token-id prompts are routable — chain hashes are over token ids,
    and text prompts tokenize inside the replica.  Accepts the LLM serving
    shapes: ``prompt=[ids]`` kwarg, a request dict carrying ``prompt`` /
    ``model``, or a leading list-of-ints positional."""

    def _ids(x):
        if (isinstance(x, (list, tuple)) and x
                and all(isinstance(t, int) for t in x)):
            return list(x)
        return None

    prompt = model = None
    req = kwargs if "prompt" in kwargs else None
    if req is None and args:
        # ONLY the leading positional: scanning further would latch onto
        # a later int list (stop_token_ids) when the first argument is a
        # non-list prompt encoding, and route on a meaningless chain
        a0 = args[0]
        if isinstance(a0, dict) and "prompt" in a0:
            req = a0
        else:
            prompt = _ids(a0)
    if req is not None:
        prompt = _ids(req.get("prompt"))
        model = req.get("model") or None
    if model is None:
        model = kwargs.get("model") or None
    return prompt, model


def _resolve_refs(refs, timeout):
    """Seam for tests (probe-RPC counting): resolve queue-length refs."""
    import ray_tpu_torch

    return ray_tpu_torch.get(refs, timeout=timeout)


class DeploymentResponse:
    """Future-like result of handle.remote() (reference: handle.py)."""

    def __init__(self, ref, resubmit=None):
        self._ref = ref
        self._resubmit = resubmit

    def result(self, timeout_s: Optional[float] = None):
        import ray_tpu_torch
        from ray_tpu_torch._private.task_spec import (
            ActorDiedError, ActorUnavailableError, WorkerCrashedError)

        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout_s)
        except (ActorDiedError, ActorUnavailableError, WorkerCrashedError):
            # the replica died under us — most commonly a drained old-version
            # replica during a rolling redeploy. Re-route once through the
            # (refreshed) router so redeploys lose zero requests.
            if self._resubmit is None:
                raise
            resubmit, self._resubmit = self._resubmit, None
            resp = resubmit()
            self._ref = resp._ref
            return ray_tpu_torch.get(self._ref, timeout=timeout_s)

    @property
    def ref(self):
        return self._ref


class _Router:
    """Caches the replica set; refreshes when the controller version bumps
    (reference: LongPollClient long_poll.py:71)."""

    def __init__(self, app_name: str, deployment_name: str):
        self._app = app_name
        self._dep = deployment_name
        self._replicas: List[Any] = []
        self._version = -1
        self._lock = make_lock("_Router._lock")
        # queue-length cache: actor_hex -> (qlen, monotonic ts); fed by
        # probe RPCs AND by digest rows (which carry the replica's depth)
        self._qcache: Dict[str, Tuple[float, float]] = {}
        # per-replica prefix digests: actor_hex -> {held, block_size,
        # models, v}; refreshed from the GCS KV at most once per TTL
        self._digests: Dict[str, dict] = {}
        self._digest_ts = float("-inf")
        # probe-RPC accounting (hermetic test seam: the TTL cache must
        # keep this sub-RPC per request at high QPS)
        self.probe_rpcs = 0
        # replicas a caller observed dead (actor_hex -> mark ts): excluded
        # from routing until the controller's live set catches up.  Without
        # this, cache affinity is actively harmful under a hard kill — the
        # dead replica stays the digest winner and every resubmit would
        # re-route straight back to it.
        self._dead: Dict[str, float] = {}
        # replicas marked mid-evacuation by the KV-migration planner
        # (servemig:* rows): consulted by mark_dead so a deliberate
        # migration pause is never booked as a death (TTL-cached; only
        # fetched when a caller actually reports a death)
        self._migrating: set = set()
        self._migrating_ts = float("-inf")

    def _refresh(self):
        import ray_tpu_torch
        from ray_tpu_torch.actor import ActorHandle
        from ray_tpu_torch._private.ids import ActorID
        from ray_tpu_torch.serve._private.controller import get_or_create_controller

        controller = get_or_create_controller()
        version = ray_tpu_torch.get(controller.get_version.remote())
        if version == self._version and self._replicas:
            return
        # replicas that compile jitted programs at startup (LLM engines) can
        # take minutes on a loaded host: wait as long as actor creation may
        from ray_tpu_torch._private.config import global_config

        wait_s = global_config().actor_creation_timeout_s
        deadline = time.monotonic() + wait_s
        while True:
            ids = ray_tpu_torch.get(
                controller.get_replica_actor_ids.remote(self._app, self._dep))
            if ids:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no replicas for {self._app}/{self._dep} after {wait_s:.0f}s")
            time.sleep(0.05)
        with self._lock:
            self._replicas = [ActorHandle(ActorID(h)) for h in ids]
            self._version = version

    def choose_replica(self, args: tuple = (), kwargs: Optional[dict] = None):
        """Cache-aware choice with pow-2 fallback: route to the replica
        holding the longest matching prefix chain for the request's prompt
        (composing with LoRA adapter affinity), unless the prefix is cold,
        digests are absent, or the winner is overloaded — then power of
        two choices by (cached) queue length.

        Every decision books its reason (prefix_hit / pow2_cold /
        overload_divert / stale_row) to
        ``ray_tpu_serve_route_decisions_total`` and to the active request's
        lifecycle — cache-router regressions were previously invisible."""
        self._refresh()
        with self._lock:
            replicas = list(self._replicas)
            if self._dead:
                now = time.monotonic()
                self._dead = {h: ts for h, ts in self._dead.items()
                              if now - ts < 30.0}
                live = [r for r in replicas
                        if r._actor_id.hex() not in self._dead]
                # all marked dead: the marks are probably stale — routing
                # to a maybe-dead replica beats failing outright
                replicas = live or replicas
        if len(replicas) == 1:
            return replicas[0]
        from ray_tpu_torch._private.config import global_config
        from ray_tpu_torch.serve._private import slo

        cfg = global_config()
        if cfg.serve_prefix_routing_enabled:
            chosen, reason = self._prefix_choice(replicas, args, kwargs or {},
                                                 cfg)
            slo.note_route(reason)
            if chosen is not None:
                return chosen
        return self._pow2_choice(replicas, cfg)

    # -- cache-aware path ---------------------------------------------------

    def _fetch_digests(self, cfg):
        """TTL-refresh the deployment's digest rows from the GCS KV (one
        KVKeys + one KVMultiGet per window, amortized over every request
        routed in between).  Row qlen feeds the probe cache for free."""
        now = time.monotonic()
        if now - self._digest_ts < cfg.serve_prefix_digest_ttl_s:
            return
        self._digest_ts = now
        try:
            from ray_tpu_torch._private.worker import get_global_worker

            gcs = get_global_worker().gcs
            prefix = f"{DIGEST_KV_PREFIX}{self._app}:{self._dep}:"
            keys = gcs.call("KVKeys", {"prefix": prefix}, timeout=2) or []
            blobs = gcs.call("KVMultiGet", {"keys": keys}, timeout=2) or {}
            rows: Dict[str, dict] = {}
            for key, blob in blobs.items():
                try:
                    d = json.loads(blob)
                    hex_ = key[len(prefix):]
                    rows[hex_] = {
                        "held": set(d.get("hashes") or ()),
                        "block_size": int(d.get("block_size") or 0),
                        "models": set(d.get("models") or ()),
                        "v": d.get("v", 0),
                    }
                    if d.get("qlen") is not None:
                        with self._lock:
                            self._qcache[hex_] = (float(d["qlen"]), now)
                except Exception:  # noqa: BLE001 — one bad row, not all
                    continue
            self._digests = rows
        except Exception:  # noqa: BLE001 — no GCS (local mode): stay pow-2
            self._digests = {}

    def _prefix_choice(self, replicas, args, kwargs, cfg):
        """(winner, reason): the longest-matching-prefix winner with reason
        ``prefix_hit``, or (None, fallback-reason) for pow-2.  Stale digest
        rows (replicas no longer in the live set) are ignored — the live
        set is the controller's, so a drained winner can't be chosen from a
        stale row; when the STALE row would have won, the fallback books
        ``stale_row`` so digest-lag regressions are visible."""
        prompt, model = _extract_prompt(args, kwargs)
        if prompt is None and model is None:
            return None, "pow2_cold"
        self._fetch_digests(cfg)
        if not self._digests:
            return None, "pow2_cold"
        by_hex = {r._actor_id.hex(): r for r in replicas}
        chains: Dict[int, list] = {}  # block_size -> request chain hashes
        best_key = (False, 0)
        best_hex = None
        stale_best = (False, 0)

        def _score(row):
            matched = 0
            if prompt is not None and row["block_size"] > 0:
                bs = row["block_size"]
                chain = chains.get(bs)
                if chain is None:
                    chain = chains[bs] = prefix_chain_hashes(
                        prompt, bs, limit=_MAX_ROUTE_CHAIN)
                matched = longest_chain_match(chain, row["held"])
            # adapter affinity dominates (a cold adapter costs a merge +
            # compile); prefix length breaks ties
            return (bool(model) and model in row["models"], matched)

        for hex_, row in self._digests.items():
            if hex_ not in by_hex:
                # stale digest: replica drained or replaced — track what it
                # WOULD have scored for the fallback reason
                key = _score(row)
                if key > stale_best:
                    stale_best = key
                continue
            key = _score(row)
            if key > best_key:
                best_key, best_hex = key, hex_
        if best_hex is None or best_key == (False, 0):
            # cold prefix (and no adapter affinity); if a stale row held
            # the chain, the miss is digest lag, not a cold cache
            return None, ("stale_row" if stale_best > best_key
                          else "pow2_cold")
        # overload guard: a cache winner far deeper than the field's
        # shortest known queue loses its affinity claim.  Freshness horizon
        # is a full digest window + probe TTL: in the zero-RPC steady state
        # the qcache is refreshed only by the digest fetch (every
        # serve_prefix_digest_ttl_s), so gating on the probe TTL alone
        # would leave the guard inert most of each window — exactly the
        # affinity hot spot it exists to prevent
        horizon = cfg.serve_prefix_digest_ttl_s + cfg.serve_route_probe_ttl_s
        with self._lock:
            known = {h: q for h, (q, ts) in self._qcache.items()
                     if h in by_hex and time.monotonic() - ts < horizon}
        if known:
            floor = min(known.values())
            if known.get(best_hex, floor) > floor + \
                    cfg.serve_prefix_overload_slack:
                return None, "overload_divert"
        return by_hex[best_hex], "prefix_hit"

    # -- pow-2 fallback -----------------------------------------------------

    def _qlen_pair(self, a, b, cfg):
        """Queue lengths for the two candidates, probing only the ones
        whose cached value is older than the TTL (both fresh -> zero
        RPCs)."""
        now = time.monotonic()
        ttl = cfg.serve_route_probe_ttl_s
        out = {}
        stale = []
        with self._lock:
            for r in (a, b):
                hex_ = r._actor_id.hex()
                got = self._qcache.get(hex_)
                if got is not None and now - got[1] < ttl:
                    out[hex_] = got[0]
                else:
                    stale.append(r)
        if stale:
            refs = []
            for r in stale:
                refs.append(r.queue_len.remote())
                self.probe_rpcs += 1
            vals = _resolve_refs(refs, timeout=5)
            with self._lock:
                for r, q in zip(stale, vals):
                    hex_ = r._actor_id.hex()
                    out[hex_] = q
                    self._qcache[hex_] = (float(q), now)
        return out[a._actor_id.hex()], out[b._actor_id.hex()]

    def _pow2_choice(self, replicas, cfg):
        """Power of two choices by queue length (pow_2_router.py:52), over
        the TTL probe cache."""
        a, b = random.sample(replicas, 2)
        try:
            qa, qb = self._qlen_pair(a, b, cfg)
        except Exception:  # noqa: BLE001
            return a
        return a if qa <= qb else b

    def mark_dead(self, replica):
        """A caller saw this replica die mid-call: exclude it from routing
        until the controller's live set reflects the death (the marks
        self-expire, so a restarted actor id isn't shunned forever).

        Deliberate evacuation is NOT death: a replica mid-KV-migration
        pauses its streams long enough for a caller to misread the stall,
        and booking the 30 s shun would blackhole a healthy replica (it
        serves again the moment the handoff completes).  The migration
        planner marks evacuating replicas in the GCS KV (servemig:*);
        marked replicas skip the shun — the probe cache is still dropped,
        since a paused replica's cached depth is stale either way."""
        try:
            hex_ = replica._actor_id.hex()
        except AttributeError:
            return
        migrating = hex_ in self._fetch_migrating()
        with self._lock:
            if not migrating:
                self._dead[hex_] = time.monotonic()
            self._qcache.pop(hex_, None)

    def _fetch_migrating(self) -> set:
        """TTL-cached set of this deployment's replicas currently marked
        evacuating (``servemig:`` rows written by the KV-migration
        planner).  Only consulted from mark_dead, so the fetch stays off
        the per-request routing path."""
        now = time.monotonic()
        if now - self._migrating_ts < 2.0:
            return self._migrating
        self._migrating_ts = now
        try:
            from ray_tpu_torch._private.worker import get_global_worker

            gcs = get_global_worker().gcs
            prefix = f"{MIGRATING_KV_PREFIX}{self._app}:{self._dep}:"
            keys = gcs.call("KVKeys", {"prefix": prefix},
                            timeout=2, retry_deadline=0.0) or []
            self._migrating = {k[len(prefix):] for k in keys}
        except Exception:  # noqa: BLE001 — no GCS (local mode): nothing is marked
            self._migrating = set()
        return self._migrating

    def invalidate(self):
        with self._lock:
            self._version = -1
            self._qcache.clear()
        self._digest_ts = float("-inf")


class DeploymentResponseGenerator:
    """Iterates a streaming deployment call's items as VALUES (reference:
    handle.options(stream=True) -> DeploymentResponseGenerator)."""

    def __init__(self, ref_gen, resubmit=None):
        self._gen = ref_gen
        self._resubmit = resubmit
        self._yielded = 0

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch
        from ray_tpu_torch._private.task_spec import (
            ActorDiedError, ActorUnavailableError, WorkerCrashedError)

        try:
            out = ray_tpu_torch.get(next(self._gen))
        except (ActorDiedError, ActorUnavailableError, WorkerCrashedError):
            # replica died before the stream produced anything (e.g. drained
            # during a redeploy): re-route once. Mid-stream deaths are NOT
            # retried — replaying would duplicate already-yielded items.
            if self._yielded or self._resubmit is None:
                raise
            resubmit, self._resubmit = self._resubmit, None
            fresh = resubmit()
            self._gen = fresh._gen
            out = ray_tpu_torch.get(next(self._gen))
        self._yielded += 1
        return out

    def close(self):
        """Abandon the stream (client disconnect): cancel the replica-side
        generator task (best-effort — KeyboardInterrupt at the executing
        worker unwinds the replica generator, whose close propagates to the
        engine and frees the request's slot).  Completion still frees
        everything if the cancel is lost."""
        gen, self._gen = self._gen, iter(())
        try:
            anchor = getattr(gen, "_anchor", None)
            w = getattr(gen, "_w", None)
            if anchor is not None and w is not None:
                import ray_tpu_torch
                from ray_tpu_torch._private.worker import ObjectRef

                ray_tpu_torch.cancel(ObjectRef(anchor, w.address), force=False)
        except Exception:  # noqa: BLE001 — best-effort; completion also frees
            pass


class DeploymentHandle:
    def __init__(self, app_name: str, deployment_name: str,
                 method_name: str = "__call__", stream: bool = False):
        self._app = app_name
        self._dep = deployment_name
        self._method = method_name
        self._stream = stream
        self._router = _Router(app_name, deployment_name)

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        h = DeploymentHandle(self._app, self._dep,
                             method_name if method_name is not None else self._method,
                             stream if stream is not None else self._stream)
        h._router = self._router
        return h

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.serve._private import slo

        # handle-kwarg tenant attribution for the active request lifecycle
        # (callers not fronted by HTTP pass tenant= / {"tenant": ...})
        slo.note_request_args(args, kwargs)
        last_err = None
        for _ in range(3):
            replica = self._router.choose_replica(args, kwargs)
            try:
                def resubmit(h=self, a=args, kw=kwargs, r=replica):
                    # the caller observed r dead: shun it so the re-route
                    # (and cache affinity in particular) picks a survivor
                    slo.note_route("shun_resubmit")
                    h._router.mark_dead(r)
                    h._router.invalidate()
                    return h.remote(*a, **kw)

                if self._stream:
                    gen = replica.handle_request_streaming.options(
                        num_returns="streaming").remote(
                            self._method, args, kwargs)
                    return DeploymentResponseGenerator(gen, resubmit)
                ref = replica.handle_request.remote(self._method, args, kwargs)
                return DeploymentResponse(ref, resubmit)
            except Exception as e:  # noqa: BLE001
                last_err = e
                self._router.mark_dead(replica)
                self._router.invalidate()
        raise last_err

    def pinned(self) -> "PinnedReplicaHandle":
        """Choose one replica NOW; every subsequent call lands on it.

        Stateful per-connection protocols (ASGI websocket sessions,
        serve/asgi.py) must talk to the replica holding their session —
        the pow-2 router would scatter the calls. A dead pinned replica
        fails the call (the session died with it; reference behaviour:
        websockets drop on replica loss)."""
        return PinnedReplicaHandle(self._router.choose_replica(),
                                   self._method)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._app, self._dep, self._method, self._stream))


class PinnedReplicaHandle:
    def __init__(self, replica, method_name: str = "__call__"):
        self._replica = replica
        self._method = method_name

    def remote(self, *args, **kwargs) -> "DeploymentResponse":
        ref = self._replica.handle_request.remote(self._method, args, kwargs)
        return DeploymentResponse(ref, None)
