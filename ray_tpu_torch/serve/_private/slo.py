"""Request-level serving SLO layer: lifecycle ledger, tenant metering,
burn-rate monitoring.

The serving path is a fleet (disaggregated prefill/decode behind a
cache-aware router) but aggregate means can't answer the operational
questions: what is p99 TTFT *right now*, for *which tenant*, and is the
deployment *burning its error budget*?  This module is the request-level
layer everything else reads:

  - **Lifecycle ledger**: every request gets a ``RequestTracker`` at the
    ingress (HTTP proxy) carrying a tenant id (``x-tenant`` header /
    ``tenant`` field in the request dict or handle kwargs / "default").
    The tracker books lifecycle moments — ingress arrival, router decision
    (with reason), first token (TTFT), per-token ITL samples, terminal
    status (ok / error / aborted / shed) — into the flight-recorder
    ring (post-mortem for free), the mergeable latency sketches
    (_private/latency_sketch.py via runtime_metrics), the burn-rate
    windows, and a recent-requests forensics ring.  Replica/engine-side
    stage durations (queue_wait, prefill, handoff, decode) book through
    ``record_stage`` under the deployment's label.
  - **Per-tenant metering**: TTFT/ITL sketches and terminal-status
    counters are tagged ``{deployment, tenant}`` — exactly the substrate
    ROADMAP item 5's per-tenant admission control meters against.
  - **Burn-rate monitoring**: per-deployment targets (``slo_ttft_ms``,
    ``slo_itl_ms``, ``slo_availability`` — ``serve.deployment(slo_config=
    {...})``, defaults from config) drive multi-window (5m/1h) burn-rate
    gauges ``ray_tpu_serve_slo_burn_rate{deployment,window,objective}``:
    breach fraction over the window divided by the error budget
    (1 - slo_availability).  Burn >1 means the budget is being consumed
    faster than the SLO allows (the SRE-workbook convention).

Cluster fold: each serving process publishes a throttled snapshot (sketch
points + wall-clock-aligned window buckets + recent ring tail) to the GCS
KV under ``slo:<reporter>``; ``state.serving_slo()`` merges the sketches
losslessly and sums the window buckets, so cluster p99s are TRUE p99s of
the combined stream and a single slow replica surfaces as a deployment-
level burn-rate breach.  Sketches additionally ride the ordinary throttled
``ReportMetrics`` push (they are runtime_metrics families), so Grafana and
``/metrics`` get them for free.

Disabled path (``serve_slo_enabled=False``): ``start_request`` returns a
shared no-op tracker and every module hook returns immediately — nothing
is booked anywhere (enforced by benchmarks/slo_overhead_bench.py:
<0.5 µs/token disabled, <5 µs enabled, CI-loose).

All clocks are injectable (``ServingSLOLedger(clock=..., wall=...)``) so
burn-rate math and window folds are testable without sleeping.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.analysis.lock_witness import make_lock
from ray_tpu_torch._private import flight_recorder, runtime_metrics
from ray_tpu_torch._private.latency_sketch import merge_points, summary

SLO_KV_PREFIX = "slo:"
SLO_CONF_KV_PREFIX = "sloconf:"
DEFAULT_TENANT = "default"
_TENANT_MAX_LEN = 64

# trailing windows the burn-rate monitor keeps (name -> seconds); buckets
# are wall-clock aligned so per-process buckets sum cluster-wide
WINDOWS: Dict[str, float] = {"5m": 300.0, "1h": 3600.0}
_BUCKET_S = 10.0
OBJECTIVES = ("ttft", "itl", "availability")

_SKETCH_FAMILIES = ("ray_tpu_serve_ttft_seconds",
                    "ray_tpu_serve_itl_seconds",
                    "ray_tpu_serve_stage_seconds")


def enabled() -> bool:
    from ray_tpu_torch._private.config import global_config

    return bool(global_config().serve_slo_enabled)


def extract_tenant(headers: Optional[dict] = None,
                   payload: Optional[Any] = None,
                   kwargs: Optional[dict] = None,
                   default: str = DEFAULT_TENANT) -> str:
    """Tenant id for a request: ``x-tenant`` header wins, then a ``tenant``
    field in the request dict / handle kwargs, else ``default``.  The value
    is length-capped — it becomes a metric tag, and tag spaces must stay
    bounded (a hostile header must not explode cardinality past the
    registry backstop)."""
    t = None
    if headers:
        t = headers.get("x-tenant")
    if not t and isinstance(payload, dict):
        t = payload.get("tenant")
    if not t and kwargs:
        t = kwargs.get("tenant")
        if not t:
            req = kwargs.get("request")
            if isinstance(req, dict):
                t = req.get("tenant")
    if not t or not isinstance(t, str):
        return default
    return t[:_TENANT_MAX_LEN]


# ---------------------------------------------------------------------------
# SLO targets (per-deployment; serve.deployment(slo_config=...) overrides)
# ---------------------------------------------------------------------------


def default_targets() -> Dict[str, float]:
    from ray_tpu_torch._private.config import global_config

    cfg = global_config()
    return {"slo_ttft_ms": cfg.serve_slo_ttft_ms,
            "slo_itl_ms": cfg.serve_slo_itl_ms,
            "slo_availability": cfg.serve_slo_availability}


# deployment -> explicit slo_config (local-mode registration and the
# controller-side cache; cluster-wide distribution rides the GCS KV)
_local_targets: Dict[str, Dict[str, float]] = {}
_targets_lock = make_lock("slo._targets_lock")


def register_targets(deployment: str,
                     slo_config: Optional[Dict[str, float]]) -> None:
    """Record a deployment's explicit SLO targets in THIS process (the
    controller also writes them to the GCS KV for other processes).
    ``None``/empty CLEARS a prior registration — a redeploy that dropped
    its slo_config must fall back to the config defaults, not keep being
    judged against targets the operator removed."""
    with _targets_lock:
        if slo_config:
            _local_targets[deployment] = dict(slo_config)
        else:
            _local_targets.pop(deployment, None)


def conf_kv_key(deployment: str) -> str:
    """Targets are keyed by DEPLOYMENT name (the ledger's booking tag has
    no app dimension); two apps sharing a deployment name share targets —
    keep serving deployment names unique per cluster."""
    return SLO_CONF_KV_PREFIX + deployment


def targets_for(deployment: str, kv_rows: Optional[dict] = None,
                gcs=None) -> Dict[str, float]:
    """Effective targets for a deployment: explicit local registration,
    then a ``sloconf:<deployment>`` KV row (``kv_rows`` lets folds pass a
    prefetch; ``gcs`` a channel for a one-off get), then config defaults."""
    out = default_targets()
    row = None
    with _targets_lock:
        row = _local_targets.get(deployment)
    if row is None and kv_rows is not None:
        row = kv_rows.get(deployment)
    if row is None and gcs is not None:
        try:
            blob = gcs.call("KVGet", {"key": conf_kv_key(deployment)},
                            timeout=2)
            if blob:
                row = json.loads(blob)
        except Exception:  # noqa: BLE001 — defaults beat a failed fetch
            row = None
    if row:
        for k in ("slo_ttft_ms", "slo_itl_ms", "slo_availability"):
            if row.get(k) is not None:
                out[k] = float(row[k])
    return out


# ---------------------------------------------------------------------------
# Burn-rate windows (wall-clock-aligned buckets; cluster-summable)
# ---------------------------------------------------------------------------


class _Windows:
    """Per-(deployment, objective) bucketed bad/total counts over the
    trailing max window.  Buckets are keyed by absolute wall-clock bucket
    index so snapshots from different processes sum correctly."""

    __slots__ = ("buckets",)

    def __init__(self):
        self.buckets: Dict[int, List[int]] = {}  # idx -> [bad, total]

    def record(self, now_wall: float, bad: bool) -> None:
        idx = int(now_wall // _BUCKET_S)
        b = self.buckets.get(idx)
        if b is None:
            b = self.buckets[idx] = [0, 0]
            horizon = idx - int(max(WINDOWS.values()) // _BUCKET_S) - 1
            for k in [k for k in self.buckets if k < horizon]:
                del self.buckets[k]
        if bad:
            b[0] += 1
        b[1] += 1

    def counts(self, now_wall: float, window_s: float) -> List[int]:
        from ray_tpu_torch._private import metrics_history

        return metrics_history.fold_window_counts(
            self.buckets, _BUCKET_S, window_s, now_wall)

    def serialize(self) -> List[List[int]]:
        return [[idx, b, t] for idx, (b, t) in sorted(self.buckets.items())]


def _burn(bad: int, total: int, availability: float) -> float:
    """Delegates to THE burn implementation (metrics_history.burn_rate) —
    the watch engine's burn rules and this ledger share one definition by
    construction; the old ≤2% parity test is now a regression pin on the
    window folds, not on two formulas."""
    from ray_tpu_torch._private import metrics_history

    return metrics_history.burn_rate(bad, total, availability)


def _window_burn_rates(window_buckets: Dict[str, Dict[int, List[int]]],
                       targets: Dict[str, float], now_wall: float) -> dict:
    """{objective: {window_name: burn}} from folded absolute buckets."""
    from ray_tpu_torch._private import metrics_history

    out: dict = {}
    for objective, buckets in window_buckets.items():
        per = out.setdefault(objective, {})
        for wname, wsec in WINDOWS.items():
            bad, total = metrics_history.fold_window_counts(
                buckets, _BUCKET_S, wsec, now_wall)
            per[wname] = metrics_history.burn_rate(
                bad, total, targets["slo_availability"])
            per.setdefault("_counts", {})[wname] = [bad, total]
    return out


# ---------------------------------------------------------------------------
# Request tracker
# ---------------------------------------------------------------------------


class _NoopTracker:
    """Shared do-nothing tracker: the disabled path's entire cost is one
    attribute lookup + an empty method call per lifecycle hook."""

    __slots__ = ()
    tenant = DEFAULT_TENANT
    deployment = ""

    def route(self, reason):
        return None

    def set_tenant(self, tenant):
        return None

    def first_token(self):
        return None

    def tokens(self, n=1):
        return None

    def finish(self, status="ok"):
        return None

    def abort(self):
        return None

    def shed(self):
        return None

    def specdec(self, proposed, accepted):
        return None


NOOP_TRACKER = _NoopTracker()


class RequestTracker:
    """One request's lifecycle, ingress view.  Methods are safe to call
    from any thread (the SSE pump vs the connection handler); terminal
    transitions are first-wins idempotent."""

    __slots__ = ("_ledger", "rid", "deployment", "tenant", "trace_id",
                 "t_ingress", "t_wall", "route_reason", "t_first",
                 "_t_last_tok", "itl_sum", "itl_n", "itl_max", "tok_count",
                 "status", "_done", "spec_proposed", "spec_accepted")

    def __init__(self, ledger: "ServingSLOLedger", rid: int, deployment: str,
                 tenant: str, trace_id: Optional[str]):
        self._ledger = ledger
        self.rid = rid
        self.deployment = deployment
        self.tenant = tenant
        self.trace_id = trace_id
        self.t_ingress = ledger.clock()
        self.t_wall = ledger.wall()
        self.route_reason: Optional[str] = None
        self.t_first: Optional[float] = None
        self._t_last_tok: Optional[float] = None
        self.itl_sum = 0.0
        self.itl_n = 0
        self.itl_max = 0.0
        self.tok_count = 0
        self.status: Optional[str] = None
        self._done = False
        self.spec_proposed = 0
        self.spec_accepted = 0
        flight_recorder.record("request", deployment,
                               (rid, "ingress", tenant))

    def set_tenant(self, tenant: str) -> None:
        """Late tenant attribution (handle kwargs seen after ingress):
        only before any latency was booked under the old tenant."""
        if tenant and self.t_first is None and self.status is None:
            self.tenant = tenant[:_TENANT_MAX_LEN]

    def route(self, reason: str) -> None:
        if self.route_reason is None:
            self.route_reason = reason
            flight_recorder.record("request", self.deployment,
                                   (self.rid, "route", reason))

    def first_token(self) -> None:
        if self.t_first is not None:
            return
        if not self.tok_count:
            self.tok_count = 1
        now = self._ledger.clock()
        self.t_first = now - self.t_ingress
        self._t_last_tok = now
        runtime_metrics.observe_ttft(self.deployment, self.tenant,
                                     self.t_first)
        flight_recorder.record(
            "request", self.deployment,
            (self.rid, "first_token", round(self.t_first * 1e3, 3)))

    def tokens(self, n: int = 1) -> None:
        """One streamed frame carrying ``n`` tokens: books n per-token ITL
        samples at (now - last)/n (a single weighted sketch insert).

        The FIRST frame books TTFT only: its tokens' latency is part of
        time-to-first-token, and booking the residual n-1 tokens at the
        ~0 gap between first_token() and now would drag the ITL
        distribution's low quantiles toward zero."""
        if n <= 0:
            return
        self.tok_count += n
        if self.t_first is None:
            self.first_token()
            return
        now = self._ledger.clock()
        itl = max(now - self._t_last_tok, 0.0) / n
        self._t_last_tok = now
        self.itl_sum += itl * n
        self.itl_n += n
        if itl > self.itl_max:
            self.itl_max = itl
        runtime_metrics.observe_itl(self.deployment, self.tenant, itl, n)

    def specdec(self, proposed: int, accepted: int) -> None:
        """Attach the request's speculative-decoding acceptance (drafted
        vs accepted token counts, from the engine's per-request stats) —
        surfaces as ``specdec_accept_rate`` on the recent-request row.
        Requests that never speculated (layer off, degraded, non-paged
        engine) never call this, so their rows carry no field."""
        if proposed > 0:
            self.spec_proposed = int(proposed)
            self.spec_accepted = int(accepted)

    def finish(self, status: str = "ok") -> None:
        if self._done:
            return
        self._done = True
        self.status = status
        self._ledger._complete(self)

    def abort(self) -> None:
        """Terminal ``aborted`` lifecycle event: the client dropped the
        stream (SSE disconnect) mid-request."""
        self.finish("aborted")

    def shed(self) -> None:
        """Terminal ``shed``: admission control refused the request."""
        self.finish("shed")


# ---------------------------------------------------------------------------
# Ledger
# ---------------------------------------------------------------------------


class ServingSLOLedger:
    """Per-process SLO accounting: trackers, burn windows, recent ring,
    throttled KV/gauge publication.  One instance per process in
    production (``get_ledger()``); tests construct their own with injected
    clocks."""

    def __init__(self, clock=None, wall=None):
        self.clock = clock or time.monotonic
        self.wall = wall or time.time
        self._lock = make_lock("ServingSLOLedger._lock")
        self._rids = itertools.count(1)
        # (deployment, objective) -> _Windows
        self._windows: Dict[tuple, _Windows] = {}
        # deployment -> tenant -> status -> count
        self._status: Dict[str, Dict[str, Dict[str, int]]] = {}
        from ray_tpu_torch._private.config import global_config

        cfg = global_config()
        self._recent_cap = int(cfg.serve_slo_recent_capacity)
        self._recent: List[dict] = []
        # deployment -> [proposed, accepted] speculative-decoding token
        # totals (engine-side bookings; empty unless speculation runs)
        self._specdec: Dict[str, List[int]] = {}
        self._publish_interval = float(cfg.serve_slo_publish_interval_s)
        self._recent_publish = int(cfg.serve_slo_recent_publish)
        self._last_publish = float("-inf")

    # -- request entry points ----------------------------------------------

    def start_request(self, deployment: str, tenant: str = DEFAULT_TENANT,
                      trace_id: Optional[str] = None) -> RequestTracker:
        return RequestTracker(self, next(self._rids), deployment,
                              tenant or DEFAULT_TENANT, trace_id)

    def _complete(self, tr: RequestTracker) -> None:
        now_wall = self.wall()
        dur = self.clock() - tr.t_ingress
        targets = targets_for(tr.deployment)
        runtime_metrics.inc_slo_request(tr.deployment, tr.tenant, tr.status)
        if tr.t_first is None and tr.status == "ok":
            # unary completion: the whole call is the first (and only)
            # "token" — TTFT == completion latency, the reference's
            # request-latency view
            tr.t_first = dur
            runtime_metrics.observe_ttft(tr.deployment, tr.tenant, dur)
        flight_recorder.record(
            "request", tr.deployment,
            (tr.rid, tr.status, tr.tenant, round(dur * 1e3, 3)))
        with self._lock:
            if tr.t_first is not None:
                self._win(tr.deployment, "ttft").record(
                    now_wall, tr.t_first > targets["slo_ttft_ms"] / 1e3)
            if tr.itl_n:
                mean_itl = tr.itl_sum / tr.itl_n
                self._win(tr.deployment, "itl").record(
                    now_wall, mean_itl > targets["slo_itl_ms"] / 1e3)
            if tr.status in ("ok", "error", "shed"):
                # aborted = the CLIENT hung up; that is not an availability
                # failure of the deployment
                self._win(tr.deployment, "availability").record(
                    now_wall, tr.status != "ok")
            if tr.status in ("ok", "error"):
                # admitted-work failure signal: sheds are excluded so the
                # admission gate's burn breaker (which 503s everyone on
                # this) cannot latch on its own refusals — one tenant
                # eating 429s must not starve the tenants that WERE
                # admitted
                self._win(tr.deployment, "service").record(
                    now_wall, tr.status == "error")
            st = self._status.setdefault(
                tr.deployment, {}).setdefault(tr.tenant, {})
            st[tr.status] = st.get(tr.status, 0) + 1
            row = {
                "rid": tr.rid, "deployment": tr.deployment,
                "tenant": tr.tenant, "status": tr.status,
                "time": tr.t_wall, "duration_s": round(dur, 6),
                "tokens": tr.tok_count,
            }
            if tr.route_reason:
                row["route"] = tr.route_reason
            if tr.t_first is not None:
                row["ttft_s"] = round(tr.t_first, 6)
            if tr.itl_n:
                row["itl_mean_s"] = round(tr.itl_sum / tr.itl_n, 6)
                row["itl_max_s"] = round(tr.itl_max, 6)
            if tr.spec_proposed:
                row["specdec_accept_rate"] = round(
                    tr.spec_accepted / tr.spec_proposed, 4)
            if tr.trace_id:
                row["trace_id"] = tr.trace_id
            self._recent.append(row)
            if len(self._recent) > self._recent_cap:
                del self._recent[:len(self._recent) - self._recent_cap]
        self.maybe_publish()

    def _win(self, deployment: str, objective: str) -> _Windows:
        w = self._windows.get((deployment, objective))
        if w is None:
            w = self._windows[(deployment, objective)] = _Windows()
        return w

    def note_specdec(self, deployment: str, proposed: int,
                     accepted: int) -> None:
        """Engine-side speculative acceptance booking (per collect, under
        the ledger lock only — the engine calls this from its step lock,
        so like record_stage there is deliberately no publish attempt)."""
        with self._lock:
            tot = self._specdec.setdefault(deployment, [0, 0])
            tot[0] += int(proposed)
            tot[1] += int(accepted)

    def record_stage(self, deployment: str, stage: str,
                     seconds: float) -> None:
        """Stage booking only (sketch + flight ring) — deliberately NO
        publish attempt: engines call this under their step lock, and a
        KV RPC there would stall the decode batch.  Publication piggybacks
        on request completions (ingress) and the replica's per-request
        hook (serve/_private/replica.py)."""
        runtime_metrics.observe_serve_stage(deployment, stage, seconds)
        flight_recorder.record("request", deployment,
                               (stage, round(seconds * 1e3, 3)))

    # -- local views --------------------------------------------------------

    def burn_rates(self, deployment: str) -> dict:
        """{objective: {window: burn}} from THIS process's windows."""
        targets = targets_for(deployment)
        now = self.wall()
        with self._lock:
            buckets = {obj: dict(w.buckets)
                       for (dep, obj), w in self._windows.items()
                       if dep == deployment}
        rates = _window_burn_rates(buckets, targets, now)
        for per in rates.values():
            per.pop("_counts", None)
        return rates

    def recent(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            rows = list(self._recent)
        return rows[-limit:] if limit else rows

    def row(self) -> dict:
        """This process's publishable snapshot (the ``slo:<reporter>`` KV
        value): serving sketch points, wall-aligned window buckets, status
        counts, recent tail."""
        points = []
        from ray_tpu_torch.util.metrics import _REGISTRY

        for name in _SKETCH_FAMILIES:
            m = _REGISTRY.get(name)
            if m is not None:
                points.extend(m._snapshot())
        with self._lock:
            windows = {}
            for (dep, obj), w in self._windows.items():
                windows.setdefault(dep, {})[obj] = w.serialize()
            status = {d: {t: dict(s) for t, s in ts.items()}
                      for d, ts in self._status.items()}
            recent = list(self._recent[-self._recent_publish:])
            specdec = {d: list(t) for d, t in self._specdec.items()}
        row = {"time": self.wall(), "points": points, "windows": windows,
               "status": status, "recent": recent}
        if specdec:
            row["specdec"] = specdec
        return row

    def snapshot(self) -> dict:
        """Local fold (bench.py, local-testing mode): same shape as
        ``state.serving_slo()`` but over this process only."""
        return fold_rows([self.row()], now_wall=self.wall())

    # -- publication --------------------------------------------------------

    def maybe_publish(self, force: bool = False) -> bool:
        """Throttled publication.  The KVPut is a blocking GCS RPC and the
        throttle fires from request-completion paths — including the
        proxy's asyncio event loop — so the periodic publish runs on a
        short-lived daemon thread (one per interval, exits after the RPC);
        ``force=True`` (tests, teardown flushes) publishes synchronously."""
        now = self.clock()
        with self._lock:
            if not force and now - self._last_publish < self._publish_interval:
                return False
            self._last_publish = now
        if force:
            try:
                self._publish()
                return True
            except Exception:  # noqa: BLE001 — metering must never take
                return False   # the serving path down

        def _bg():
            try:
                self._publish()
            except Exception:  # noqa: BLE001 — publish retries on the next completion
                pass

        threading.Thread(target=_bg, daemon=True,
                         name="serve-slo-publish").start()
        return True

    def _publish(self) -> None:
        # burn gauges from this process's windows (the cluster-authoritative
        # fold lives in state.serving_slo(); the gauge is the per-ingress
        # live view Grafana alerts on)
        now = self.wall()
        with self._lock:
            deps = {dep for dep, _obj in self._windows}
        for dep in deps:
            targets = targets_for(dep)
            with self._lock:
                buckets = {obj: dict(w.buckets)
                           for (d, obj), w in self._windows.items()
                           if d == dep}
            for objective, per in _window_burn_rates(
                    buckets, targets, now).items():
                for wname in WINDOWS:
                    runtime_metrics.set_slo_burn_rate(
                        dep, wname, objective, per[wname])
        from ray_tpu_torch.util import metrics as _metrics

        gcs = _metrics._gcs_channel()
        if gcs is None:
            return
        gcs.call("KVPut", {
            "key": SLO_KV_PREFIX + _metrics.reporter_id(),
            "value": json.dumps(self.row(), default=str),
        }, timeout=5)


# ---------------------------------------------------------------------------
# Cluster fold (state.serving_slo / /api/slo / bench)
# ---------------------------------------------------------------------------


def fold_rows(rows: List[dict], now_wall: Optional[float] = None,
              conf_rows: Optional[dict] = None,
              burn_alert: Optional[float] = None) -> dict:
    """Merge per-process ``slo:*`` rows into the cluster SLO report:
    per deployment, TTFT/ITL percentiles (overall + per tenant, lossless
    sketch merge), per-stage percentiles, status counts, burn rates per
    objective and window, and the breach list."""
    if now_wall is None:
        now_wall = time.time()
    if burn_alert is None:
        from ray_tpu_torch._private.config import global_config

        burn_alert = global_config().serve_slo_burn_alert
    by_dep: Dict[str, dict] = {}
    # sketch points grouped (family, deployment, split)
    groups: Dict[tuple, List[dict]] = {}
    window_buckets: Dict[str, Dict[str, Dict[int, List[int]]]] = {}
    status: Dict[str, Dict[str, Dict[str, int]]] = {}
    specdec: Dict[str, List[int]] = {}
    for row in rows:
        for dep, (p, a) in (row.get("specdec") or {}).items():
            tot = specdec.setdefault(dep, [0, 0])
            tot[0] += int(p)
            tot[1] += int(a)
        for p in row.get("points", ()):
            tags = p.get("tags", {})
            dep = tags.get("deployment", "?")
            split = tags.get("tenant") or tags.get("stage") or "?"
            groups.setdefault((p["name"], dep, split), []).append(p)
        for dep, objs in (row.get("windows") or {}).items():
            for obj, buckets in objs.items():
                fold = window_buckets.setdefault(dep, {}).setdefault(obj, {})
                for idx, bad, total in buckets:
                    cur = fold.setdefault(int(idx), [0, 0])
                    cur[0] += int(bad)
                    cur[1] += int(total)
        for dep, tenants in (row.get("status") or {}).items():
            d = status.setdefault(dep, {})
            for tenant, counts in tenants.items():
                t = d.setdefault(tenant, {})
                for k, v in counts.items():
                    t[k] = t.get(k, 0) + int(v)
    field_of = {"ray_tpu_serve_ttft_seconds": "ttft",
                "ray_tpu_serve_itl_seconds": "itl"}
    overall: Dict[tuple, List[dict]] = {}
    for (name, dep, split), points in groups.items():
        merged = merge_points(points)
        if merged is None:
            continue
        d = by_dep.setdefault(dep, {"tenants": {}, "stages": {}})
        if name == "ray_tpu_serve_stage_seconds":
            d["stages"][split] = summary(merged)
        else:
            field = field_of[name]
            d["tenants"].setdefault(split, {})[field] = summary(merged)
            overall.setdefault((name, dep), []).append(merged)
    for (name, dep), points in overall.items():
        merged = merge_points(points)
        if merged is not None:
            by_dep[dep][field_of[name]] = summary(merged)
    breaches: List[dict] = []
    # union of sources: a deployment whose requests ALL failed before a
    # first token has window buckets and status counts but zero sketch
    # points — the hard-down case must still fold (and breach)
    for dep in set(by_dep) | set(window_buckets) | set(status) | set(specdec):
        d = by_dep.setdefault(dep, {"tenants": {}, "stages": {}})
        targets = targets_for(dep, kv_rows=conf_rows)
        d["targets"] = targets
        d["status"] = status.get(dep, {})
        if dep in specdec:
            p, a = specdec[dep]
            d["specdec"] = {"proposed": p, "accepted": a,
                            "acceptance_rate": (a / p) if p else 0.0}
        rates = _window_burn_rates(window_buckets.get(dep, {}), targets,
                                   now_wall)
        d["burn_rate"] = {}
        for objective, per in rates.items():
            counts = per.pop("_counts", {})
            d["burn_rate"][objective] = per
            for wname, rate in per.items():
                if rate > burn_alert:
                    breaches.append({
                        "deployment": dep, "objective": objective,
                        "window": wname, "burn_rate": round(rate, 3),
                        "bad": counts.get(wname, [0, 0])[0],
                        "total": counts.get(wname, [0, 0])[1],
                    })
    breaches.sort(key=lambda b: -b["burn_rate"])
    return {"time": now_wall, "deployments": by_dep, "breaches": breaches}


def fold_recent(rows: List[dict], limit: int = 100) -> List[dict]:
    out: List[dict] = []
    for row in rows:
        out.extend(row.get("recent") or ())
    out.sort(key=lambda r: r.get("time", 0.0))
    return out[-limit:]


# ---------------------------------------------------------------------------
# Process-global ledger + thread-local tracker context
# ---------------------------------------------------------------------------

_ledger: Optional[ServingSLOLedger] = None
_ledger_lock = make_lock("slo._ledger_lock")


def get_ledger() -> ServingSLOLedger:
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = ServingSLOLedger()
    return _ledger


def reset_ledger() -> None:
    """Testing hook: drop the process ledger (fresh windows/recent)."""
    global _ledger
    with _ledger_lock:
        _ledger = None


def start_request(deployment: str, tenant: str = DEFAULT_TENANT,
                  trace_id: Optional[str] = None):
    """Ingress entry point; returns the NOOP tracker when the layer is
    disabled (every downstream hook then costs one no-op call)."""
    if not enabled():
        return NOOP_TRACKER
    return get_ledger().start_request(deployment, tenant, trace_id)


def record_stage(deployment: Optional[str], stage: str,
                 seconds: float) -> None:
    """Replica/engine-side stage booking under the deployment's label
    (``set_slo_label`` threading).  No label (direct engine use outside
    serve) or disabled layer => books nothing."""
    if deployment is None or not enabled():
        return
    get_ledger().record_stage(deployment, stage, seconds)


def note_specdec(deployment: Optional[str], proposed: int,
                 accepted: int) -> None:
    """Engine-side speculative acceptance fold (``set_slo_label``
    threading, like record_stage).  No label or disabled layer => books
    nothing."""
    if deployment is None or not enabled():
        return
    get_ledger().note_specdec(deployment, proposed, accepted)


def note_specdec_request(proposed: int, accepted: int) -> None:
    """Attach a finished request's speculative acceptance to the active
    tracker (the serving path reads the engine's per-request stats at
    stream completion) — surfaces as the recent-row acceptance field.

    Scope: trackers are thread-local and ingress-side, so the field
    reaches the row only when the completion is consumed ON the thread
    that activated the tracker — local-testing-mode streaming, or
    handle-level callers wrapping consumption in ``slo.activate(tr)``.
    A cluster-mode replica runs in another process (current_tracker()
    is None there) and books nothing here; the CLUSTER-wide acceptance
    signals are the per-deployment ledger fold (``note_specdec`` →
    ``state.serving_slo()`` ``deployments[dep]["specdec"]``) and the
    ``ray_tpu_serve_specdec_*`` families, which work everywhere."""
    tr = current_tracker()
    if tr is not None:
        tr.specdec(proposed, accepted)


def maybe_publish() -> bool:
    """Throttled publish hook for processes that only record stages (serve
    replicas): called per handled request OUTSIDE any engine lock."""
    if not enabled() or _ledger is None:
        return False
    return _ledger.maybe_publish()


_tls = threading.local()


def current_tracker() -> Optional[RequestTracker]:
    t = getattr(_tls, "tracker", None)
    return t if isinstance(t, RequestTracker) else None


@contextmanager
def activate(tracker):
    """Bind ``tracker`` to this thread so downstream hops (the router's
    decision recording, kwargs tenant extraction) attribute to it."""
    prev = getattr(_tls, "tracker", None)
    _tls.tracker = tracker
    try:
        yield tracker
    finally:
        _tls.tracker = prev


def note_route(reason: str) -> None:
    """Router decision forensics: the reason counter family plus
    attribution to the active request's lifecycle.  Gated on the layer's
    switch — serve_slo_enabled=False books nothing anywhere, including
    here (the documented invariant)."""
    if not enabled():
        return
    runtime_metrics.inc_route_decision(reason)
    tr = current_tracker()
    if tr is not None:
        tr.route(reason)


def note_request_args(args: tuple, kwargs: Optional[dict]) -> None:
    """Handle-kwarg tenant extraction: a ``tenant`` field in the call's
    kwargs / leading request dict re-attributes the active tracker (the
    ISSUE's 'handle kwarg' path, for callers not fronted by HTTP)."""
    tr = current_tracker()
    if tr is None or tr.tenant != DEFAULT_TENANT:
        return
    payload = args[0] if args and isinstance(args[0], dict) else None
    t = extract_tenant(payload=payload, kwargs=kwargs)
    if t != DEFAULT_TENANT:
        tr.set_tenant(t)
