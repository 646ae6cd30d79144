"""In-runtime metrics history + declarative watch engine.

The metrics plane used to be snapshot-only: ``HandleCollectMetrics``
folded the current reporter points and forgot them, so nothing in the
runtime could answer "what was queue depth 5 minutes ago" or "how fast is
this counter moving" — the exact signals the SLO-feedback autoscaler and
load shedder (ROADMAP item 1) must act on.  This module keeps a
bounded-memory time-series of the CLUSTER AGGREGATE inside the GCS (no
external Prometheus dependency, matching the control-plane-at-scale
posture of arxiv 2510.20171) and evaluates declarative alert rules over
it on the GCS health tick.

Three pieces:

``MetricsHistory`` — a fixed-memory two-resolution ring per
(family, tagset): raw buckets (default 10 s for ~15 min) and rollup
buckets (default 60 s for ~4 h).  Counters are stored as PER-BUCKET
DELTAS against the last observed cluster total (Prometheus increase
semantics: a total that stepped DOWN is a restart and books the new total
as the delta), so reporter restarts and evictions never produce negative
rates.  Gauges are last-write-wins within a bucket.  Sketches store the
per-bucket DELTA of the cumulative DDSketch bins, so merging any window's
buckets reproduces the combined observation stream losslessly
(``quantile_over_time`` is the true quantile of that window within the
sketch's relative-accuracy bound).  Memory is bounded twice over: rings
prune to their retention horizon on every insert, and a hard global byte
cap (counter-enforced — no wall clock involved) LRU-evicts whole tagsets
when adversarial tag churn would otherwise grow the store without bound.

Query operators — ``rate()``, ``delta()``, ``avg_over_time()``,
``quantile_over_time()`` over a queried series; surfaced as
``state.metric_history(...)`` / ``/api/metric_history``.

``WatchEngine`` — declarative ``WatchRule``s (threshold, rate-of-change,
reporter absence, and generalized burn-rate = breach-fraction over
short+long windows divided by the error budget, the multiwindow alerting
shape hand-built for serve SLOs) evaluated with injectable clocks on
the GCS tick.  Rules carry ``for_s``/``clear_for_s`` hysteresis; firing
and clearing transitions land in the cluster event log, bump
``ray_tpu_watch_alerts_total{rule,state}`` and publish on the tree-pubsub
``ALERT`` channel any subscriber (the future autoscaler, the serve
controller) can react to.  A built-in rule pack covers the serving and
training signals the roadmap's enforcement PR needs.

Everything here is plain dict/float arithmetic behind one lock; the
``metrics_history_enabled=False`` path constructs NOTHING (the GCS keeps
``history is None`` and the per-push cost is one attribute read + None
check — benchmarks/watch_overhead_bench.py gates it).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.analysis.lock_witness import make_lock
from ray_tpu_torch._private.config import RayTpuConfig, global_config
from ray_tpu_torch._private.latency_sketch import LatencySketch

# ---------------------------------------------------------------------------
# Byte accounting (counter-enforced cap: these constants ARE the meter)
# ---------------------------------------------------------------------------

# conservative per-object estimates for the cap meter; deliberately simple
# integers so the cap check is pure counting (no sys.getsizeof walks, no
# wall clock) and the adversarial-churn bench can assert it exactly
_SERIES_BASE_BYTES = 512       # key tuple, per-series dicts, bookkeeping
_SCALAR_SAMPLE_BYTES = 64      # one {bucket_idx: float} entry
_SKETCH_SAMPLE_BYTES = 128     # one bucket's dict sans bins
_SKETCH_BIN_BYTES = 16         # one [index, count] pair


def _tagset(tags: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


def _tags_match(series_tags: Dict[str, str],
                want: Optional[Dict[str, Any]]) -> bool:
    """Subset match; a wanted value may be a str or a tuple/list of
    accepted strs (burn rules select e.g. status in (error, shed))."""
    if not want:
        return True
    for k, v in want.items():
        have = series_tags.get(k)
        if isinstance(v, (tuple, list, set, frozenset)):
            if have not in v:
                return False
        elif have != v:
            return False
    return True


class _Series:
    """One (family, tagset) history: two delta/value rings + fold state."""

    __slots__ = ("kind", "tags", "accuracy", "raw", "rollup",
                 "last_total", "last_count", "last_sum", "last_bins",
                 "last_zero", "last_min", "last_max", "nbytes")

    def __init__(self, kind: str, tags: Dict[str, str],
                 accuracy: Optional[float] = None):
        self.kind = kind
        self.tags = tags
        self.accuracy = accuracy
        self.raw: Dict[int, Any] = {}      # bucket_idx -> value/delta/dict
        self.rollup: Dict[int, Any] = {}
        self.last_total: Optional[float] = None   # counter fold state
        self.last_count: Optional[float] = None   # histogram/sketch count
        self.last_sum: float = 0.0
        self.last_bins: Dict[int, int] = {}       # sketch cumulative bins
        self.last_zero: int = 0
        self.last_min: float = 0.0
        self.last_max: float = 0.0
        self.nbytes: int = _SERIES_BASE_BYTES

    def ring(self, resolution: str) -> Dict[int, Any]:
        return self.raw if resolution == "raw" else self.rollup


def _sample_bytes(kind: str, value: Any) -> int:
    if kind == "sketch":
        return _SKETCH_SAMPLE_BYTES + _SKETCH_BIN_BYTES * len(
            value.get("bins", ()))
    if kind == "histogram":
        return 2 * _SCALAR_SAMPLE_BYTES  # {sum, count}
    return _SCALAR_SAMPLE_BYTES


class MetricsHistory:
    """Bounded two-resolution history of the cluster metric aggregate.

    ``fold(points)`` takes the output of the GCS CollectMetrics aggregate
    and books one observation per (family, tagset).  ``fold_due()`` is the
    cheap per-push gate (one clock read + compare) — the GCS calls it on
    every throttled ReportMetrics push and only pays the real fold at most
    once per ``metrics_history_fold_interval_s``.
    """

    def __init__(self, config: Optional[RayTpuConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        cfg = config or global_config()
        self._clock = clock
        self._wall = wall
        self._fold_interval = max(0.0, cfg.metrics_history_fold_interval_s)
        self.raw_step = max(1.0, cfg.metrics_history_raw_step_s)
        self.raw_retention = max(self.raw_step,
                                 cfg.metrics_history_raw_retention_s)
        self.rollup_step = max(self.raw_step,
                               cfg.metrics_history_rollup_step_s)
        self.rollup_retention = max(self.rollup_step,
                                    cfg.metrics_history_rollup_retention_s)
        self.max_bytes = max(64 * 1024, cfg.metrics_history_max_bytes)
        # per-family retention overrides: "family=seconds,family2=seconds"
        # (shrink-only: the global retentions are the memory contract)
        self._family_retention: Dict[str, float] = {}
        spec = cfg.metrics_history_family_retention
        if spec:
            for part in spec.split(","):
                name, _, secs = part.partition("=")
                try:
                    self._family_retention[name.strip()] = float(secs)
                except ValueError:
                    continue  # malformed entry: ignore, keep the default
        # (family, tagset) -> _Series; insertion order IS the LRU order
        # (touched series are re-appended on fold)
        self._series: Dict[Tuple[str, tuple], _Series] = {}
        self._bytes = 0
        self._last_fold = -math.inf
        self._folds = 0
        self._evictions = 0
        self._lock = make_lock("MetricsHistory._lock")

    # -- fold ---------------------------------------------------------------

    def fold_due(self) -> bool:
        """Cheap per-push gate: has the fold interval elapsed?"""
        return self._clock() - self._last_fold >= self._fold_interval

    def fold(self, points: List[dict],
             now_wall: Optional[float] = None) -> None:
        """Book one cluster-aggregate observation into both rings."""
        now = self._wall() if now_wall is None else now_wall
        raw_idx = int(now // self.raw_step)
        rollup_idx = int(now // self.rollup_step)
        with self._lock:
            self._last_fold = self._clock()
            self._folds += 1
            for p in points:
                try:
                    self._fold_point(p, raw_idx, rollup_idx)
                except (KeyError, TypeError, ValueError):
                    continue  # one malformed point must not poison the fold
            # hard global cap: LRU-evict whole tagsets (oldest-folded
            # first) until under budget; pure counting, no clocks
            while self._bytes > self.max_bytes and len(self._series) > 1:
                key, s = next(iter(self._series.items()))
                del self._series[key]
                self._bytes -= s.nbytes
                self._evictions += 1

    def _fold_point(self, p: dict, raw_idx: int, rollup_idx: int) -> None:
        kind = p["kind"]
        key = (p["name"], _tagset(p.get("tags")))
        s = self._series.get(key)
        if s is None:
            s = _Series(kind, dict(p.get("tags") or {}), p.get("accuracy"))
            self._series[key] = s
            self._bytes += s.nbytes
        else:
            # LRU touch: re-append so eviction order tracks fold recency
            del self._series[key]
            self._series[key] = s

        if kind == "gauge":
            self._put(s, "raw", raw_idx, float(p["value"]), replace=True)
            self._put(s, "rollup", rollup_idx, float(p["value"]),
                      replace=True)
        elif kind == "counter":
            total = float(p["value"])
            last = s.last_total
            s.last_total = total
            if last is None:
                return  # first sight: baseline only, no delta to book
            # Prometheus increase semantics: a total below the baseline is
            # a reset — the new total IS the post-reset increase.  Either
            # way the booked delta is never negative.
            delta = total - last if total >= last else total
            self._put(s, "raw", raw_idx, delta, add=True)
            self._put(s, "rollup", rollup_idx, delta, add=True)
        elif kind == "histogram":
            count, tot = float(p["count"]), float(p["sum"])
            lastc = s.last_count
            lasts = s.last_sum
            s.last_count, s.last_sum = count, tot
            if lastc is None:
                return
            if count >= lastc:
                d = {"count": count - lastc, "sum": tot - lasts}
            else:  # reset
                d = {"count": count, "sum": tot}
            # each ring gets its OWN dict: first insert stores the object
            # and later merges mutate it in place, so sharing one across
            # rings would double-book into whichever bucket was inserted
            # first
            self._put(s, "raw", raw_idx, dict(d), add=True)
            self._put(s, "rollup", rollup_idx, dict(d), add=True)
        elif kind == "sketch":
            self._fold_sketch(s, p, raw_idx, rollup_idx)

    def _fold_sketch(self, s: _Series, p: dict, raw_idx: int,
                     rollup_idx: int) -> None:
        bins = {int(i): int(c) for i, c in p.get("bins", ())}
        count = int(p.get("count", 0))
        zero = int(p.get("zero", 0))
        tot = float(p.get("sum", 0.0))
        if s.last_count is None or count < s.last_count:
            # first sight or reset: the cumulative state IS the delta
            d_bins, d_zero = dict(bins), zero
            d_count, d_sum = count, tot
        else:
            d_bins = {}
            for i, c in bins.items():
                d = c - s.last_bins.get(i, 0)
                if d > 0:
                    d_bins[i] = d
            d_zero = max(0, zero - s.last_zero)
            d_count = count - s.last_count
            d_sum = tot - s.last_sum
        s.last_bins, s.last_zero = bins, zero
        s.last_count, s.last_sum = count, tot
        s.last_min = float(p.get("min", 0.0))
        s.last_max = float(p.get("max", 0.0))
        if s.accuracy is None:
            s.accuracy = p.get("accuracy")
        if d_count <= 0 and not d_bins and not d_zero:
            return
        # per-ring copies (incl. the bins dict) for the same reason as the
        # histogram path: inserted dicts are merged into in place later
        for resolution, idx in (("raw", raw_idx), ("rollup", rollup_idx)):
            self._put(s, resolution, idx,
                      {"bins": dict(d_bins), "zero": d_zero,
                       "count": d_count, "sum": d_sum}, add=True)

    def _put(self, s: _Series, resolution: str, idx: int, value: Any,
             replace: bool = False, add: bool = False) -> None:
        ring = s.ring(resolution)
        cur = ring.get(idx)
        if cur is None or replace:
            if cur is None:
                self._prune(s, resolution, idx)
                cost = _sample_bytes(s.kind, value)
                s.nbytes += cost
                self._bytes += cost
            ring[idx] = value
        elif add:
            if s.kind == "sketch":
                before = _sample_bytes("sketch", cur)
                for i, c in value["bins"].items():
                    cur["bins"][i] = cur["bins"].get(i, 0) + c
                cur["zero"] += value["zero"]
                cur["count"] += value["count"]
                cur["sum"] += value["sum"]
                grown = _sample_bytes("sketch", cur) - before
                s.nbytes += grown
                self._bytes += grown
            elif s.kind == "histogram":
                cur["count"] += value["count"]
                cur["sum"] += value["sum"]
            else:
                ring[idx] = cur + value

    def _prune(self, s: _Series, resolution: str, now_idx: int) -> None:
        step = self.raw_step if resolution == "raw" else self.rollup_step
        retention = (self.raw_retention if resolution == "raw"
                     else self.rollup_retention)
        ring = s.ring(resolution)
        horizon = now_idx - int(retention // step)
        for k in [k for k in ring if k <= horizon]:
            cost = _sample_bytes(s.kind, ring.pop(k))
            s.nbytes -= cost
            self._bytes -= cost

    # -- introspection ------------------------------------------------------

    def bytes_estimate(self) -> int:
        return self._bytes

    def series_count(self) -> int:
        return len(self._series)

    def stats(self) -> dict:
        with self._lock:
            return {"series": len(self._series), "bytes": self._bytes,
                    "max_bytes": self.max_bytes, "folds": self._folds,
                    "evictions": self._evictions,
                    "raw_step_s": self.raw_step,
                    "rollup_step_s": self.rollup_step}

    # -- query --------------------------------------------------------------

    def _retention_for(self, family: str, resolution: str) -> float:
        base = (self.raw_retention if resolution == "raw"
                else self.rollup_retention)
        override = self._family_retention.get(family)
        return min(base, override) if override else base

    def query(self, family: str, tags: Optional[Dict[str, Any]] = None,
              window_s: Optional[float] = None,
              step_s: Optional[float] = None,
              now: Optional[float] = None) -> List[dict]:
        """Matching series over the trailing window, one dict per tagset:
        ``{family, tags, kind, step_s, resolution, samples: [[t, v], ...]}``
        where t is the bucket START wall time; counters/histograms carry
        per-bucket deltas, gauges the bucket's last value, sketches the
        bucket's delta-sketch dict."""
        now = self._wall() if now is None else now
        window = window_s or self.raw_retention
        # resolution choice: raw unless the caller's window or step needs
        # the rollup ring
        resolution = "raw"
        if (window > self.raw_retention
                or (step_s is not None and step_s >= self.rollup_step)):
            resolution = "rollup"
        step = self.raw_step if resolution == "raw" else self.rollup_step
        window = min(window, self._retention_for(family, resolution))
        lo = int((now - window) // step)
        hi = int(now // step)
        out = []
        with self._lock:
            for (name, _ts), s in self._series.items():
                if name != family or not _tags_match(s.tags, tags):
                    continue
                ring = s.ring(resolution)
                samples = [[idx * step, ring[idx]]
                           for idx in sorted(ring) if lo < idx <= hi]
                out.append({
                    "family": family, "tags": dict(s.tags),
                    "kind": s.kind, "step_s": step,
                    "resolution": resolution, "accuracy": s.accuracy,
                    "samples": samples,
                })
        return out

    def query_api(self, req: dict) -> dict:
        """The MetricHistory RPC body: query + optional operator."""
        family = req.get("family")
        if not family:
            with self._lock:
                fams = sorted({name for name, _ in self._series})
            return {"enabled": True, "families": fams,
                    "stats": self.stats()}
        series = self.query(family, req.get("tags"), req.get("window_s"),
                            req.get("step_s"))
        out = {"enabled": True, "family": family, "series": series}
        op = req.get("op")
        if op:
            q = req.get("q", 0.99)
            results = []
            for s in series:
                if op == "rate":
                    v = rate(s)
                elif op == "delta":
                    v = delta(s)
                elif op == "avg_over_time":
                    v = avg_over_time(s)
                elif op == "quantile_over_time":
                    v = quantile_over_time(s, q)
                else:
                    return {"enabled": True, "family": family,
                            "error": f"unknown op {op!r}"}
                results.append({"tags": s["tags"], "value": v})
            out["op"] = op
            out["results"] = results
        return out


# ---------------------------------------------------------------------------
# Series operators (PromQL-shaped, over one queried series dict)
# ---------------------------------------------------------------------------


def delta(series: dict) -> float:
    """Counters/histograms: total increase over the window (sum of bucket
    deltas — non-negative by construction).  Gauges: last minus first."""
    samples = series.get("samples") or []
    if not samples:
        return 0.0
    kind = series.get("kind")
    if kind == "gauge":
        return float(samples[-1][1]) - float(samples[0][1])
    if kind == "histogram":
        return float(sum(v["count"] for _, v in samples))
    if kind == "sketch":
        return float(sum(v["count"] for _, v in samples))
    return float(sum(v for _, v in samples))


def rate(series: dict) -> float:
    """Per-second rate over the span the samples actually cover (each
    bucket's delta accrued over its step, so the span includes the last
    bucket's full step)."""
    samples = series.get("samples") or []
    if not samples:
        return 0.0
    step = float(series.get("step_s") or 1.0)
    if series.get("kind") == "gauge":
        if len(samples) < 2:
            return 0.0
        span = samples[-1][0] - samples[0][0]
        return delta(series) / span if span > 0 else 0.0
    span = samples[-1][0] + step - samples[0][0]
    return delta(series) / span if span > 0 else 0.0


def avg_over_time(series: dict) -> float:
    """Gauges: mean of bucket values.  Histograms/sketches: mean observed
    value over the window (delta sum / delta count).  Counters: mean
    per-bucket delta."""
    samples = series.get("samples") or []
    if not samples:
        return 0.0
    kind = series.get("kind")
    if kind in ("histogram", "sketch"):
        count = sum(v["count"] for _, v in samples)
        return (sum(v["sum"] for _, v in samples) / count) if count else 0.0
    return sum(float(v) for _, v in samples) / len(samples)


def quantile_over_time(series: dict, q: float) -> float:
    """True quantile of the window's combined observation stream: merge
    the per-bucket delta sketches (lossless — same-gamma bins add) and
    read the quantile off the merged sketch."""
    samples = series.get("samples") or []
    if series.get("kind") != "sketch" or not samples:
        return math.nan
    point = {"accuracy": series.get("accuracy"), "bins": [], "zero": 0,
             "count": 0, "sum": 0.0}
    bins: Dict[int, int] = {}
    for _, v in samples:
        for i, c in v["bins"].items():
            bins[i] = bins.get(i, 0) + c
        point["zero"] += v["zero"]
        point["count"] += v["count"]
        point["sum"] += v["sum"]
    point["bins"] = sorted(bins.items())
    sk = LatencySketch.from_point(point)
    # min/max were differenced away with the cumulative state; estimate
    # the extremes from the occupied bins (within the accuracy bound)
    if sk.count:
        sk.min = 0.0 if sk.zero else (
            2.0 * math.pow(sk.gamma, min(sk.bins)) / (sk.gamma + 1.0)
            if sk.bins else 0.0)
        sk.max = 2.0 * math.pow(sk.gamma, max(sk.bins)) / (sk.gamma + 1.0) \
            if sk.bins else 0.0
    return sk.quantile(q)


# ---------------------------------------------------------------------------
# Burn rate — THE authoritative implementation
# ---------------------------------------------------------------------------
# One definition shared by the watch engine's burn rules AND the serving SLO
# ledger (serve/_private/slo.py delegates here): burn = breach-fraction over
# a trailing window divided by the error budget 1 - availability.  >1 means
# the budget is being consumed faster than the SLO allows (SRE workbook
# convention).  The ≤2% parity the two paths were originally tested against
# is now structural — there is exactly one implementation to drift.


def burn_rate(bad: float, total: float, availability: float) -> float:
    """Error-budget burn rate from windowed bad/total counts."""
    if total <= 0:
        return 0.0
    budget = max(1.0 - float(availability), 1e-9)
    return (bad / total) / budget


def fold_window_counts(buckets: Dict[int, List[int]], bucket_s: float,
                       window_s: float, now_wall: float) -> List[int]:
    """[bad, total] over the trailing window from absolute-wall-clock-
    indexed ``{bucket_idx: [bad, total]}`` buckets (the slo.py ledger
    shape; absolute indices are what make per-process buckets sum
    cluster-wide)."""
    lo = int((now_wall - window_s) // bucket_s)
    bad = total = 0
    for idx, (b, t) in buckets.items():
        if idx > lo:
            bad += b
            total += t
    return [bad, total]


def sketch_bad_count(bins: Dict[int, int], threshold: float,
                     accuracy: float) -> int:
    """Observations strictly above ``threshold`` in a delta-sketch's bins
    (bin i covers (gamma^(i-1), gamma^i]), within the sketch's relative-
    accuracy bound: the bin straddling the threshold counts as good, so a
    latency target between bin edges under-counts by at most one bin's
    width (≤ 2*accuracy relative)."""
    if threshold <= 0 or not bins:
        return sum(bins.values())
    gamma = (1.0 + accuracy) / (1.0 - accuracy)
    i_thr = math.ceil(math.log(threshold) / math.log(gamma))
    return sum(c for i, c in bins.items() if i > i_thr)


# ---------------------------------------------------------------------------
# Watch rules
# ---------------------------------------------------------------------------


@dataclass
class WatchRule:
    """One declarative alert rule.

    kinds:
      threshold — newest sample in ``window_s`` compared ``op threshold``
      rate      — per-second rate over ``window_s`` compared ``op threshold``
      absence   — a reporter silent longer than ``threshold`` seconds
                  (``family`` unused; one alert per dead reporter)
      burn      — generalized burn rate: bad-fraction over BOTH ``window_s``
                  (short) and ``long_window_s`` divided by the error budget
                  ``1 - availability``; fires when the smaller of the two
                  burns crosses ``threshold`` (both-windows AND, the
                  multiwindow page/ticket shape)
      sketch_burn — multiwindow burn over a SKETCH family: bad = fraction
                  of the window's observations above ``bad_threshold``
                  (read straight off the delta-sketch bins, within the
                  sketch's accuracy bound), same both-windows AND shape.
                  The latency-SLO counterpart of ``burn`` — e.g. TTFT
                  observations over the target / budget.

    ``tags`` subset-selects series; ``bad_tags`` (burn only) selects the
    numerator series among them (values may be tuples of accepted values);
    ``group_by`` (burn kinds) splits the evaluation into one alert per
    distinct value combination of those tag keys.  ``for_s`` delays firing
    until the breach has held that long; ``clear_for_s`` delays the clear
    symmetrically (hysteresis — a flapping signal pins neither direction).
    """

    name: str
    kind: str = "threshold"
    family: Optional[str] = None
    tags: Optional[Dict[str, Any]] = None
    op: str = ">"
    threshold: float = 0.0
    window_s: float = 300.0
    long_window_s: Optional[float] = None
    bad_tags: Optional[Dict[str, Any]] = None
    bad_threshold: Optional[float] = None
    availability: Optional[float] = None
    group_by: Tuple[str, ...] = ()
    for_s: float = 0.0
    clear_for_s: float = 0.0
    severity: str = "WARNING"
    description: str = ""

    def breach(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" \
            else value < self.threshold

    def to_dict(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "family": self.family,
            "tags": self.tags, "op": self.op, "threshold": self.threshold,
            "window_s": self.window_s, "long_window_s": self.long_window_s,
            "bad_tags": self.bad_tags, "bad_threshold": self.bad_threshold,
            "availability": self.availability,
            "group_by": list(self.group_by), "for_s": self.for_s,
            "clear_for_s": self.clear_for_s, "severity": self.severity,
            "description": self.description,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WatchRule":
        known = set(cls.__dataclass_fields__)
        kw = {k: v for k, v in d.items() if k in known}
        if "group_by" in kw and kw["group_by"] is not None:
            kw["group_by"] = tuple(kw["group_by"])
        return cls(**kw)


@dataclass
class _Alert:
    """Per-(rule, subkey) hysteresis state machine."""

    state: str = "ok"            # ok | pending | firing | clearing
    since: float = 0.0           # monotonic: entered current state
    since_wall: float = 0.0
    value: float = 0.0


def builtin_rules(config: Optional[RayTpuConfig] = None) -> List[WatchRule]:
    """The shipped rule pack: the serving/training signals ROADMAP item
    1's enforcement PR acts on.  Thresholds are conservative high-water
    marks, not tuned SLOs — operators override by re-adding a rule with
    the same name."""
    cfg = config or global_config()
    report = max(1.0, cfg.metrics_report_interval_s)
    return [
        WatchRule(
            name="kv_block_occupancy_high", kind="threshold",
            family="ray_tpu_engine_kv_block_occupancy_ratio",
            threshold=0.95, window_s=120.0, for_s=30.0, clear_for_s=30.0,
            severity="WARNING",
            description="KV block pool nearly exhausted: the next "
                        "allocation preempts a running request"),
        WatchRule(
            name="decode_queue_depth_growth", kind="rate",
            family="ray_tpu_serve_disagg_queue_depth",
            threshold=0.5, window_s=120.0, for_s=30.0, clear_for_s=30.0,
            severity="WARNING",
            description="decode-pool queue depth growing >0.5 req/s "
                        "sustained: decode capacity behind prefill"),
        WatchRule(
            name="input_wait_fraction_high", kind="rate",
            family="ray_tpu_data_ingest_wait_seconds_total",
            threshold=0.2, window_s=300.0, for_s=60.0, clear_for_s=60.0,
            severity="WARNING",
            description="training consumers blocked on empty ingest "
                        "buffers >20% of wall time: input-bound"),
        WatchRule(
            name="compile_storm", kind="rate",
            family="ray_tpu_jit_compiles_total",
            threshold=cfg.compile_storm_threshold
            / max(1.0, cfg.compile_storm_window_s),
            window_s=cfg.compile_storm_window_s, clear_for_s=60.0,
            severity="WARNING",
            description="sustained XLA recompilation (shape churn / cache "
                        "misses) is eating step time"),
        WatchRule(
            name="straggler_lag_high", kind="threshold",
            family="ray_tpu_collective_straggler_lag_seconds",
            threshold=1.0, window_s=120.0, for_s=30.0, clear_for_s=30.0,
            severity="WARNING",
            description="a collective member arrives >1s behind its "
                        "group: straggler throttles every step"),
        WatchRule(
            name="goodput_drop", kind="threshold",
            family="ray_tpu_train_goodput_ratio", op="<",
            threshold=0.5, window_s=300.0, for_s=60.0, clear_for_s=60.0,
            severity="WARNING",
            description="productive fraction of train wall time below "
                        "50%: restarts/stalls dominating"),
        WatchRule(
            name="dead_reporter", kind="absence",
            threshold=max(60.0, 30.0 * report),
            severity="WARNING",
            description="a metrics reporter went silent: its node/worker "
                        "is dead or partitioned"),
        # the serve availability burn signal re-expressed as a
        # declarative rule over the history store (parity with the bespoke
        # slo.py computation is asserted in tests)
        WatchRule(
            name="serve_availability_burn", kind="burn",
            family="ray_tpu_serve_slo_requests_total",
            bad_tags={"status": ("error", "shed")},
            availability=cfg.serve_slo_availability,
            threshold=cfg.serve_slo_burn_alert,
            window_s=300.0, long_window_s=3600.0,
            group_by=("deployment",), clear_for_s=60.0,
            severity="WARNING",
            description="serving availability error budget burning "
                        "faster than the SLO allows over both the 5m and "
                        "1h windows"),
        # latency-SLO burn rules over the ingress sketches — the signals
        # the pool autoscaler actuates on (TTFT burn -> scale the prefill
        # pool, ITL burn -> decode pool; serve/_private/pool_autoscaler.py
        # keys on these rule names).  Thresholds come from the global SLO
        # targets; per-deployment slo_config overrides need a re-added
        # rule with the deployment's target as bad_threshold
        WatchRule(
            name="serve_ttft_burn", kind="sketch_burn",
            family="ray_tpu_serve_ttft_seconds",
            bad_threshold=cfg.serve_slo_ttft_ms / 1e3,
            availability=cfg.serve_slo_availability,
            threshold=cfg.serve_slo_burn_alert,
            window_s=300.0, long_window_s=3600.0,
            group_by=("deployment",), clear_for_s=60.0,
            severity="WARNING",
            description="TTFT error budget burning faster than the SLO "
                        "allows over both windows: prefill capacity "
                        "behind demand"),
        WatchRule(
            name="serve_itl_burn", kind="sketch_burn",
            family="ray_tpu_serve_itl_seconds",
            bad_threshold=cfg.serve_slo_itl_ms / 1e3,
            availability=cfg.serve_slo_availability,
            threshold=cfg.serve_slo_burn_alert,
            window_s=300.0, long_window_s=3600.0,
            group_by=("deployment",), clear_for_s=60.0,
            severity="WARNING",
            description="inter-token latency error budget burning faster "
                        "than the SLO allows over both windows: decode "
                        "capacity behind demand"),
    ]


class WatchEngine:
    """Evaluates WatchRules against a MetricsHistory on the GCS tick.

    All clocks are injectable; transitions are collected under the engine
    lock and delivered to ``on_transition(rule, subkey, state, value)``
    AFTER release (the callback records events / publishes pubsub — work
    that must not run under any engine-internal lock)."""

    def __init__(self, history: MetricsHistory,
                 config: Optional[RayTpuConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 on_transition: Optional[Callable] = None):
        self.history = history
        self._config = config or global_config()
        self._clock = clock
        self._wall = wall
        self._on_transition = on_transition
        self._rules: Dict[str, WatchRule] = {}
        self._alerts: Dict[Tuple[str, str], _Alert] = {}
        self._transitions: List[dict] = []   # bounded recent-transition log
        self._ticks = 0
        self._lock = make_lock("WatchEngine._lock")

    # -- rule management ----------------------------------------------------

    def add_rule(self, rule: WatchRule) -> None:
        with self._lock:
            self._rules[rule.name] = rule

    def remove_rule(self, name: str) -> bool:
        with self._lock:
            existed = self._rules.pop(name, None) is not None
            for key in [k for k in self._alerts if k[0] == name]:
                del self._alerts[key]
            return existed

    def rules(self) -> List[WatchRule]:
        with self._lock:
            return list(self._rules.values())

    # -- evaluation ---------------------------------------------------------

    def tick(self, reporter_ages: Optional[Dict[str, float]] = None,
             now: Optional[float] = None) -> List[dict]:
        """Evaluate every rule; returns this tick's transitions (also
        delivered to on_transition)."""
        mono = self._clock() if now is None else now
        wall = self._wall()
        fired: List[dict] = []
        with self._lock:
            rules = list(self._rules.values())
        for rule in rules:
            try:
                values = self._evaluate(rule, reporter_ages, wall)
            except Exception:  # noqa: BLE001 — one bad rule must not
                # starve the rest of the pack; the rule simply reports no
                # data this tick and is retried on the next one
                continue
            for subkey, value in values.items():
                t = self._advance(rule, subkey, value, mono, wall)
                if t is not None:
                    fired.append(t)
        with self._lock:
            self._ticks += 1
            self._transitions.extend(fired)
            if len(self._transitions) > 200:
                del self._transitions[:len(self._transitions) - 200]
        if self._on_transition is not None:
            for t in fired:
                self._on_transition(self._rules.get(t["rule"]), t)
        return fired

    def _evaluate(self, rule: WatchRule,
                  reporter_ages: Optional[Dict[str, float]],
                  wall: float) -> Dict[str, float]:
        """{subkey: signal value} for one rule; empty dict = no data (a
        rule with nothing to say keeps its alerts' current states)."""
        if rule.kind == "absence":
            return dict(reporter_ages or {})
        if self.history is None or rule.family is None:
            return {}
        if rule.kind in ("burn", "sketch_burn"):
            return self._evaluate_burn(rule, wall)
        series = self.history.query(rule.family, rule.tags,
                                    window_s=rule.window_s, now=wall)
        out: Dict[str, float] = {}
        for s in series:
            if not s["samples"]:
                continue
            subkey = ",".join(f"{k}={v}"
                              for k, v in sorted(s["tags"].items())) or "_"
            if rule.kind == "threshold":
                v = s["samples"][-1][1]
                if isinstance(v, dict):  # histogram/sketch: use the mean
                    v = (v["sum"] / v["count"]) if v["count"] else 0.0
                out[subkey] = float(v)
            elif rule.kind == "rate":
                out[subkey] = rate(s)
        return out

    def _evaluate_burn(self, rule: WatchRule,
                       wall: float) -> Dict[str, float]:
        budget = max(1.0 - float(rule.availability
                                 if rule.availability is not None
                                 else 0.99), 1e-9)
        long_w = rule.long_window_s or rule.window_s
        series = self.history.query(rule.family, rule.tags,
                                    window_s=long_w, now=wall)
        # group series, then per group compute bad/total deltas over both
        # windows; the signal is the SMALLER burn (both-windows AND)
        groups: Dict[str, List[dict]] = {}
        for s in series:
            gk = ",".join(f"{k}={s['tags'].get(k, '')}"
                          for k in rule.group_by) or "_"
            groups.setdefault(gk, []).append(s)
        availability = 1.0 - budget
        out: Dict[str, float] = {}
        for gk, members in groups.items():
            burns = []
            for win in (rule.window_s, long_w):
                lo = wall - win
                bad = total = 0.0
                for s in members:
                    in_win = [v for t, v in s["samples"]
                              if t + s["step_s"] > lo]
                    if rule.kind == "sketch_burn":
                        # delta-sketch buckets: total = observations, bad
                        # = observations above the latency target (read
                        # off the log bins)
                        acc = float(s.get("accuracy") or 0.01)
                        for v in in_win:
                            total += v["count"]
                            bad += sketch_bad_count(
                                v["bins"], rule.bad_threshold or 0.0, acc)
                    else:
                        d = sum(v if not isinstance(v, dict) else v["count"]
                                for v in in_win)
                        total += d
                        if _tags_match(s["tags"], rule.bad_tags):
                            bad += d
                burns.append(burn_rate(bad, total, availability))
            out[gk] = min(burns)
        return out

    def _advance(self, rule: WatchRule, subkey: str, value: float,
                 mono: float, wall: float) -> Optional[dict]:
        """One step of the ok -> pending -> firing -> clearing machine;
        returns a transition dict when the externally-visible state
        (firing/cleared) changed."""
        breach = rule.breach(value)
        with self._lock:
            a = self._alerts.get((rule.name, subkey))
            if a is None:
                if not breach:
                    return None
                a = self._alerts[(rule.name, subkey)] = _Alert()
            prev = a.state
            a.value = value
            if a.state == "ok":
                if breach:
                    a.state, a.since, a.since_wall = "pending", mono, wall
                    if rule.for_s <= 0:
                        a.state = "firing"
            elif a.state == "pending":
                if not breach:
                    a.state = "ok"
                elif mono - a.since >= rule.for_s:
                    a.state, a.since, a.since_wall = "firing", mono, wall
            elif a.state == "firing":
                if not breach:
                    a.state, a.since, a.since_wall = "clearing", mono, wall
                    if rule.clear_for_s <= 0:
                        a.state = "ok"
            elif a.state == "clearing":
                if breach:
                    a.state = "firing"
                elif mono - a.since >= rule.clear_for_s:
                    a.state = "ok"
            newly_firing = a.state == "firing" and prev in ("ok", "pending")
            cleared = a.state == "ok" and prev in ("firing", "clearing")
            if a.state == "ok":
                # back to ok — cleared, or pending that never fired:
                # forget the entry (the transition log keeps the history)
                self._alerts.pop((rule.name, subkey), None)
        if newly_firing:
            return {"rule": rule.name, "key": subkey, "state": "firing",
                    "value": value, "threshold": rule.threshold,
                    "severity": rule.severity, "time": wall,
                    "description": rule.description}
        if cleared:
            return {"rule": rule.name, "key": subkey, "state": "cleared",
                    "value": value, "threshold": rule.threshold,
                    "severity": "INFO", "time": wall,
                    "description": rule.description}
        return None

    # -- views --------------------------------------------------------------

    def alerts(self) -> List[dict]:
        """Every non-ok alert (pending/firing/clearing), firing first."""
        with self._lock:
            rows = [
                {"rule": name, "key": subkey, "state": a.state,
                 "value": a.value, "since": a.since_wall,
                 "severity": (self._rules[name].severity
                              if name in self._rules else "WARNING"),
                 "threshold": (self._rules[name].threshold
                               if name in self._rules else None),
                 "description": (self._rules[name].description
                                 if name in self._rules else "")}
                for (name, subkey), a in self._alerts.items()
            ]
        order = {"firing": 0, "clearing": 1, "pending": 2}
        rows.sort(key=lambda r: (order.get(r["state"], 3), r["rule"]))
        return rows

    def report(self, rule: Optional[str] = None) -> dict:
        alerts = self.alerts()
        with self._lock:
            transitions = list(self._transitions)
            rules = [r.to_dict() for r in self._rules.values()]
        if rule is not None:
            alerts = [a for a in alerts if a["rule"] == rule]
            transitions = [t for t in transitions if t["rule"] == rule]
            rules = [r for r in rules if r["name"] == rule]
        return {"enabled": True, "alerts": alerts, "rules": rules,
                "transitions": transitions[-50:], "ticks": self._ticks}
