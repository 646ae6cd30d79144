"""User-defined application metrics: Counter / Gauge / Histogram / Sketch.

TPU-native rebuild of the reference's metrics API
(reference: python/ray/util/metrics.py; C++ registry src/ray/stats/metric.h:109,
exposition pipeline _private/metrics_agent.py:29,57,346).

Metrics are recorded into a process-local registry; each worker/driver
periodically (and on flush) pushes snapshots to the GCS, which aggregates the
latest value per (metric, tag-set, reporter).  ``prometheus_text()`` renders
the cluster-wide aggregate in Prometheus exposition format — what the
reference's per-node MetricsAgent serves to Prometheus.

``Sketch`` (beyond the reference) is a DDSketch-style quantile sketch
(_private/latency_sketch.py): log-bucketed, constant memory, bounded
relative error at ANY quantile, and — unlike Histogram — LOSSLESSLY
mergeable across reporters, so p99s computed from the GCS aggregate equal
the p99 of the combined stream.  Sketch points ride the same throttled
ReportMetrics push; Prometheus rendering is the summary convention
(``name{quantile="0.99"}``).
"""

from __future__ import annotations

import bisect
import os
import socket as _socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.analysis.lock_witness import make_lock

_REGISTRY_LOCK = make_lock("metrics._REGISTRY_LOCK")
_REGISTRY: Dict[str, "Metric"] = {}

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
]


def _tag_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    """Base class; subclasses implement the record semantics."""

    _kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name must be non-empty")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        # Re-declaring a metric (e.g. inside a task that runs repeatedly on
        # the same worker) adopts the existing state instead of resetting it.
        with _REGISTRY_LOCK:
            prior = _REGISTRY.get(name)
            if prior is not None and prior._kind == self._kind:
                self._lock = prior._lock
                self._points = prior._points
            else:
                self._lock = make_lock("Metric._lock")
                self._points: Dict[Tuple[Tuple[str, str], ...], float] = {}
            _REGISTRY[name] = self

    @property
    def info(self) -> Dict[str, object]:
        return {
            "name": self._name,
            "description": self._description,
            "tag_keys": self._tag_keys,
            "default_tags": dict(self._default_tags),
        }

    def set_default_tags(self, default_tags: Dict[str, str]):
        self._check_tags(default_tags)
        self._default_tags = dict(default_tags)
        return self

    def _check_tags(self, tags: Optional[Dict[str, str]]):
        for k in tags or ():
            if k not in self._tag_keys:
                raise ValueError(
                    f"tag {k!r} not declared in tag_keys={self._tag_keys} of metric {self._name!r}"
                )

    def _merged(self, tags: Optional[Dict[str, str]]):
        merged = dict(self._default_tags)
        merged.update(tags or {})
        return _tag_key(merged)

    def _snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {"name": self._name, "kind": self._kind, "tags": dict(k), "value": v,
                 "description": self._description}
                for k, v in self._points.items()
            ]


class Counter(Metric):
    """Monotonically increasing value (reference: util/metrics.py Counter)."""

    _kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc() requires value > 0")
        self._check_tags(tags)
        key = self._merged(tags)
        with self._lock:
            self._points[key] = self._points.get(key, 0.0) + value

    def with_tags(self, tags: Optional[Dict[str, str]] = None) -> "BoundCounter":
        self._check_tags(tags)
        return BoundCounter(self, self._merged(tags))


class Gauge(Metric):
    """Last-value-wins metric (reference: util/metrics.py Gauge)."""

    _kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._check_tags(tags)
        with self._lock:
            self._points[self._merged(tags)] = float(value)

    def with_tags(self, tags: Optional[Dict[str, str]] = None) -> "BoundGauge":
        self._check_tags(tags)
        return BoundGauge(self, self._merged(tags))


class Histogram(Metric):
    """Distribution metric with static bucket boundaries."""

    _kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        # _hist/boundaries must exist before super().__init__ publishes the
        # instance into the registry (a concurrent collect_local() snapshots).
        self.boundaries = sorted(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        with _REGISTRY_LOCK:
            prior = _REGISTRY.get(name)
        if isinstance(prior, Histogram) and prior.boundaries == self.boundaries:
            self._hist = prior._hist
        else:
            # per-tagset: (bucket counts, sum, count)
            self._hist: Dict[Tuple, List] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._check_tags(tags)
        key = self._merged(tags)
        with self._lock:
            st = self._hist.get(key)
            if st is None:
                st = self._hist[key] = [[0] * (len(self.boundaries) + 1), 0.0, 0]
            buckets, _, _ = st
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            st[1] += value
            st[2] += 1

    def _snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {"name": self._name, "kind": "histogram", "tags": dict(k),
                 "boundaries": list(self.boundaries), "buckets": list(st[0]),
                 "sum": st[1], "count": st[2], "description": self._description}
                for k, st in self._hist.items()
            ]

    def with_tags(self, tags: Optional[Dict[str, str]] = None) -> "BoundHistogram":
        self._check_tags(tags)
        return BoundHistogram(self, self._merged(tags))


class Sketch(Metric):
    """Mergeable quantile sketch metric (DDSketch-style; see
    _private/latency_sketch.py).  Use for latency distributions whose TAIL
    must stay accurate after folding across replicas/nodes — serve TTFT and
    inter-token latency are the canonical users."""

    _kind = "sketch"

    def __init__(self, name: str, description: str = "",
                 relative_accuracy: float = 0.01,
                 tag_keys: Optional[Sequence[str]] = None):
        self.relative_accuracy = float(relative_accuracy)
        with _REGISTRY_LOCK:
            prior = _REGISTRY.get(name)
        if (isinstance(prior, Sketch)
                and prior.relative_accuracy == self.relative_accuracy):
            self._sketches = prior._sketches
        else:
            # per-tagset LatencySketch
            self._sketches: Dict[Tuple, object] = {}
        super().__init__(name, description, tag_keys)

    def _sketch_for(self, key):
        st = self._sketches.get(key)
        if st is None:
            from ray_tpu_torch._private.latency_sketch import LatencySketch

            st = self._sketches[key] = LatencySketch(self.relative_accuracy)
        return st

    def observe(self, value: float, n: int = 1,
                tags: Optional[Dict[str, str]] = None):
        self._check_tags(tags)
        key = self._merged(tags)
        with self._lock:
            self._sketch_for(key).add(value, n)

    def _snapshot(self) -> List[dict]:
        with self._lock:
            return [
                dict({"name": self._name, "kind": "sketch", "tags": dict(k),
                      "description": self._description}, **st.to_point())
                for k, st in self._sketches.items()
            ]

    def with_tags(self, tags: Optional[Dict[str, str]] = None) -> "BoundSketch":
        self._check_tags(tags)
        return BoundSketch(self, self._merged(tags))


# ---------------------------------------------------------------------------
# Bound recorders — the constant-cost hot path for built-in runtime metrics
# (reference: the C++ stats fast path, src/ray/stats/metric.h Record()).
# The tag-set is resolved ONCE at bind time; each record is a registry
# check, a lock, and one dict/list update, so instrumenting a dispatch loop
# costs O(100ns)/point.  The registry check (one unlocked dict read) keeps
# a long-lived recorder valid across ANY re-declaration of its metric —
# including a Histogram re-declared with different boundaries, which swaps
# in a fresh state dict the old instance no longer feeds.
# ---------------------------------------------------------------------------


class BoundCounter:
    __slots__ = ("_m", "_key")

    def __init__(self, metric: Counter, key):
        self._m, self._key = metric, key

    def inc(self, value: float = 1.0):
        m = self._m
        cur = _REGISTRY.get(m._name)
        if cur is not m and type(cur) is type(m):
            self._m = m = cur
        with m._lock:
            m._points[self._key] = m._points.get(self._key, 0.0) + value


class BoundGauge:
    __slots__ = ("_m", "_key")

    def __init__(self, metric: Gauge, key):
        self._m, self._key = metric, key

    def set(self, value: float):
        m = self._m
        cur = _REGISTRY.get(m._name)
        if cur is not m and type(cur) is type(m):
            self._m = m = cur
        with m._lock:
            m._points[self._key] = float(value)


class BoundHistogram:
    __slots__ = ("_m", "_key", "_bounds")

    def __init__(self, metric: Histogram, key):
        self._m, self._key = metric, key
        self._bounds = metric.boundaries

    def observe(self, value: float):
        m = self._m
        cur = _REGISTRY.get(m._name)
        if cur is not m and type(cur) is type(m):
            self._m = m = cur
            self._bounds = cur.boundaries
        i = bisect.bisect_left(self._bounds, value)
        with m._lock:
            st = m._hist.get(self._key)
            if st is None:
                st = m._hist[self._key] = [[0] * (len(self._bounds) + 1), 0.0, 0]
            st[0][i] += 1
            st[1] += value
            st[2] += 1


class BoundSketch:
    __slots__ = ("_m", "_key")

    def __init__(self, metric: Sketch, key):
        self._m, self._key = metric, key

    def observe(self, value: float, n: int = 1):
        m = self._m
        cur = _REGISTRY.get(m._name)
        if cur is not m and type(cur) is type(m):
            self._m = m = cur
        with m._lock:
            st = m._sketches.get(self._key)
            if st is None:
                from ray_tpu_torch._private.latency_sketch import LatencySketch

                st = m._sketches[self._key] = LatencySketch(
                    m.relative_accuracy)
            st.add(value, n)


def collect_local() -> List[dict]:
    """Snapshot every metric registered in this process."""
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    out: List[dict] = []
    for m in metrics:
        out.extend(m._snapshot())
    return out


_REPORTER_ID: Optional[str] = None
# GCS channel for processes that host runtime components but no CoreWorker
# (a head-node raylet/GCS process): anything with .call(method, payload,
# timeout=). First registration wins; a worker, when present, is preferred.
_FALLBACK_GCS = None
_PUSH_LOCK = make_lock("metrics._PUSH_LOCK")
_LAST_PUSH = 0.0


def reporter_id() -> str:
    """Stable per-PROCESS reporter identity.  Every pusher in one process
    (driver worker, in-process raylets, in-process GCS) reports under the
    SAME name, so the GCS stores one latest full-registry snapshot per
    process and counters are never double-aggregated."""
    global _REPORTER_ID
    if _REPORTER_ID is None:
        _REPORTER_ID = f"{_socket.gethostname()}:{os.getpid()}"
    return _REPORTER_ID


def set_fallback_gcs(client) -> None:
    """Register a GCS channel for metric pushes from worker-less processes.
    No-op if one is already registered."""
    global _FALLBACK_GCS
    if _FALLBACK_GCS is None:
        _FALLBACK_GCS = client


def _gcs_channel():
    from ray_tpu_torch._private.worker import get_global_worker

    w = get_global_worker()
    if w is not None:
        return w.gcs
    return _FALLBACK_GCS


def push_to_gcs(timeout: float = 10, **call_kwargs):
    """Push this process's metric snapshot to the GCS aggregate.
    ``call_kwargs`` pass through to the channel's .call (e.g.
    ``retry_deadline=0.0`` for a no-reconnect teardown flush)."""
    gcs = _gcs_channel()
    if gcs is None:
        return
    points = collect_local()
    if points:
        # call() (not notify) so the push is ordered before any subsequent
        # CollectMetrics — collect_cluster() must see its own flush.
        gcs.call(
            "ReportMetrics",
            {"reporter": reporter_id(), "points": points, "time": time.time()},
            timeout=timeout, **call_kwargs,
        )
        global _LAST_PUSH
        _LAST_PUSH = time.monotonic()


def maybe_push(min_interval_s: float = 2.0) -> bool:
    """Throttled, never-raises push — the hook the runtime piggybacks on its
    existing periodic loops (raylet report loop, worker resubscribe loop,
    task-completion flush).  Returns True if a push went out."""
    global _LAST_PUSH
    now = time.monotonic()
    with _PUSH_LOCK:
        if now - _LAST_PUSH < min_interval_s:
            return False
        _LAST_PUSH = now  # claim the slot before the RPC (other threads skip)
    try:
        push_to_gcs()
        return True
    except Exception:  # noqa: BLE001 — metrics must never take a loop down
        return False


def collect_cluster() -> List[dict]:
    """Fetch the GCS-side cluster aggregate (all reporters, latest snapshot)."""
    push_to_gcs()
    gcs = _gcs_channel()
    if gcs is None:
        return collect_local()
    return gcs.call("CollectMetrics", {}) or []


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_tags(tags: Dict[str, str]) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(tags.items()))
    return "{" + inner + "}"


def prometheus_text(points: Optional[List[dict]] = None) -> str:
    """Render points in Prometheus exposition format (reference: metrics_agent.py:346)."""
    if points is None:
        points = collect_cluster()
    by_name: Dict[str, List[dict]] = {}
    for p in points:
        by_name.setdefault(p["name"], []).append(p)
    lines: List[str] = []
    for name, ps in sorted(by_name.items()):
        kind = ps[0]["kind"]
        desc = ps[0].get("description", "")
        if desc:
            lines.append(f"# HELP {name} {desc}")
        prom_kind = {"untyped": "gauge", "sketch": "summary"}.get(kind, kind)
        lines.append(f"# TYPE {name} {prom_kind}")
        for p in ps:
            tags = p.get("tags", {})
            if kind == "sketch":
                # summary convention: quantiles computed off the mergeable
                # sketch bins (so cluster-aggregate p99 is a TRUE p99, not
                # an average of per-replica p99s)
                from ray_tpu_torch._private.latency_sketch import point_quantiles

                qs = (0.5, 0.9, 0.95, 0.99)
                for q, v in zip(qs, point_quantiles(p, qs)):
                    t = dict(tags, quantile=repr(q))
                    lines.append(f"{name}{_fmt_tags(t)} {v}")
                lines.append(f"{name}_sum{_fmt_tags(tags)} {p['sum']}")
                lines.append(f"{name}_count{_fmt_tags(tags)} {p['count']}")
            elif kind == "histogram":
                cum = 0
                for b, c in zip(p["boundaries"], p["buckets"]):
                    cum += c
                    t = dict(tags, le=repr(b))
                    lines.append(f"{name}_bucket{_fmt_tags(t)} {cum}")
                cum += p["buckets"][-1]
                t = dict(tags, le="+Inf")
                lines.append(f"{name}_bucket{_fmt_tags(t)} {cum}")
                lines.append(f"{name}_sum{_fmt_tags(tags)} {p['sum']}")
                lines.append(f"{name}_count{_fmt_tags(tags)} {p['count']}")
            else:
                lines.append(f"{name}{_fmt_tags(tags)} {p['value']}")
    return "\n".join(lines) + "\n"
