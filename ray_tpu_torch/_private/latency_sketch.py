"""DDSketch-style log-bucketed quantile sketch for serving latencies.

The serving fleet is judged on tail percentiles (TTFT/ITL p50/p99 — the
Gemma-on-TPU comparison, PAPERS.md arxiv 2605.25645) and at fleet scale you
operate on tails and burn rates, not means (arxiv 2510.20171).  A plain
histogram's static boundaries can't guarantee tail accuracy across the
four-decade dynamic range a serving path spans (100 µs proxy hops to
multi-minute compiles); a sorted reservoir can't merge across replicas.

``LatencySketch`` is the standard answer (DDSketch, VLDB'19): values map to
log-spaced buckets ``i = ceil(log_gamma(v))`` with ``gamma = (1+a)/(1-a)``,
so every bucket's midpoint is within relative error ``a`` of anything in
the bucket.  Properties the serving SLO layer leans on:

  - **bounded relative quantile error**: ``quantile(q)`` is within
    ``a`` (default 1%, guaranteed <= 2%) of the true value at that rank,
    at ANY q — p50 and p99.999 cost the same.
  - **constant memory**: bucket count grows with the LOG of the value
    range; ``max_bins`` (default 2048) collapses the smallest buckets
    under adversarial ranges, preserving the upper tail exactly.
  - **O(1) insert**: one ``log``, one dict update (~a few hundred ns).
  - **lossless merge**: two sketches with the same ``gamma`` merge by
    adding bucket counts — the merged sketch is IDENTICAL to the sketch
    of the combined stream (the property that lets per-replica sketches
    fold cluster-wide through the GCS metrics aggregate).
  - **compact serialization** (``to_blob``/``from_blob``) for the GCS KV
    and the metrics push.

Deliberately dependency-free (no numpy/jax): it is imported by the metrics
plane, which every process loads.
"""

from __future__ import annotations

import base64
import math
import struct
from typing import Dict, Iterable, List, Optional, Sequence

# values at or below this land in the zero bucket (latencies are >= 0;
# sub-nanosecond "latencies" are clock noise, not data)
_MIN_VALUE = 1e-9

DEFAULT_RELATIVE_ACCURACY = 0.01
DEFAULT_MAX_BINS = 2048


class LatencySketch:
    """Mergeable quantile sketch with bounded relative error."""

    __slots__ = ("accuracy", "gamma", "_inv_log_gamma", "max_bins",
                 "bins", "zero", "count", "sum", "min", "max")

    def __init__(self, relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
                 max_bins: int = DEFAULT_MAX_BINS):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError(
                f"relative_accuracy must be in (0, 1), got {relative_accuracy}")
        self.accuracy = float(relative_accuracy)
        self.gamma = (1.0 + self.accuracy) / (1.0 - self.accuracy)
        self._inv_log_gamma = 1.0 / math.log(self.gamma)
        self.max_bins = int(max_bins)
        self.bins: Dict[int, int] = {}
        self.zero = 0          # values <= _MIN_VALUE
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- hot path -----------------------------------------------------------

    def add(self, value: float, n: int = 1) -> None:
        """Insert ``value`` (``n`` times — one dict update either way, the
        per-chunk weighting the ITL recorder uses)."""
        if n <= 0:
            return
        self.count += n
        self.sum += value * n
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value <= _MIN_VALUE:
            self.zero += n
            return
        i = math.ceil(math.log(value) * self._inv_log_gamma)
        bins = self.bins
        bins[i] = bins.get(i, 0) + n
        if len(bins) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        """Fold the smallest buckets together until under ``max_bins``.
        Collapsing LOW buckets keeps the upper tail (the part SLOs are
        judged on) exact under adversarial value ranges."""
        keys = sorted(self.bins)
        # fold the lowest keys into the bucket at the cut line
        spill = 0
        cut = len(keys) - self.max_bins + 1
        for k in keys[:cut]:
            spill += self.bins.pop(k)
        anchor = keys[cut]
        self.bins[anchor] = self.bins.get(anchor, 0) + spill

    # -- quantiles ----------------------------------------------------------

    def _value_of_bin(self, i: int) -> float:
        # bucket i covers (gamma^(i-1), gamma^i]; the midpoint-in-relative-
        # terms estimate 2*gamma^i/(gamma+1) is within `accuracy` of every
        # value in the bucket
        return 2.0 * math.pow(self.gamma, i) / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Value at rank ``q`` (0..1), within ``accuracy`` relative error of
        the true empirical quantile.  NaN on an empty sketch."""
        if self.count == 0:
            return math.nan
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        rank = q * (self.count - 1)
        cum = self.zero
        if cum > rank:
            return 0.0
        for i in sorted(self.bins):
            cum += self.bins[i]
            if cum > rank:
                return self._value_of_bin(i)
        return self.max

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        """Many ranks in one ascending walk."""
        if self.count == 0:
            return [math.nan] * len(qs)
        order = sorted(range(len(qs)), key=lambda j: qs[j])
        out = [0.0] * len(qs)
        keys = sorted(self.bins)
        ki = 0
        cum = self.zero
        cur = 0.0 if self.zero else None
        for j in order:
            q = qs[j]
            if q <= 0.0:
                out[j] = self.min
                continue
            if q >= 1.0:
                out[j] = self.max
                continue
            rank = q * (self.count - 1)
            while cum <= rank and ki < len(keys):
                cum += self.bins[keys[ki]]
                cur = self._value_of_bin(keys[ki])
                ki += 1
            out[j] = self.max if (cum <= rank or cur is None) else cur
        return out

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def __len__(self) -> int:
        return self.count

    # -- merge --------------------------------------------------------------

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        """Fold ``other`` into this sketch IN PLACE (lossless: identical to
        having inserted both streams into one sketch).  Requires the same
        relative accuracy — merging mismatched gammas would silently break
        the error bound."""
        if abs(other.accuracy - self.accuracy) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different accuracies "
                f"({self.accuracy} vs {other.accuracy})")
        for i, c in other.bins.items():
            self.bins[i] = self.bins.get(i, 0) + c
        if len(self.bins) > self.max_bins:
            self._collapse()
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        return self

    def copy(self) -> "LatencySketch":
        s = LatencySketch(self.accuracy, self.max_bins)
        s.bins = dict(self.bins)
        s.zero, s.count, s.sum = self.zero, self.count, self.sum
        s.min, s.max = self.min, self.max
        return s

    # -- serialization ------------------------------------------------------
    # Compact binary blob (base64 for JSON transport): little-endian
    #   [f64 accuracy][f64 sum][f64 min][f64 max]
    #   [u64 count][u64 zero][u32 nbins] then nbins x [i32 index][u64 count]

    _HEAD = struct.Struct("<ddddQQI")
    _BIN = struct.Struct("<iQ")

    def to_blob(self) -> str:
        parts = [self._HEAD.pack(
            self.accuracy, self.sum,
            self.min if self.count else 0.0,
            self.max if self.count else 0.0,
            self.count, self.zero, len(self.bins))]
        for i in sorted(self.bins):
            parts.append(self._BIN.pack(i, self.bins[i]))
        return base64.b64encode(b"".join(parts)).decode("ascii")

    @classmethod
    def from_blob(cls, blob: str, max_bins: int = DEFAULT_MAX_BINS
                  ) -> "LatencySketch":
        raw = base64.b64decode(blob.encode("ascii"))
        acc, total, mn, mx, count, zero, nbins = cls._HEAD.unpack_from(raw, 0)
        s = cls(acc, max_bins)
        off = cls._HEAD.size
        for _ in range(nbins):
            i, c = cls._BIN.unpack_from(raw, off)
            s.bins[i] = c
            off += cls._BIN.size
        s.count, s.zero, s.sum = count, zero, total
        s.min = mn if count else math.inf
        s.max = mx if count else -math.inf
        return s

    # -- metric-point interop ------------------------------------------------
    # The metrics plane ships sketches as plain dict points so the GCS
    # aggregate can merge them without importing this module's class.

    def to_point(self) -> dict:
        return {
            "accuracy": self.accuracy,
            "bins": [[i, self.bins[i]] for i in sorted(self.bins)],
            "zero": self.zero,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }

    @classmethod
    def from_point(cls, point: dict) -> "LatencySketch":
        s = cls(point.get("accuracy", DEFAULT_RELATIVE_ACCURACY))
        for i, c in point.get("bins", ()):
            s.bins[int(i)] = s.bins.get(int(i), 0) + int(c)
        s.zero = int(point.get("zero", 0))
        s.count = int(point.get("count", 0))
        s.sum = float(point.get("sum", 0.0))
        s.min = float(point.get("min", 0.0)) if s.count else math.inf
        s.max = float(point.get("max", 0.0)) if s.count else -math.inf
        return s


def merge_points(points: Iterable[dict]) -> Optional[dict]:
    """Merge sketch metric points (same accuracy) into one point dict —
    the GCS-side aggregation primitive (no LatencySketch instance needed
    on the read path, but building one is the clearest correct code)."""
    merged: Optional[LatencySketch] = None
    for p in points:
        s = LatencySketch.from_point(p)
        if merged is None:
            merged = s
        else:
            merged.merge(s)
    return merged.to_point() if merged is not None else None


def point_quantiles(point: dict, qs: Sequence[float]) -> List[float]:
    """Quantiles straight off a metric point (prometheus rendering,
    state-API folds)."""
    return LatencySketch.from_point(point).quantiles(qs)


def summary(sketch_or_point, qs: Sequence[float] = (0.5, 0.95, 0.99)) -> dict:
    """{"p50": .., "p95": .., "p99": .., "count": .., "mean": ..} — the
    shape bench.py and state.serving_slo() embed."""
    s = (sketch_or_point if isinstance(sketch_or_point, LatencySketch)
         else LatencySketch.from_point(sketch_or_point))
    out = {}
    if s.count:
        for q, v in zip(qs, s.quantiles(qs)):
            out[f"p{q * 100:g}"] = v
    out["count"] = s.count
    out["mean"] = s.mean if s.count else 0.0
    return out
