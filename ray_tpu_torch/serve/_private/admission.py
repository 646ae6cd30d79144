"""Tenant-fair ingress admission: token buckets, weighted-fair queueing
and burn-rate load shedding at the serving proxy.

The repo's SLO layer (serve/_private/slo.py) meters per-tenant TTFT/ITL
and burn rates but nothing ENFORCES anything — under overload every tenant
collapses together (ROADMAP item 1).  This module is the enforcement half
at the ingress, three mechanisms keyed by the tenant identity slo.py
already extracts (x-tenant header / payload field / kwarg):

  - **per-tenant token buckets** (``TokenBucket``): a tenant over its
    sustained admission rate gets 429 + ``Retry-After`` computed from the
    exact bucket refill time — backpressure to the client, not the queue.
  - **weighted-fair queueing** (``WFQ`` + ``FairExecutor``): admitted work
    beyond the proxy's thread capacity queues in virtual-finish-time order
    (classic WFQ: ``ft = max(V, last_ft[tenant]) + cost/weight``), so under
    saturation tenants progress in weight proportion and an idle tenant
    never blocks others (work conservation).  The backlog is BOUNDED:
    beyond it requests are shed with 503 + Retry-After instead of queueing
    unboundedly (the pre-PR proxy's silent latency cliff).
  - **burn-rate shedding** (``AdmissionController``): when the target
    deployment's short-window availability burn exceeds the shed
    threshold, new work is refused with 503 *before* queue collapse —
    the SRE-workbook posture that chips (the expensive resource, arxiv
    2605.25645) should serve admitted work well rather than all work
    badly.

Decisions book ``ray_tpu_serve_admission_total{tenant,decision}`` and the
``ray_tpu_serve_tenant_queue_depth{tenant}`` gauge; a refusal additionally
books the request's ``shed`` terminal through its SLO tracker at the call
site.  With ``serve_admission_enabled=False`` the gate is never
constructed, every request is admitted unconditionally and the metric
surface is byte-identical (perf-smoke pinned); the warm admitted-path
decision costs <5µs (benchmarks/ingress_overhead_bench.py).

Everything takes injectable clocks — the WFQ/bucket invariant tests drive
virtual time, no wall-clock sleeps.
"""

from __future__ import annotations

import heapq
import itertools
import math
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Optional, Tuple

from ray_tpu_torch._private import runtime_metrics
from ray_tpu_torch._private.analysis.lock_witness import make_lock
from ray_tpu_torch._private.config import global_config

DEFAULT_WEIGHT = 1.0

# burn reads are throttled: the shed check costs one cached float compare
# per request, refreshed from the ledger at most this often
_BURN_TTL_S = 0.5


def parse_weights(spec: str) -> Dict[str, float]:
    """``"tenantA=4,tenantB=1"`` -> {tenant: weight}; malformed entries
    are dropped (a bad config must not take down the ingress)."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        try:
            w = float(v)
        except ValueError:
            continue
        if k.strip() and w > 0:
            out[k.strip()] = w
    return out


class TokenBucket:
    """Classic token bucket with an injectable clock.

    ``rate`` tokens/s refill up to ``burst`` capacity; ``take(n)`` is the
    admission check and ``retry_after(n)`` the exact wait until ``n``
    tokens will be available (the 429's Retry-After value)."""

    __slots__ = ("rate", "burst", "tokens", "_t", "_clock")

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self._clock = clock
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        if self.rate > 0 and now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
        self._t = now

    def take(self, n: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 if now)."""
        self._refill()
        if self.tokens >= n:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return (n - self.tokens) / self.rate


class WFQ:
    """Weighted-fair queue over tenants (virtual finish times).

    Push tags each item with ``ft = max(V, last_ft[tenant]) + cost/w``;
    pop returns the smallest tag and advances the virtual clock ``V`` to
    it.  Properties the invariant tests pin:

      - **work conservation**: pop returns work whenever any is queued —
        an idle tenant's weight is redistributed, never reserved.
      - **weight-proportional service**: under saturation (all tenants
        backlogged) tenants are served in weight proportion.
      - a returning tenant starts at ``max(V, last_ft)``: it gets no
        credit for its idle time (no burst-after-sleep unfairness).

    Not thread-safe by itself — FairExecutor brackets it with its lock.
    """

    __slots__ = ("_weights", "_heap", "_seq", "_vtime", "_last_ft", "_n")

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._weights = dict(weights or {})
        self._heap: list = []          # (finish_tag, seq, tenant, item)
        self._seq = itertools.count()
        self._vtime = 0.0
        self._last_ft: Dict[str, float] = {}
        self._n = 0

    def push(self, tenant: str, item, cost: float = 1.0) -> None:
        w = self._weights.get(tenant, DEFAULT_WEIGHT)
        start = max(self._vtime, self._last_ft.get(tenant, 0.0))
        ft = start + cost / max(w, 1e-9)
        self._last_ft[tenant] = ft
        heapq.heappush(self._heap, (ft, next(self._seq), tenant, item))
        self._n += 1

    def pop(self) -> Optional[Tuple[str, object]]:
        if not self._heap:
            return None
        ft, _seq, tenant, item = heapq.heappop(self._heap)
        self._vtime = ft
        self._n -= 1
        if not self._heap:
            # drained: drop per-tenant tags that sit at or behind the
            # virtual clock so the map can't grow with tenant churn
            self._last_ft = {t: f for t, f in self._last_ft.items()
                             if f > self._vtime}
        return tenant, item

    def __len__(self) -> int:
        return self._n


class Saturated(Exception):
    """FairExecutor is at capacity AND its bounded backlog is full —
    the caller responds 503 + Retry-After and books a shed terminal."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"ingress saturated (retry after {retry_after_s}s)")
        self.retry_after_s = retry_after_s


class FairExecutor:
    """Weighted-fair admitted-work scheduler over a bounded thread pool.

    ``submit(tenant, fn)`` runs ``fn`` immediately while running work is
    under ``max_running``; beyond that it queues in WFQ order up to
    ``backlog`` deep, and past THAT raises ``Saturated`` — the executor's
    queue can never grow unboundedly (the satellite fix for the
    ``max_handle_threads`` latency cliff).  Completion of any task pulls
    the next fair item, so slots hand off without a scheduler thread."""

    def __init__(self, pool, max_running: int, backlog: int,
                 weights: Optional[Dict[str, float]] = None,
                 retry_after_s: float = 1.0):
        self._pool = pool
        self._max_running = int(max_running)
        self._backlog_cap = int(backlog)
        self._retry_after_s = float(retry_after_s)
        self._wfq = WFQ(weights)
        self._running = 0
        self._lock = make_lock("FairExecutor._lock")

    def submit(self, tenant: str, fn: Callable, cost: float = 1.0) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._running < self._max_running:
                self._running += 1
                direct = True
            elif len(self._wfq) >= self._backlog_cap:
                raise Saturated(self._retry_after_s)
            else:
                self._wfq.push(tenant, (fn, fut), cost)
                direct = False
        if direct:
            self._pool.submit(self._run, fn, fut)
        return fut

    def _run(self, fn: Callable, fut: Future) -> None:
        try:
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn())
                except BaseException as e:  # noqa: BLE001 — delivered to caller
                    fut.set_exception(e)
        finally:
            self._release_slot()

    def _release_slot(self) -> None:
        with self._lock:
            nxt = self._wfq.pop()
            if nxt is None:
                self._running -= 1
                return
        _tenant, (fn, fut) = nxt
        self._pool.submit(self._run, fn, fut)

    def depth(self) -> Tuple[int, int]:
        """(running, queued) — the utilization row's ingress view."""
        with self._lock:
            return self._running, len(self._wfq)


class Decision:
    """One admission verdict; refusals carry the HTTP status and the
    Retry-After value the proxy writes back."""

    __slots__ = ("admitted", "decision", "status", "retry_after_s")

    def __init__(self, admitted: bool, decision: str, status: int = 200,
                 retry_after_s: float = 0.0):
        self.admitted = admitted
        self.decision = decision       # admit | throttle | shed
        self.status = status           # 200 | 429 | 503
        self.retry_after_s = retry_after_s


_ADMIT = Decision(True, "admit")


class AdmissionController:
    """The per-proxy admission gate: decide() per request, release() at
    the request's terminal.

    Check order (cheapest first, every step O(1) warm):
      1. per-tenant token bucket  -> 429 + exact refill Retry-After
      2. per-tenant in-flight cap -> 503 (one tenant cannot hold every
         handle thread)
      3. deployment burn-rate shed -> 503 (admitted-work error burn —
         sheds excluded, see ``_ledger_burn`` — above
         ``serve_admission_shed_burn``; the burn value is read from the
         ledger at most every 0.5s, so the per-request cost is one cached
         float compare)

    The burn shed deliberately stays latched while the short window's
    budget remains burnt — admission reopens as the window drains, which
    is the intended recovery ramp rather than a thundering herd."""

    def __init__(self, config=None, clock: Callable[[], float] = None,
                 burn_source: Optional[Callable[[str], float]] = None):
        cfg = config or global_config()
        self.rate = float(cfg.serve_admission_tenant_rate)
        self.burst = float(cfg.serve_admission_tenant_burst)
        self.shed_burn = float(cfg.serve_admission_shed_burn)
        self.max_inflight = int(cfg.serve_admission_max_inflight)
        self.retry_after_s = float(cfg.serve_admission_retry_after_s)
        self.weights = parse_weights(cfg.serve_admission_weights)
        self._clock = clock or time.monotonic
        self._burn_source = burn_source or _ledger_burn
        self._burn_cache: Dict[str, Tuple[float, float]] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._inflight: Dict[str, int] = {}
        # tenant -> (admit ctr, throttle ctr, shed ctr, depth gauge):
        # bound metric handles cached so the warm decision skips the
        # per-call tag-key construction (the <5µs budget's biggest line)
        self._books: Dict[str, tuple] = {}
        self._lock = make_lock("AdmissionController._lock")

    # -- the per-request hot path -------------------------------------------

    def _book(self, tenant: str) -> tuple:
        bk = self._books.get(tenant)
        if bk is None:
            if len(self._books) >= 4096:   # hostile tenant churn: reset
                self._books.clear()
            bk = self._books[tenant] = (
                runtime_metrics.SERVE_ADMISSION.with_tags(
                    {"tenant": tenant, "decision": "admit"}),
                runtime_metrics.SERVE_ADMISSION.with_tags(
                    {"tenant": tenant, "decision": "throttle"}),
                runtime_metrics.SERVE_ADMISSION.with_tags(
                    {"tenant": tenant, "decision": "shed"}),
                runtime_metrics.SERVE_TENANT_QUEUE_DEPTH.with_tags(
                    {"tenant": tenant}),
            )
        return bk

    def decide(self, tenant: str, deployment: Optional[str] = None,
               cost: float = 1.0) -> Decision:
        bk = self._books.get(tenant) or self._book(tenant)
        with self._lock:
            if self.rate > 0:
                b = self._buckets.get(tenant)
                if b is None:
                    b = self._buckets[tenant] = TokenBucket(
                        self.rate, self.burst, self._clock)
                if not b.take(cost):
                    ra = b.retry_after(cost)
                    bk[1].inc()
                    return Decision(False, "throttle", 429, ra)
            if (self.max_inflight > 0
                    and self._inflight.get(tenant, 0) >= self.max_inflight):
                bk[2].inc()
                return Decision(False, "shed", 503, self.retry_after_s)
        if self.shed_burn > 0 and deployment:
            if self._burn(deployment) > self.shed_burn:
                bk[2].inc()
                return Decision(False, "shed", 503, self.retry_after_s)
        with self._lock:
            n = self._inflight.get(tenant, 0) + 1
            self._inflight[tenant] = n
        bk[0].inc()
        bk[3].set(n)
        return _ADMIT

    def release(self, tenant: str) -> None:
        """The admitted request reached a terminal state."""
        with self._lock:
            n = max(0, self._inflight.get(tenant, 1) - 1)
            if n:
                self._inflight[tenant] = n
            else:
                self._inflight.pop(tenant, None)
        bk = self._books.get(tenant)
        if bk is not None:
            bk[3].set(n)
        else:
            runtime_metrics.set_tenant_queue_depth(tenant, n)

    def _burn(self, deployment: str) -> float:
        now = self._clock()
        cached = self._burn_cache.get(deployment)
        if cached is not None and now - cached[0] < _BURN_TTL_S:
            return cached[1]
        try:
            burn = float(self._burn_source(deployment))
        except Exception:  # noqa: BLE001 — a broken burn source must fail
            burn = 0.0     # open (admit), never take down the ingress
        self._burn_cache[deployment] = (now, burn)
        return burn

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tenant_rate": self.rate, "tenant_burst": self.burst,
                "shed_burn": self.shed_burn,
                "max_inflight": self.max_inflight,
                "weights": dict(self.weights),
                "inflight": dict(self._inflight),
            }


def _ledger_burn(deployment: str) -> float:
    """Default burn source: THIS process's ledger's short-window
    admitted-work ("service") burn — error fraction among requests the
    gate let through, sheds excluded by construction.  Deliberately NOT
    the availability burn: that one counts sheds as bad, so a flood of
    refused requests would inflate it and latch the breaker against the
    innocent tenants too (refusals begetting refusals).  Local view on
    purpose: the cluster fold is seconds stale; this is what the
    deployment is doing to requests this ingress admitted right now."""
    from ray_tpu_torch.serve._private import slo

    rates = slo.get_ledger().burn_rates(deployment)
    return float(rates.get("service", {}).get("5m", 0.0))


# ---------------------------------------------------------------------------
# Module singleton (one gate per proxy process)
# ---------------------------------------------------------------------------

_controller: Optional[AdmissionController] = None
_controller_lock = threading.Lock()


def get_controller() -> Optional[AdmissionController]:
    """The process's admission gate, or None when disabled — the disabled
    path in the proxy is exactly one None check and books nothing."""
    if not global_config().serve_admission_enabled:
        return None
    global _controller
    if _controller is None:
        with _controller_lock:
            if _controller is None:
                _controller = AdmissionController()
    return _controller


def reset_controller() -> None:
    """Test hook: drop the singleton so config changes take effect."""
    global _controller
    with _controller_lock:
        _controller = None
