"""Device telemetry of the port: the CUDA twin of
``ray_tpu/_private/device_telemetry.py``.

What it observes, as the reference does, with the card in place of the
TPU:

  1. **HBM accounting** from this process's CUDA caching allocator
     (``torch.cuda.memory_stats``: allocated bytes now and at peak; the
     limit from ``torch.cuda.mem_get_info``'s total), never the card's
     device-wide used bytes: two processes that share a card (a
     disaggregated deployment's stages at ``GPU`` 0.5) each see their own
     bytes, and the transient clamp cannot hide one stage's pool charged to
     the other.  CUDA graphs' private memory pools are allocator memory, so
     captured programs' buffers count as transient.  A process that has not
     initialised CUDA (or runs on the CPU) reports one row whose ``source``
     says so.
  2. **Engine utilization & headroom**: :class:`EngineTelemetry`, copied,
     driven by the paged and static engines' ``step()``; per-replica rows
     fold into ``state.utilization()`` and the pool autoscaler's headroom.
     The duty cycle is the step body's host seconds over the wall since the
     last step ended.  The port's decode keeps one chunk in flight and each
     step waits on the previous chunk's tokens, so the body's time follows
     the device; no step adds a synchronize or an event query for it.
  3. **Compile watch**: a CUDA-graph capture is the port's compile.  The
     capture sites report themselves (``note_trace`` before a capture,
     ``note_compile`` after it); there is no listener to install.  A
     program that recaptures fast enough is a storm (``storm_report``,
     ``state.diagnose()``).
  4. **MFU**: model FLOPs counted analytically from the model family's
     ``flops_per_token`` (a FLOP counter would miss the ctypes kernels),
     over the step wall and the card's peak: the H100 SXM's 989 TFLOP/s
     bf16 dense, matched on ``torch.cuda.get_device_name()``.  An unknown
     card has no peak and no MFU; no other card's figure stands in.
  5. **Heartbeat**: copied; a replica in a long warm-up of captures keeps
     pushing its metrics.

Disabled path (``device_telemetry_enabled = false``): engines attach no
recorder, so a step pays one attribute read and a None check and the layer
books nothing.  The copied names are held to their originals by
``tests/test_torch_serve_copies.py``.
"""

from __future__ import annotations

import collections
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.analysis.lock_witness import make_lock

UTIL_KV_PREFIX = "util:"

# peak bf16 dense FLOPs/s by device name (torch.cuda.get_device_name()):
# the card the port runs on, and no other.  NVIDIA's data sheet, SXM part,
# at the 700 W limit; a card set below it (nvidia-smi's power.limit, which
# every measured rate is kept beside) runs slower
PEAK_FLOPS = {
    "h100": 989e12,
}


def enabled() -> bool:
    from ray_tpu_torch._private.config import global_config

    return bool(global_config().device_telemetry_enabled)


def peak_flops(device=None) -> Optional[float]:
    """Peak bf16 dense FLOPs/s of ``device`` (default: CUDA device 0), or
    None for a card the table does not know or for the CPU."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for k, v in PEAK_FLOPS.items():
        if k in name:
            return v
    return None


# ---------------------------------------------------------------------------
# HBM accounting
# ---------------------------------------------------------------------------


def hbm_snapshot() -> List[dict]:
    """Per-device rows of this process's allocator bytes.

    For every CUDA device of an initialised CUDA context: allocated bytes
    now and at peak (``torch.cuda.memory_stats``) and the card's total
    (``mem_get_info``), ``source`` "torch.cuda".  A process without a CUDA
    context -- the CPU test lanes, a driver that never touched the card --
    reports one "cpu" row with ``source`` "cpu", holding no device bytes,
    so a dashboard never reads it as allocator truth.  Never the first CUDA
    call of a process."""
    import torch

    if not torch.cuda.is_initialized():
        return [{"device": "cpu", "kind": "cpu", "used_bytes": 0,
                 "limit_bytes": 0, "peak_bytes": 0, "source": "cpu"}]
    rows: List[dict] = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        rows.append({
            "device": f"cuda:{i}",
            "kind": torch.cuda.get_device_name(i),
            "used_bytes": int(stats.get("allocated_bytes.all.current", 0)),
            "limit_bytes": int(total),
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
            "source": "torch.cuda",
        })
    return rows


def record_hbm() -> List[dict]:
    """Record the per-device gauges and return the snapshot rows."""
    rows = hbm_snapshot()
    if not enabled():
        return rows
    from ray_tpu_torch._private import runtime_metrics

    for r in rows:
        runtime_metrics.set_device_hbm(r["device"], r["used_bytes"],
                                       r["limit_bytes"])
    return rows


def device_used_bytes() -> int:
    """Total live bytes across local devices (for the transient split)."""
    return sum(r["used_bytes"] for r in hbm_snapshot())


def tree_nbytes(tree) -> int:
    """Summed tensor bytes of a tree of tensors (nested dicts, lists and
    tuples; other leaves count zero).  Metadata only."""
    from ray_tpu_torch._private.tree import tree_leaves

    return int(sum(leaf.numel() * leaf.element_size()
                   for leaf in tree_leaves(tree)
                   if hasattr(leaf, "element_size")))


# ---------------------------------------------------------------------------
# Compile watch
# ---------------------------------------------------------------------------

_UNATTRIBUTED = "_jax"
_MAX_PROGRAMS = 256
_MAX_EVENTS = 512


class _CompileWatch:
    """Process-wide jit-compile observer.

    Two feeds, both from the capture sites: ``note_trace(program)``
    right before a CUDA-graph capture (each call marks an imminent
    capture and names it) and ``note_compile(program, seconds)`` right
    after it.  Trace counts back ``trace_count``; captures back the
    ``ray_tpu_jit_compiles_total`` / ``_seconds_total`` families.
    """

    def __init__(self):
        self._lock = make_lock("device_telemetry._CompileWatch._lock")
        self._trace_counts: Dict[str, int] = {}
        self._compile_counts: Dict[str, int] = {}
        self._compile_seconds: Dict[str, float] = {}
        self._shape_keys: Dict[str, set] = {}
        self._callers: Dict[str, str] = {}
        # (monotonic, program) ring for the storm detector
        self._events: collections.deque = collections.deque(
            maxlen=_MAX_EVENTS)
        self._tls = threading.local()

    # -- feeds ---------------------------------------------------------------

    def note_trace(self, program: str, shape_key: Any = None) -> None:
        now = time.monotonic()
        self._tls.program = program
        # caller summary: nearest non-jax, non-telemetry frames — who is
        # retracing this program (the storm report names them)
        callers = _caller_summary()
        with self._lock:
            self._trace_counts[program] = \
                self._trace_counts.get(program, 0) + 1
            if shape_key is not None:
                keys = self._shape_keys.setdefault(program, set())
                if len(keys) < 64:
                    keys.add(repr(shape_key))
            if callers:
                self._callers[program] = callers
            self._events.append((now, program))
        _heartbeat_stamp()

    def note_compile(self, program: Optional[str], seconds: float) -> None:
        program = program or _UNATTRIBUTED
        with self._lock:
            if (program not in self._compile_counts
                    and len(self._compile_counts) >= _MAX_PROGRAMS):
                program = _UNATTRIBUTED
            self._compile_counts[program] = \
                self._compile_counts.get(program, 0) + 1
            self._compile_seconds[program] = \
                self._compile_seconds.get(program, 0.0) + seconds
        if enabled():
            from ray_tpu_torch._private import runtime_metrics

            runtime_metrics.inc_jit_compile(program, seconds)
        _heartbeat_stamp()

    def current_program(self) -> Optional[str]:
        return getattr(self._tls, "program", None)

    # -- reads ---------------------------------------------------------------

    def trace_count(self, program: str) -> int:
        with self._lock:
            return self._trace_counts.get(program, 0)

    def storm_report(self, threshold: Optional[int] = None,
                     window_s: Optional[float] = None) -> List[dict]:
        """Programs re-tracing/re-compiling fast enough to be a storm:
        >= threshold events inside the trailing window, newest-first."""
        from ray_tpu_torch._private.config import global_config

        cfg = global_config()
        threshold = threshold or cfg.compile_storm_threshold
        window_s = window_s or cfg.compile_storm_window_s
        cutoff = time.monotonic() - window_s
        with self._lock:
            recent: Dict[str, int] = {}
            for t, program in self._events:
                if t >= cutoff:
                    recent[program] = recent.get(program, 0) + 1
            out = []
            for program, n in recent.items():
                if n >= threshold:
                    out.append({
                        "program": program,
                        "compiles": n,
                        "window_s": window_s,
                        "shape_keys": sorted(
                            self._shape_keys.get(program, ()))[:16],
                        "callers": self._callers.get(program, ""),
                        "total_traces": self._trace_counts.get(program, 0),
                        "total_compile_seconds": round(
                            self._compile_seconds.get(program, 0.0), 3),
                    })
        out.sort(key=lambda r: -r["compiles"])
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "traces": dict(self._trace_counts),
                "compiles": dict(self._compile_counts),
                "compile_seconds": {k: round(v, 4) for k, v in
                                    self._compile_seconds.items()},
            }

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._trace_counts.clear()
            self._compile_counts.clear()
            self._compile_seconds.clear()
            self._shape_keys.clear()
            self._callers.clear()
            self._events.clear()


_watch = _CompileWatch()


def _caller_summary(limit: int = 3) -> str:
    """Nearest application frames (file:line:function), skipping torch and
    this module -- the names a storm report blames."""
    out = []
    try:
        for f in reversed(traceback.extract_stack(limit=24)):
            fn = f.filename
            base = fn.rsplit("/", 1)[-1]
            if "/torch/" in fn or base == "device_telemetry.py":
                continue
            out.append(f"{base}:{f.lineno}:{f.name}")
            if len(out) >= limit:
                break
    except Exception:  # noqa: BLE001 — forensics must never raise
        pass
    return " <- ".join(out)


def note_trace(program: str, shape_key: Any = None) -> None:
    """Mark an imminent capture of ``program`` (call right before a
    CUDA-graph capture, the port's compile).  Always books into the watch
    — ``trace_count`` must work even with the metric layer disabled — and
    starts the heartbeat on first use."""
    install()
    _watch.note_trace(program, shape_key)


def note_compile(program: str, seconds: float) -> None:
    """Book one finished capture of ``program`` and its seconds (call
    right after the capture; the twin of the reference's backend-compile
    event)."""
    _watch.note_compile(program, seconds)


def trace_count(program: str) -> int:
    return _watch.trace_count(program)


def storm_report(threshold: Optional[int] = None,
                 window_s: Optional[float] = None) -> List[dict]:
    return _watch.storm_report(threshold, window_s)


def compile_snapshot() -> dict:
    return _watch.snapshot()


_installed = False
_install_lock = make_lock("device_telemetry._install_lock")


def install() -> None:
    """Start the telemetry heartbeat (once per process).  The reference
    also registers a jax.monitoring listener here; the port's capture sites
    report themselves."""
    global _installed
    if _installed:
        return
    with _install_lock:
        _installed = True
    if enabled():
        _start_heartbeat()


# ---------------------------------------------------------------------------
# Heartbeat (satellite: gauge expiry during long compiles)
# ---------------------------------------------------------------------------

_hb_thread: Optional[threading.Thread] = None
_hb_lock = make_lock("device_telemetry._hb_lock")
_hb_last_stamp = 0.0


def _default_heartbeat_push() -> None:
    from ray_tpu_torch._private import runtime_metrics

    runtime_metrics.maybe_push()


# rebindable for tests (injected push recorder)
_heartbeat_push: Callable[[], None] = _default_heartbeat_push


def _heartbeat_stamp() -> None:
    """Cheap liveness stamp from compile-observer feeds; the loop uses it
    only for introspection — the push itself rides the daemon thread."""
    global _hb_last_stamp
    _hb_last_stamp = time.monotonic()


def _start_heartbeat(interval_s: Optional[float] = None) -> None:
    """Start the telemetry heartbeat daemon (idempotent).

    The thread re-pushes this process's metrics every
    ``device_telemetry_heartbeat_s`` so the GCS's silent-reporter gauge
    sweep (gcs.py ``_GAUGE_STALE_S``) sees a fresh receive stamp even
    while every request/step thread is blocked inside one long jit
    compile — the replica's utilization gauges read stale-but-present
    instead of vanishing from ``state.node_metrics()``."""
    global _hb_thread
    with _hb_lock:
        if _hb_thread is not None and _hb_thread.is_alive():
            return

        def loop():
            from ray_tpu_torch._private.config import global_config

            while True:
                period = interval_s or \
                    global_config().device_telemetry_heartbeat_s
                time.sleep(max(0.05, period))
                try:
                    _heartbeat_push()
                except Exception:  # noqa: BLE001 — no GCS yet / teardown
                    pass

        _hb_thread = threading.Thread(
            target=loop, daemon=True, name="device-telemetry-heartbeat")
        _hb_thread.start()


# ---------------------------------------------------------------------------
# Engine utilization & headroom
# ---------------------------------------------------------------------------


class EngineTelemetry:
    """Per-engine utilization recorder.

    Single writer — the engine step loop.  ``note_step()`` stores plain
    slots every step (the <10 µs budget) and flushes bound gauges at most
    every ``device_telemetry_flush_interval_s``; the HBM split flushes on
    a 10x slower cadence (it reads the CUDA allocator's stats and the
    card's total).  All values arrive as locals captured under the engine lock —
    nothing here takes it."""

    __slots__ = ("deployment", "clock", "active_slots", "max_slots",
                 "free_blocks", "total_blocks", "pending",
                 "prefill_spent", "prefill_budget", "duty_cycle",
                 "steps", "weights_bytes", "kv_pool_bytes",
                 "_last_step_end", "_flush_interval", "_last_flush",
                 "_last_hbm_flush", "_last_hbm")

    def __init__(self, deployment: str, *, weights_bytes: int = 0,
                 kv_pool_bytes: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 flush_interval_s: Optional[float] = None):
        from ray_tpu_torch._private.config import global_config

        self.deployment = deployment
        self.clock = clock
        self.weights_bytes = weights_bytes
        self.kv_pool_bytes = kv_pool_bytes
        self.active_slots = 0
        self.max_slots = 0
        self.free_blocks = 0
        self.total_blocks = 0
        self.pending = 0
        self.prefill_spent = 0
        self.prefill_budget = 0
        self.duty_cycle = 0.0
        self.steps = 0
        self._last_step_end = clock()
        self._flush_interval = (
            flush_interval_s if flush_interval_s is not None
            else global_config().device_telemetry_flush_interval_s)
        self._last_flush = float("-inf")
        self._last_hbm_flush = float("-inf")
        self._last_hbm: Dict[str, int] = {}

    def note_step(self, *, active_slots: int, max_slots: int,
                  free_blocks: int, total_blocks: int, pending: int,
                  prefill_spent: int, prefill_budget: int,
                  busy_s: float, now: float) -> None:
        """Book one engine step.  ``busy_s`` is the device-dispatch time
        of the step body; wall is measured here as the time since the
        previous step ended, so idle gaps between steps depress the duty
        cycle exactly as they depress chip utilization."""
        wall = now - self._last_step_end
        self._last_step_end = now
        self.active_slots = active_slots
        self.max_slots = max_slots
        self.free_blocks = free_blocks
        self.total_blocks = total_blocks
        self.pending = pending
        self.prefill_spent = prefill_spent
        self.prefill_budget = prefill_budget
        if wall > 0:
            d = busy_s / wall
            self.duty_cycle = d if d < 1.0 else 1.0
        self.steps += 1
        if now - self._last_flush >= self._flush_interval:
            self._last_flush = now
            self._flush(now)

    def _flush(self, now: float) -> None:
        from ray_tpu_torch._private import runtime_metrics

        runtime_metrics.record_engine_utilization(
            self.deployment,
            self.active_slots / self.max_slots if self.max_slots else 0.0,
            ((self.total_blocks - self.free_blocks) / self.total_blocks
             if self.total_blocks else 0.0),
            (self.prefill_spent / self.prefill_budget
             if self.prefill_budget else 0.0),
            self.duty_cycle)
        if now - self._last_hbm_flush >= 10 * self._flush_interval:
            self._last_hbm_flush = now
            hbm = self.hbm_split()
            runtime_metrics.record_engine_hbm(
                self.deployment, hbm["weights_bytes"],
                hbm["kv_pool_bytes"], hbm["transient_bytes"])
            for r in record_hbm():
                self._last_hbm[r["device"]] = r["used_bytes"]

    def hbm_split(self) -> dict:
        """Weights / KV-pool / transient split.  Transient = device live
        bytes minus the two accounted segments, clamped at zero (other
        processes' allocations on a shared chip can make it negative)."""
        used = device_used_bytes()
        transient = used - self.weights_bytes - self.kv_pool_bytes
        return {
            "weights_bytes": self.weights_bytes,
            "kv_pool_bytes": self.kv_pool_bytes,
            "transient_bytes": max(0, transient),
            "device_used_bytes": used,
        }

    def rates(self) -> dict:
        """Step-derived rates for utilization rows (the exact occupancy
        numbers come from the engine's own bookkeeping, not from here)."""
        return {
            "duty_cycle": round(self.duty_cycle, 4),
            "prefill_budget_tokens": self.prefill_budget,
            "prefill_spent_tokens": self.prefill_spent,
            "prefill_spend_ratio": round(
                self.prefill_spent / self.prefill_budget, 4)
            if self.prefill_budget else 0.0,
            "steps": self.steps,
        }


def engine_telemetry_for(deployment: Optional[str], *, weights_bytes: int = 0,
                         kv_pool_bytes: int = 0) -> Optional[EngineTelemetry]:
    """Attach point for engines: an :class:`EngineTelemetry` when the
    layer is enabled and the engine serves a named deployment, else
    ``None`` (the books-nothing disabled path — one attribute read +
    None check per step)."""
    if deployment is None or not enabled():
        return None
    install()
    return EngineTelemetry(deployment, weights_bytes=weights_bytes,
                           kv_pool_bytes=kv_pool_bytes)


# ---------------------------------------------------------------------------
# Utilization registry + fold (state.utilization / bench / local mode)
# ---------------------------------------------------------------------------

# name -> weakref-ish provider callable returning a utilization row dict;
# serve replicas publish rows to the GCS KV, but local-testing-mode apps
# (no GCS, in-process replicas) and engine-direct use register here so
# state.utilization() still has a surface to fold
_providers: Dict[str, Callable[[], Optional[dict]]] = {}
_providers_lock = make_lock("device_telemetry._providers_lock")


def register_utilization_provider(name: str,
                                  fn: Callable[[], Optional[dict]]) -> None:
    with _providers_lock:
        _providers[name] = fn


def unregister_utilization_provider(name: str) -> None:
    with _providers_lock:
        _providers.pop(name, None)


def register_utilization_object(name: str, obj: Any) -> None:
    """Register ``obj.utilization`` behind a weakref — a GC'd engine or
    server drops out of the fold instead of being pinned alive."""
    ref = weakref.ref(obj)

    def provider() -> Optional[dict]:
        target = ref()
        if target is None:
            return None
        try:
            return target.utilization()
        except Exception:  # noqa: BLE001 — a dying engine books nothing
            return None

    register_utilization_provider(name, provider)


def local_utilization_rows() -> List[dict]:
    rows = []
    with _providers_lock:
        items = list(_providers.items())
    dead = []
    for name, fn in items:
        row = fn()
        if row is None:
            dead.append(name)
            continue
        row = dict(row)
        row.setdefault("replica", name)
        row["source"] = "local"
        rows.append(row)
    for name in dead:
        unregister_utilization_provider(name)
    return rows


def fold_utilization_rows(rows: List[dict]) -> dict:
    """Cluster utilization snapshot: per-deployment replica rows plus
    summed headroom — free decode slots and free KV blocks per deployment
    are THE autoscaler inputs, so the fold names them explicitly."""
    deployments: Dict[str, dict] = {}
    for row in rows:
        dep = str(row.get("deployment") or "?")
        d = deployments.setdefault(dep, {
            "replicas": [], "free_slots": 0, "total_slots": 0,
            "active_slots": 0, "free_kv_blocks": 0, "total_kv_blocks": 0,
            "duty_cycles": []})
        d["replicas"].append(row)
        slots = row.get("slots") or {}
        blocks = row.get("kv_blocks") or {}
        d["active_slots"] += int(slots.get("active", 0))
        d["total_slots"] += int(slots.get("max", 0))
        d["free_slots"] += int(slots.get("free", 0))
        d["free_kv_blocks"] += int(blocks.get("free", 0))
        d["total_kv_blocks"] += int(blocks.get("total", 0))
        if row.get("duty_cycle") is not None:
            d["duty_cycles"].append(float(row["duty_cycle"]))
    for d in deployments.values():
        duties = d.pop("duty_cycles")
        d["mean_duty_cycle"] = round(sum(duties) / len(duties), 4) \
            if duties else 0.0
        d["slot_occupancy"] = round(
            d["active_slots"] / d["total_slots"], 4) \
            if d["total_slots"] else 0.0
        d["kv_occupancy"] = round(
            (d["total_kv_blocks"] - d["free_kv_blocks"])
            / d["total_kv_blocks"], 4) if d["total_kv_blocks"] else 0.0
    return {
        "time": time.time(),
        "deployments": deployments,
        "replicas": sum(len(d["replicas"]) for d in deployments.values()),
    }


def local_utilization() -> dict:
    """Fold of this process's registered providers (local-testing-mode
    serve apps, engine-direct benches)."""
    return fold_utilization_rows(local_utilization_rows())


def util_kv_key(app: str, deployment: str, replica: str) -> str:
    return f"{UTIL_KV_PREFIX}{app}/{deployment}/{replica}"


# ---------------------------------------------------------------------------
# MFU accounting
# ---------------------------------------------------------------------------


def model_flops(cfg, tokens: int, *, seq_len: int,
                training: bool = True) -> float:
    """Analytic model FLOPs of ``tokens`` tokens at sequence length
    ``seq_len`` through ``cfg``'s family: its ``flops_per_token`` (a
    training step's forward and backward, 6N plus attention), a third of
    it for a forward alone."""
    from ray_tpu_torch.models import llama, moe

    family = moe if isinstance(cfg, moe.MoEConfig) else llama
    per_token = family.flops_per_token(cfg, seq_len)
    return float(tokens * (per_token if training else per_token / 3))


def note_train_step(run: str, *, model_flops: float, wall_s: float,
                    peak: Optional[float] = None) -> Optional[float]:
    """Record ``ray_tpu_train_mfu_ratio{run}``: model FLOPs of one step
    over (step wall * peak FLOPs/s).  Returns the ratio, or None where the
    card's peak is unknown (no MFU is reported then)."""
    if wall_s <= 0 or model_flops <= 0:
        return 0.0
    peak = peak or peak_flops()
    if peak is None:
        return None
    mfu = model_flops / wall_s / peak
    if enabled():
        from ray_tpu_torch._private import runtime_metrics

        runtime_metrics.set_train_mfu(run, mfu)
    return mfu


def note_serving_rate(deployment: str, tok_per_s: float,
                      n_chips: int = 1) -> float:
    """Record serving tok/s-per-chip for a deployment; returns the
    normalized figure."""
    per_chip = tok_per_s / max(1, n_chips)
    if enabled():
        from ray_tpu_torch._private import runtime_metrics

        runtime_metrics.set_serve_tokens_per_chip(deployment, per_chip)
    return per_chip


# ---------------------------------------------------------------------------
# Test hooks
# ---------------------------------------------------------------------------


def _reset_for_tests() -> None:
    """Clear watch state and the provider registry (the heartbeat thread,
    once started, stays: it is a process-lifetime singleton)."""
    _watch._reset_for_tests()
    with _providers_lock:
        _providers.clear()
