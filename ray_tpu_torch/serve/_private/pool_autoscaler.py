"""SLO-feedback pool autoscaling: burn alerts actuate replica counts.

Closes the loop from sketch to chip count (ROADMAP item 1): the watch
engine evaluates multiwindow burn rules over the ingress latency
sketches — ``serve_ttft_burn`` on ``ray_tpu_serve_ttft_seconds`` and
``serve_itl_burn`` on ``ray_tpu_serve_itl_seconds`` — and publishes
firing/cleared transitions on the tree-pubsub ALERT channel.  This module
subscribes and actuates the disaggregated pools: TTFT burning
means prompts wait for prefill capacity → scale ``{name}-prefill``; ITL
burning means decode batches are oversubscribed → scale
``{name}-decode``.  The alert-driven posture (vs polling the history
store) is the 2510.20171 control-plane shape: flat fan-out breaks first,
so enforcement rides the existing tree channel.

Hysteresis is layered: the watch rules already hold multiwindow
both-burning AND for/clear_for delays, and the actuator adds a
per-pool cooldown so alert flapping cannot thrash replica counts.
Scale-DOWN has an extra guard: a pool is only shrunk while its alert is
clear AND the utilization fold shows mean duty cycle under the
headroom threshold — a quiet alert on a busy pool (e.g. budget recovered
exactly because capacity was added) never removes chips.

Everything is injected — ``actuate``/``current``/``headroom_source``
callables and a clock — so the end-to-end actuation test drives a
synthetic breach through a real WatchEngine into a recording actuator
with zero sleeps.  In production the controller owns one instance wired
to its ``scale_deployment`` and subscribes it to ALERT transitions.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

# watch-rule name -> disagg pool suffix (build_disagg_llm_deployment
# names its stages {name}-prefill / {name}-decode)
RULE_POOL: Dict[str, str] = {
    "serve_ttft_burn": "prefill",
    "serve_itl_burn": "decode",
}


def _subkey_tags(key: str) -> Dict[str, str]:
    """Parse a watch transition's group subkey (``"deployment=llm"``,
    ``"deployment=llm,tenant=a"``) back into tags."""
    out: Dict[str, str] = {}
    for part in (key or "").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


class PoolAutoscaler:
    """Alert-driven prefill/decode pool scaler with cooldown + headroom.

    ``actuate(deployment, num_replicas)`` applies a new count;
    ``current(deployment)`` reads the present one; ``headroom_source(
    deployment)`` returns the pool's mean duty cycle (0..1) from the
    utilization fold, or None when unknown (unknown = never shrink)."""

    def __init__(self, actuate: Callable[[str, int], None],
                 current: Callable[[str], int],
                 config=None,
                 clock: Callable[[], float] = time.monotonic,
                 headroom_source: Optional[Callable[[str],
                                                    Optional[float]]] = None):
        from ray_tpu_torch._private.config import global_config

        cfg = config or global_config()
        self.enabled = bool(cfg.serve_pool_autoscaler_enabled)
        self.step = max(1, int(cfg.serve_pool_scale_step))
        self.cooldown_s = float(cfg.serve_pool_scale_cooldown_s)
        self.min_replicas = int(cfg.serve_pool_min_replicas)
        self.max_replicas = int(cfg.serve_pool_max_replicas)
        self.headroom = float(cfg.serve_pool_scale_down_headroom)
        self._actuate = actuate
        self._current = current
        self._clock = clock
        self._headroom_source = headroom_source or (lambda dep: None)
        # pool -> {"firing": bool, "rule": str, "last_actuation": t}
        self._pools: Dict[str, dict] = {}
        self._actuations: list = []   # bounded forensics ring

    # -- alert intake --------------------------------------------------------

    def on_alert(self, transition: dict) -> None:
        """One watch transition (the ALERT pubsub payload / engine
        on_transition callback).  Firing scales the mapped pool up
        immediately (subject to cooldown/max); cleared arms the tick()
        scale-down path."""
        if not self.enabled:
            return
        pool_suffix = RULE_POOL.get(transition.get("rule", ""))
        if pool_suffix is None:
            return
        dep = _subkey_tags(transition.get("key", "")).get("deployment")
        if not dep:
            return
        target = f"{dep}-{pool_suffix}"
        st = self._pools.setdefault(
            target, {"firing": False, "rule": transition["rule"],
                     "last_actuation": float("-inf")})
        if transition.get("state") == "firing":
            st["firing"] = True
            self._scale(target, st, +self.step,
                        reason=f"{transition['rule']} firing "
                               f"(burn {transition.get('value', 0):.2f})")
        elif transition.get("state") == "cleared":
            st["firing"] = False

    # -- periodic ------------------------------------------------------------

    def tick(self) -> None:
        """Scale-down pass (runs on the controller's reconcile tick): a
        pool whose alert is clear, whose cooldown has passed and whose
        measured duty cycle is under the headroom threshold gives back one
        step of replicas."""
        if not self.enabled:
            return
        for target, st in list(self._pools.items()):
            if st["firing"]:
                continue
            if self._clock() - st["last_actuation"] < self.cooldown_s:
                continue
            try:
                if self._current(target) <= self.min_replicas:
                    continue
                duty = self._headroom_source(target)
            except Exception:  # noqa: BLE001 — no reading, no shrink
                continue
            if duty is None or duty >= self.headroom:
                continue
            self._scale(target, st, -self.step,
                        reason=f"alert clear, duty {duty:.2f} < "
                               f"headroom {self.headroom:.2f}")

    # -- actuation -----------------------------------------------------------

    def _scale(self, target: str, st: dict, delta: int, reason: str) -> None:
        now = self._clock()
        if delta > 0 and now - st["last_actuation"] < self.cooldown_s:
            return
        try:
            cur = int(self._current(target))
        except Exception:  # noqa: BLE001 — unknown deployment: nothing to do
            return
        new = max(self.min_replicas, min(self.max_replicas, cur + delta))
        if new == cur:
            return
        try:
            self._actuate(target, new)
        except Exception:  # noqa: BLE001 — actuation failures must not
            logger.exception("pool autoscaler actuation failed")  # kill intake
            return
        st["last_actuation"] = now
        self._actuations.append({
            "deployment": target, "from": cur, "to": new,
            "reason": reason, "time": now})
        if len(self._actuations) > 100:
            del self._actuations[:len(self._actuations) - 100]
        logger.info("pool autoscaler: %s %d -> %d (%s)",
                    target, cur, new, reason)

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "enabled": self.enabled,
            "pools": {t: dict(st) for t, st in self._pools.items()},
            "actuations": list(self._actuations),
        }


def utilization_headroom(deployment: str) -> Optional[float]:
    """Default headroom source: the cluster utilization fold's mean duty
    cycle for the pool, None when no replica has reported."""
    try:
        from ray_tpu_torch.util.state import api as state_api

        fold = state_api.utilization(deployment)
        row = ((fold or {}).get("deployments") or {}).get(deployment) or {}
        duty = row.get("mean_duty_cycle")
        return float(duty) if duty is not None else None
    except Exception:  # noqa: BLE001 — unknown reads as "never shrink"
        return None
