"""TPU accelerator manager — TPU chips and pod slices as first-class resources.

Rebuild of the reference's TPUAcceleratorManager
(reference: python/ray/_private/accelerators/tpu.py, 493 lines), keeping its
cluster-facing semantics:

- resource name ``"TPU"`` (tpu.py:118);
- chip autodetect via ``/dev/accel*`` and ``/dev/vfio`` (tpu.py:140-159);
- per-task chip counts restricted to ICI-topology-aligned blocks {1, 2, 4, 8}
  (tpu.py:16 TPU_VALID_CHIP_OPTIONS, :183-194);
- sub-host carving via ``TPU_VISIBLE_CHIPS`` + ``TPU_CHIPS_PER_HOST_BOUNDS`` /
  ``TPU_HOST_BOUNDS`` (tpu.py:35-48, :197-237);
- pod metadata from GKE env vars or the GCE metadata server (tpu.py:17-33,
  :67-87) — here also settable via plain env vars so tests and non-GCE
  deployments work identically;
- extra resources: ``{tpu_name: 1}`` on every pod worker plus
  ``{"TPU-<pod_type>-head": 1}`` on worker 0, the SPMD gang-dispatch pattern
  (tpu.py:396-459, documented :415-430);
- node labels ``ray.io/tpu-slice-name|worker-id|topology|pod-type``
  (tpu.py:461-492) used by slice-aware placement.
"""

from __future__ import annotations

import glob
import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager

logger = logging.getLogger(__name__)

TPU_VALID_CHIP_OPTIONS = (1, 2, 4, 8)

# env vars (same names as the reference / libtpu so jax picks them up)
TPU_VISIBLE_CHIPS_ENV = "TPU_VISIBLE_CHIPS"
TPU_CHIPS_PER_HOST_BOUNDS_ENV = "TPU_CHIPS_PER_HOST_BOUNDS"
TPU_HOST_BOUNDS_ENV = "TPU_HOST_BOUNDS"
# GKE-injected metadata (reference: tpu.py:17-33)
TPU_NAME_ENV = "TPU_NAME"
TPU_WORKER_ID_ENV = "TPU_WORKER_ID"
TPU_ACCELERATOR_TYPE_ENV = "TPU_ACCELERATOR_TYPE"
TPU_TOPOLOGY_ENV = "TPU_TOPOLOGY"
TPU_WORKER_HOSTNAMES_ENV = "TPU_WORKER_HOSTNAMES"
# Test/override hook
TPU_CHIP_COUNT_OVERRIDE_ENV = "RAY_TPU_NUM_CHIPS"

_SINGLE_HOST_BOUNDS = "1,1,1"

# chips-per-host bounds for sub-host slicing (reference: tpu.py:35-48)
_BOUNDS_FOR_CHIPS = {1: "1,1,1", 2: "1,2,1", 4: "2,2,1"}


class TPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return "TPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return TPU_VISIBLE_CHIPS_ENV

    # -- detection ------------------------------------------------------

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        override = os.environ.get(TPU_CHIP_COUNT_OVERRIDE_ENV)
        if override is not None:
            return int(override)
        # reference: tpu.py:140-159 — PCI accelerator device files.
        accel = glob.glob("/dev/accel*")
        if accel:
            return len(accel)
        try:
            vfio = glob.glob("/dev/vfio/[0-9]*")
            if vfio:
                return len(vfio)
        except OSError:
            pass
        return 0

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        pod_type = TPUAcceleratorManager._get_pod_type()
        if pod_type is None:
            return None
        # "v5p-128" -> "TPU-V5P"
        generation = pod_type.split("-")[0].upper()
        return f"TPU-{generation}"

    # -- request validation (reference: tpu.py:183-194) ------------------

    @staticmethod
    def validate_resource_request_quantity(quantity: float) -> Tuple[bool, Optional[str]]:
        if quantity != int(quantity) or int(quantity) not in TPU_VALID_CHIP_OPTIONS:
            return (
                False,
                f"TPU chip requests must be one of {TPU_VALID_CHIP_OPTIONS} "
                f"(ICI-topology-aligned blocks), got {quantity}. For more chips, "
                "request whole hosts via placement groups over a pod slice.",
            )
        return (True, None)

    # -- visible-chip carving (reference: tpu.py:197-237) ----------------

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        raw = os.environ.get(TPU_VISIBLE_CHIPS_ENV)
        if raw is None:
            return None
        return [x for x in raw.split(",") if x]

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        os.environ[TPU_VISIBLE_CHIPS_ENV] = ",".join(str(i) for i in ids)
        num = len(ids)
        if num in _BOUNDS_FOR_CHIPS:
            # Sub-host slice: libtpu needs the host geometry carved too.
            os.environ[TPU_CHIPS_PER_HOST_BOUNDS_ENV] = _BOUNDS_FOR_CHIPS[num]
            os.environ[TPU_HOST_BOUNDS_ENV] = _SINGLE_HOST_BOUNDS
        else:
            os.environ.pop(TPU_CHIPS_PER_HOST_BOUNDS_ENV, None)
            os.environ.pop(TPU_HOST_BOUNDS_ENV, None)
        try:
            # built-in gauge: chips this worker process has carved for itself
            # (the per-node total/claimed view lives in the raylet's
            # ray_tpu_tpu_chips gauges)
            from ray_tpu_torch._private import runtime_metrics

            runtime_metrics.TPU_PROCESS_CHIPS.set(num)
        except Exception:  # noqa: BLE001 — gauge set is telemetry; must never fail chip carving
            pass

    # -- pod metadata (reference: tpu.py:240-334) ------------------------

    @staticmethod
    def _get_pod_type() -> Optional[str]:
        v = os.environ.get(TPU_ACCELERATOR_TYPE_ENV)
        if v:
            return v
        return _gce_metadata("accelerator-type")

    @staticmethod
    def get_current_node_tpu_pod_type() -> Optional[str]:
        return TPUAcceleratorManager._get_pod_type()

    @staticmethod
    def get_current_node_tpu_name() -> Optional[str]:
        v = os.environ.get(TPU_NAME_ENV)
        if v:
            return v
        return _gce_metadata("instance-id")

    @staticmethod
    def get_current_node_tpu_worker_id() -> Optional[int]:
        v = os.environ.get(TPU_WORKER_ID_ENV)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                return None
        v = _gce_metadata("agent-worker-number")
        return int(v) if v is not None else None

    @staticmethod
    def get_current_node_tpu_topology() -> Optional[str]:
        v = os.environ.get(TPU_TOPOLOGY_ENV)
        if v:
            return v
        return _gce_metadata("tpu-env:TOPOLOGY")

    @staticmethod
    def get_num_workers_in_pod() -> int:
        hostnames = os.environ.get(TPU_WORKER_HOSTNAMES_ENV)
        if hostnames:
            return len(hostnames.split(","))
        pod_type = TPUAcceleratorManager._get_pod_type()
        chips_here = TPUAcceleratorManager.get_current_node_num_accelerators()
        if pod_type and chips_here:
            try:
                # "<gen>-<total_cores>"; v5p cores==chips*2, v5e/v6e cores==chips.
                total = int(pod_type.split("-")[-1])
                gen = pod_type.split("-")[0]
                chips_total = total // 2 if gen in ("v4", "v5p") else total
                return max(1, chips_total // chips_here)
            except (ValueError, ZeroDivisionError):
                pass
        return 1

    # -- extra resources: the SPMD gang pattern (reference: tpu.py:396-459)

    @staticmethod
    def get_current_node_additional_resources() -> Dict[str, float]:
        """Every pod worker exposes ``{<tpu_name>: 1}``; worker 0 additionally
        exposes ``{"TPU-<pod_type>-head": 1}``.  A gang submits one task to the
        head resource, which then fans out one task per pod worker against the
        name resource (reference pattern documented at tpu.py:415-430)."""
        resources: Dict[str, float] = {}
        if TPUAcceleratorManager.get_current_node_num_accelerators() == 0:
            return resources
        name = TPUAcceleratorManager.get_current_node_tpu_name()
        pod_type = TPUAcceleratorManager._get_pod_type()
        worker_id = TPUAcceleratorManager.get_current_node_tpu_worker_id()
        if name:
            resources[name] = 1
        if pod_type and worker_id == 0:
            resources[f"TPU-{pod_type}-head"] = 1
        return resources

    # -- node labels (reference: tpu.py:461-492) -------------------------

    @staticmethod
    def get_current_node_labels() -> Dict[str, str]:
        labels: Dict[str, str] = {}
        if TPUAcceleratorManager.get_current_node_num_accelerators() == 0:
            return labels
        name = TPUAcceleratorManager.get_current_node_tpu_name()
        worker_id = TPUAcceleratorManager.get_current_node_tpu_worker_id()
        topology = TPUAcceleratorManager.get_current_node_tpu_topology()
        pod_type = TPUAcceleratorManager._get_pod_type()
        if name:
            labels["ray.io/tpu-slice-name"] = name
        if worker_id is not None:
            labels["ray.io/tpu-worker-id"] = str(worker_id)
        if topology:
            labels["ray.io/tpu-topology"] = topology
        if pod_type:
            labels["ray.io/tpu-pod-type"] = pod_type
        return labels


def _gce_metadata(key: str) -> Optional[str]:
    """GCE metadata server lookup (reference: tpu.py:67-87). Short timeout;
    returns None off-GCE."""
    return _gce_metadata_path(f"instance/attributes/{key}")


def _gce_metadata_path(path: str, timeout: float = 0.5) -> Optional[str]:
    """Fetch an arbitrary computeMetadata/v1 path (the maintenance endpoints
    — ``instance/preempted``, ``instance/maintenance-event`` — live OUTSIDE
    instance/attributes/).  Returns None off-GCE or on any error."""
    if os.environ.get("RAY_TPU_DISABLE_METADATA_SERVER"):
        return None
    try:
        import urllib.request

        req = urllib.request.Request(
            f"http://metadata.google.internal/computeMetadata/v1/{path}",
            headers={"Metadata-Flavor": "Google"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode()
    except Exception:  # noqa: BLE001
        return None


# ---------------------------------------------------------------------------
# Maintenance / preemption watcher (reference direction: GCE announces VM
# termination through the metadata server — instance/preempted flips to TRUE
# on Spot reclamation, instance/maintenance-event announces host maintenance;
# watching them is how a preemption becomes a *graceful drain* instead of an
# unexplained node death)
# ---------------------------------------------------------------------------

PREEMPTED_PATH = "instance/preempted"
MAINTENANCE_EVENT_PATH = "instance/maintenance-event"

# drain windows the platform effectively grants: a Spot preemption delivers
# ACPI shutdown ~30 s out; announced host maintenance gives a longer runway
_PREEMPTED_DEADLINE_S = 30.0
_MAINTENANCE_DEADLINE_S = 60.0


def get_maintenance_notice(
        fetch: Optional[Callable[[str], Optional[str]]] = None,
) -> Optional[Dict[str, object]]:
    """One poll of the GCE maintenance endpoints.

    Returns ``{"kind": ..., "deadline_s": ...}`` when the platform has
    announced this VM is going away, else None.  ``fetch`` injects the
    metadata transport for tests (called with the metadata path)."""
    fetch = fetch or _gce_metadata_path
    preempted = fetch(PREEMPTED_PATH)
    if preempted and preempted.strip().upper() == "TRUE":
        return {"kind": "preempted", "deadline_s": _PREEMPTED_DEADLINE_S}
    event = fetch(MAINTENANCE_EVENT_PATH)
    if event and event.strip() and event.strip().upper() != "NONE":
        return {"kind": event.strip(), "deadline_s": _MAINTENANCE_DEADLINE_S}
    return None


def parse_testing_notice(spec: str) -> Optional[Dict[str, float]]:
    """Parse the ``testing_preemption_notice`` chaos knob:
    ``"<delay_s>:<kind>:<deadline_s>"`` (kind and deadline optional)."""
    if not spec:
        return None
    parts = str(spec).split(":")
    try:
        delay = float(parts[0])
    except (ValueError, IndexError):
        logger.warning("unparseable testing_preemption_notice %r", spec)
        return None
    kind = parts[1] if len(parts) > 1 and parts[1] else "preempted"
    try:
        deadline = float(parts[2]) if len(parts) > 2 else _PREEMPTED_DEADLINE_S
    except ValueError:
        deadline = _PREEMPTED_DEADLINE_S
    return {"delay_s": delay, "kind": kind, "deadline_s": deadline}


class TpuMaintenanceWatcher:
    """Background poller turning a platform maintenance announcement into one
    ``on_notice({"kind", "deadline_s"})`` callback.

    The transport is injectable (``fetch``) and ``testing_notice`` ("<delay>:
    <kind>:<deadline>") synthesizes a deterministic notice without any
    metadata server — the chaos-style test hook, like ``testing_rpc_failure``.
    The callback fires at most once; the watcher then exits."""

    def __init__(self, on_notice: Callable[[dict], None],
                 poll_interval_s: Optional[float] = None,
                 fetch: Optional[Callable[[str], Optional[str]]] = None,
                 testing_notice: Optional[str] = None):
        if poll_interval_s is None:
            from ray_tpu_torch._private.config import global_config

            poll_interval_s = global_config().maintenance_poll_interval_s
        self._on_notice = on_notice
        self._poll_interval = max(float(poll_interval_s), 0.05)
        self._fetch = fetch
        self._testing = parse_testing_notice(testing_notice or "")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tpu-maintenance-watch")
            self._thread.start()

    def stop(self):
        self._stop.set()

    def poll_once(self) -> Optional[dict]:
        return get_maintenance_notice(self._fetch)

    def _run(self):
        if self._testing is not None:
            if not self._stop.wait(self._testing["delay_s"]):
                self._fire({"kind": self._testing["kind"],
                            "deadline_s": self._testing["deadline_s"]})
            return
        while not self._stop.wait(self._poll_interval):
            notice = self.poll_once()
            if notice is not None:
                self._fire(notice)
                return

    def _fire(self, notice: dict):
        self.fired = True
        logger.warning("TPU maintenance notice: %s (deadline %.0f s)",
                       notice.get("kind"), notice.get("deadline_s", 0.0))
        try:
            self._on_notice(notice)
        except Exception:  # noqa: BLE001
            logger.exception("maintenance notice callback failed")
