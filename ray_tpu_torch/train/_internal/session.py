"""Per-worker training session.

reference: python/ray/train/_internal/session.py — the train_fn runs in a
session thread; ``train.report(metrics, checkpoint)`` hands results to the
polling driver (backend_executor.py:588 get_next_results).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint


class TrainContext:
    """What user code can ask about its place in the gang
    (reference: ray.train.get_context())."""

    def __init__(self, session: "_TrainSession"):
        self._s = session

    def get_world_size(self) -> int:
        return self._s.world_size

    def get_world_rank(self) -> int:
        return self._s.world_rank

    def get_local_rank(self) -> int:
        return self._s.local_rank

    def get_local_world_size(self) -> int:
        return self._s.local_world_size

    def get_node_rank(self) -> int:
        return self._s.node_rank

    def get_trial_name(self) -> str:
        return self._s.run_name

    def get_experiment_name(self) -> str:
        return self._s.run_name

    def get_storage_path(self) -> Optional[str]:
        return self._s.storage_path


class _TrainSession:
    def __init__(self, *, world_size: int, world_rank: int, local_rank: int = 0,
                 local_world_size: int = 1, node_rank: int = 0,
                 run_name: str = "run", storage_path: Optional[str] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 checkpoint_config: Optional[Any] = None,
                 replica_holders: Optional[list] = None,
                 gang_id: str = ""):
        self.world_size = world_size
        self.world_rank = world_rank
        self.local_rank = local_rank
        self.local_world_size = local_world_size
        self.node_rank = node_rank
        self.run_name = run_name
        self.storage_path = storage_path
        self.dataset_shards = dataset_shards or {}
        self.result_queue: "queue.Queue" = queue.Queue()
        self.latest_checkpoint: Optional[Checkpoint] = None
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        # real buffer-empty seconds stamped by the ingest iterators
        # (data/_internal/ingest.DataShard); report() attaches the
        # accumulated value as input_wait_s so the driver's goodput ledger
        # reclassifies MEASURED starvation, not whatever user code happens
        # to report
        self._input_wait_s = 0.0
        self._input_wait_lock = threading.Lock()
        self._wrapped_shards: Dict[str, Any] = {}
        # async snapshot subsystem (train/_internal/snapshot.py): built
        # lazily on the first report(state=...) so state-less train loops
        # never pay for it
        self.checkpoint_config = checkpoint_config
        self.replica_holders = replica_holders or []
        self.gang_id = gang_id
        self._snapshot_mgr = None
        # device telemetry: the compile observer + metrics heartbeat keep
        # a worker blocked inside one long jit compile visible to the
        # GCS's silent-reporter gauge sweep (stale-but-present instead of
        # vanishing from state.node_metrics() mid-compile)
        from ray_tpu_torch._private import device_telemetry

        if device_telemetry.enabled():
            device_telemetry.install()
        self._last_report_t: Optional[float] = None

    # -- async snapshot subsystem -------------------------------------------
    def _snapshot_manager(self):
        if self._snapshot_mgr is not None:
            return self._snapshot_mgr
        from ray_tpu_torch.train._internal.checkpoint_util import is_remote_path
        from ray_tpu_torch.train._internal.snapshot import (
            SnapshotConfig,
            SnapshotManager,
        )

        if not self.storage_path or is_remote_path(self.storage_path):
            raise RuntimeError(
                "report(state=...) needs a local run dir (async per-shard "
                "snapshots commit through atomic renames + dir fsync); got "
                f"storage_path={self.storage_path!r}.  Report a staged "
                "Checkpoint instead, or point storage_path at a local/"
                "NFS mount.")
        cfg = self.checkpoint_config
        snap_cfg = SnapshotConfig(
            full_snapshot_interval=getattr(cfg, "full_snapshot_interval", 8),
            optimizer_state_interval=getattr(
                cfg, "optimizer_state_interval", 1),
            num_to_keep=getattr(cfg, "num_to_keep", None),
        )
        push = None
        if self.replica_holders:
            holders = self.replica_holders

            def push(peer: int, payload: dict) -> None:
                _call_holder(holders[peer % len(holders)], "put_replica",
                             self.world_rank, payload)

        def on_commit(snapshot_dir: str, step: int) -> None:
            # the commit rides the result queue like a reported checkpoint:
            # the driver learns the newest restorable dir without the
            # training thread ever waiting on persistence
            self.result_queue.put({
                "metrics": {"snapshot_step": step},
                "checkpoint": None,
                "snapshot_dir": snapshot_dir,
                "rank": self.world_rank,
            })

        def on_error(step: int, err: BaseException) -> None:
            # a FINAL snapshot's persist failure has no next save() to
            # raise from — ride the result queue so the driver logs it
            # loudly instead of the run finishing "clean" with a stale
            # latest checkpoint
            self.result_queue.put({
                "metrics": {"snapshot_step": step},
                "checkpoint": None,
                "snapshot_error": repr(err),
                "rank": self.world_rank,
            })

        self._snapshot_mgr = SnapshotManager(
            self.storage_path, world_rank=self.world_rank,
            world_size=self.world_size, config=snap_cfg,
            gang_id=self.gang_id, on_commit=on_commit, on_error=on_error,
            replica_push=push)
        return self._snapshot_mgr

    def restore_state(self, target: Any = None):
        """Newest restorable state, preferring a warm peer replica
        (host-RAM, seconds) over the newest committed snapshot on storage.
        Returns ``(state, step)`` or ``None`` when nothing is restorable.
        With ``target`` the state is resharded onto the target's mesh —
        any world size (elastic restore)."""
        from ray_tpu_torch.train._internal import snapshot as snapshot_mod
        from ray_tpu_torch.train._internal.checkpoint_util import is_remote_path

        payloads = _gather_replica_payloads(self.replica_holders)
        chosen = snapshot_mod.select_replica_set(payloads)
        latest = None
        if self.storage_path and not is_remote_path(self.storage_path):
            latest = snapshot_mod.latest_committed(self.storage_path)
        disk_step = -1
        if latest is not None:
            disk_step = snapshot_mod.load_manifest(latest)["step"]
        if chosen is not None and chosen[0]["step"] >= disk_step:
            return (snapshot_mod.restore_from_payloads(chosen, target),
                    chosen[0]["step"])
        if latest is not None:
            return snapshot_mod.restore_snapshot(latest, target), disk_step
        return None

    def persistence_idle(self) -> bool:
        """True when no async snapshot is draining — the driver must not
        declare the worker finished (and kill it) while the background
        thread is still persisting the final snapshot."""
        mgr = self._snapshot_mgr
        return mgr is None or mgr.inflight is None

    def note_input_wait(self, seconds: float) -> None:
        """Accumulate measured data-starvation seconds since the last
        report (called by the ingest iterators' buffer-empty stamps)."""
        if seconds > 0:
            with self._input_wait_lock:
                self._input_wait_s += seconds

    def consume_input_wait(self) -> float:
        with self._input_wait_lock:
            v, self._input_wait_s = self._input_wait_s, 0.0
            return v

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None,
               state: Any = None):
        # flight recorder: a report IS a step boundary — the last thing a
        # hung worker's tail shows is which step it finished (and whether a
        # checkpoint stage ran) before it stopped arriving
        from ray_tpu_torch._private import flight_recorder

        flight_recorder.record(
            "step", "report",
            f"rank{self.world_rank}"
            + (":ckpt" if checkpoint else "")
            + (":snap" if state is not None else ""))
        if state is not None:
            # async per-shard snapshot: this call pays ONLY backpressure +
            # the device→host staging copy; persistence commits on the
            # snapshot thread and rides the result queue via on_commit
            step = self._snapshot_manager().save(state)
            metrics = dict(metrics)
            metrics.setdefault("snapshot_step", step)
        # Persist worker-side BEFORE returning (the reference uploads from the
        # worker in report(), train/_internal/storage.py) — the caller may
        # delete its local checkpoint dir right after report() returns.
        if checkpoint is not None and self.storage_path:
            import shutil
            import tempfile
            import uuid

            from ray_tpu_torch.train._internal.checkpoint_util import is_remote_path

            if is_remote_path(self.storage_path):
                # remote run dir: stage locally; the driver-side persist
                # uploads from here (same-machine staging — the in-process
                # cluster model; multi-host gangs upload via save_sharded)
                base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch.staged")
            else:
                base = os.path.join(self.storage_path, ".staged")
            staged = os.path.join(base, f"ckpt_{uuid.uuid4().hex[:8]}")
            shutil.copytree(checkpoint.path, staged, dirs_exist_ok=True)
            checkpoint = Checkpoint(staged)
        metrics = dict(metrics)
        # device telemetry: a report carrying ``model_flops`` (the step's
        # model FLOPs) books ray_tpu_train_mfu_ratio{run} with wall = the
        # time since the previous report (a report IS the step boundary);
        # the derived ratio rides back on the metrics as ``mfu``
        now = time.monotonic()
        last, self._last_report_t = self._last_report_t, now
        mf = metrics.get("model_flops")
        if mf and last is not None and now > last:
            from ray_tpu_torch._private import device_telemetry

            mfu = device_telemetry.note_train_step(
                self.run_name, model_flops=float(mf), wall_s=now - last)
            if mfu is not None:  # None: the device's peak is unknown
                metrics.setdefault("mfu", round(mfu, 4))
        iw = self.consume_input_wait()
        if iw > 0 and "input_wait_s" not in metrics:
            # measured buffer-empty seconds ride every report; an explicit
            # user-reported value wins (back-compat)
            metrics["input_wait_s"] = iw
        self.result_queue.put({"metrics": metrics, "checkpoint": checkpoint,
                               "rank": self.world_rank})

    def get_dataset_shard(self, name: str = "train"):
        shard = self.dataset_shards.get(name)
        if shard is None:
            raise KeyError(f"no dataset shard named {name!r} was passed to the trainer")
        if not hasattr(shard, "iter_batches"):
            return shard  # opaque shard object: hand it through untouched
        wrapped = self._wrapped_shards.get(name)
        if wrapped is None or wrapped._shard is not shard:
            from ray_tpu_torch.data._internal.ingest import DataShard

            wrapped = DataShard(shard, name=name, session=self)
            self._wrapped_shards[name] = wrapped
        return wrapped


def _call_holder(holder, method: str, *args):
    """Invoke a ReplicaHolder method on a plain object (hermetic tests) or
    a ray actor handle (cluster gangs — payloads ride the object store)."""
    m = getattr(holder, method)
    if hasattr(m, "remote"):
        import ray_tpu_torch

        return ray_tpu_torch.get(m.remote(*args))
    return m(*args)


def _gather_replica_payloads(holders) -> list:
    """Every (rank → payload) entry across every reachable holder; a dead
    or unreachable holder contributes nothing (its payloads died with it)."""
    out = []
    for h in holders or []:
        try:
            reps = _call_holder(h, "all_replicas")
        except Exception:  # noqa: BLE001 — holder died with its node
            continue
        out.extend(reps.values())
    return out


_session: Optional[_TrainSession] = None
_session_lock = threading.Lock()


def init_session(**kwargs) -> _TrainSession:
    global _session
    with _session_lock:
        _session = _TrainSession(**kwargs)
        return _session


def get_session() -> Optional[_TrainSession]:
    return _session


def shutdown_session():
    global _session
    with _session_lock:
        if _session is not None and _session._snapshot_mgr is not None:
            try:
                # drain the in-flight persist so the last snapshot commits
                _session._snapshot_mgr.close(timeout=10.0)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        _session = None


# -- public API (ray.train.report / get_context / get_checkpoint) -----------

def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None,
           state: Any = None):
    s = get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.report() called outside a training session")
    s.report(metrics, checkpoint, state=state)


def restore_state(target: Any = None):
    """Newest restorable state for this gang member: a warm peer-RAM
    replica when one is fresher than storage (the preemption-drain fast
    path), else the newest committed async snapshot.  Returns
    ``(state, step)`` or ``None``; ``target`` reshards onto any mesh/world
    size (elastic restore)."""
    s = get_session()
    if s is None:
        raise RuntimeError("not inside a training session")
    return s.restore_state(target)


def get_context() -> TrainContext:
    s = get_session()
    if s is None:
        raise RuntimeError("not inside a training session")
    return TrainContext(s)


def get_checkpoint() -> Optional[Checkpoint]:
    s = get_session()
    return s.latest_checkpoint if s else None


def get_dataset_shard(name: str = "train"):
    s = get_session()
    if s is None:
        raise RuntimeError("not inside a training session")
    return s.get_dataset_shard(name)
