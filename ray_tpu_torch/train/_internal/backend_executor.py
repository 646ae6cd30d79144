"""Gang orchestration: placement group + worker group + backend hooks +
result polling + checkpoint persistence.

reference: python/ray/train/_internal/backend_executor.py — BackendExecutor
:73 (start :146, _create_placement_group :230, start_training :460,
get_next_results :588). TPU mapping (SURVEY §3.4): bundles are whole TPU
hosts; STRICT_SPREAD puts one worker per host; a tpu_slice pin keeps the
gang on one slice (the gang-scheduling atom, SURVEY hard-part #2).
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.config import CheckpointConfig, ScalingConfig

logger = logging.getLogger(__name__)


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
        run_dir: str,
        checkpoint_config: Optional[CheckpointConfig] = None,
        replica_holders: Optional[List[Any]] = None,
    ):
        # ring of ReplicaHolder actors (owned by the trainer, so they
        # outlive this executor and a drained gang's restart)
        self._replica_holders = replica_holders or []
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()
        self._scaling = scaling_config
        self._run_dir = run_dir
        self._ckpt_config = checkpoint_config or CheckpointConfig()
        self._pg = None
        self.worker_group: Optional[WorkerGroup] = None
        # continue the checkpoint sequence across gang restarts (fit() builds
        # a fresh executor per attempt against the same run_dir)
        from ray_tpu_torch.train._internal.checkpoint_util import existing_checkpoint_indices

        existing = existing_checkpoint_indices(run_dir)
        self._ckpt_counter = existing[-1] if existing else 0
        self._saved_checkpoints: List[tuple] = [
            (i, os.path.join(run_dir, f"checkpoint_{i:06d}")) for i in existing
        ]

    # -- lifecycle ----------------------------------------------------------
    def start(self, dataset_shards: Optional[List[Dict[str, Any]]] = None):
        num_workers = self._scaling.total_workers
        resources = self._scaling.worker_resources()
        self._pg = self._create_placement_group(num_workers, resources)
        self.worker_group = WorkerGroup(num_workers, resources, placement_group=self._pg)
        # rank assignment: sort by node so local ranks pack per host
        infos = self.worker_group.call("_node_info")
        node_ids = [i["node_id"] for i in infos]
        # which nodes host this gang — the trainer's drain watch compares
        # these against GCS node states to catch preemption notices mid-run
        self.worker_node_ids = [
            nid.hex() if hasattr(nid, "hex") else str(nid) for nid in node_ids
        ]
        local_rank: Dict[str, int] = {}
        node_rank: Dict[str, int] = {}
        import uuid

        import ray_tpu_torch

        # one id per gang attempt: snapshot rank-manifests from a crashed
        # or resized earlier attempt can never merge with this gang's
        gang_id = uuid.uuid4().hex
        setup_refs = []
        for rank, (w, nid) in enumerate(zip(self.worker_group.workers, node_ids)):
            lr = local_rank.get(nid, 0)
            local_rank[nid] = lr + 1
            if nid not in node_rank:
                node_rank[nid] = len(node_rank)
            shards = dataset_shards[rank] if dataset_shards else None
            setup_refs.append(
                w._setup_session.remote(
                    world_size=num_workers,
                    world_rank=rank,
                    local_rank=lr,
                    local_world_size=0,  # patched below
                    node_rank=node_rank[nid],
                    run_name=os.path.basename(self._run_dir),
                    storage_path=self._run_dir,
                    dataset_shards=shards,
                    checkpoint_config=self._ckpt_config,
                    replica_holders=self._replica_holders,
                    gang_id=gang_id,
                )
            )
        ray_tpu_torch.get(setup_refs)
        # local_world_size now known per node; push it
        def _set_lws(lws_by_node, nid):
            from ray_tpu_torch.train._internal import session as session_mod

            s = session_mod.get_session()
            if s is not None:
                s.local_world_size = lws_by_node[nid]
            return True

        ray_tpu_torch.get([
            w._execute.remote(_set_lws, dict(local_rank), nid)
            for w, nid in zip(self.worker_group.workers, node_ids)
        ])
        self._backend.on_start(self.worker_group, self._backend_config)

    def _create_placement_group(self, num_workers: int, resources: Dict[str, float]):
        from ray_tpu_torch.util.placement_group import placement_group

        bundles = [dict(resources) for _ in range(num_workers)]
        pg = placement_group(
            bundles,
            strategy=self._scaling.placement_strategy,
            tpu_slice=self._scaling.tpu_slice,
        )
        if not pg.wait(timeout_seconds=120.0):
            raise TrainingFailedError(
                f"placement group with {num_workers}x{resources} bundles "
                "did not become ready within 120s (insufficient cluster resources?)"
            )
        return pg

    def start_training(self, train_fn: Callable, config: Optional[Dict[str, Any]] = None):
        assert self.worker_group is not None
        self._backend.on_training_start(self.worker_group, self._backend_config)
        self.worker_group.call("_start_training", train_fn, config)

    # -- result pumping -----------------------------------------------------
    def poll(self, timeout_s: float = 0.2):
        """One polling round over all workers; returns (merged_results,
        all_finished, first_error). Results reported in the same round as an
        error are still returned so their checkpoints aren't lost."""
        assert self.worker_group is not None
        outs = self.worker_group.call("_poll_results", timeout_s)
        errors = [e for (_, _, e) in outs if e]
        all_finished = all(f for (_, f, _) in outs)
        merged: List[Dict[str, Any]] = []
        for results, _, _ in outs:
            merged.extend(results)
        return merged, all_finished, (errors[0] if errors else None)

    def persist_checkpoint(self, result: Dict[str, Any]) -> Optional[Checkpoint]:
        """Copy a reported checkpoint into the run dir, enforce num_to_keep
        (reference: checkpoint_manager.py keep-top-k)."""
        snap_dir = result.get("snapshot_dir")
        if snap_dir is not None:
            # async snapshot already committed worker-side (manifest-last
            # atomic rename; retention ran there too with delta-chain
            # protection) — the driver only records the newest restorable
            # dir so gang restarts resume from it
            from ray_tpu_torch._private import flight_recorder

            flight_recorder.record("checkpoint", "snapshot_committed",
                                   os.path.basename(snap_dir))
            return Checkpoint(snap_dir)
        ckpt: Optional[Checkpoint] = result.get("checkpoint")
        if ckpt is None:
            return None
        from ray_tpu_torch.train._internal.checkpoint_util import (
            join_path,
            persist_staged_checkpoint,
        )

        self._ckpt_counter += 1
        dest = join_path(self._run_dir, f"checkpoint_{self._ckpt_counter:06d}")
        from ray_tpu_torch._private import flight_recorder

        flight_recorder.record("checkpoint", "persist",
                               os.path.basename(dest))
        persist_staged_checkpoint(ckpt.path, dest)
        persisted = Checkpoint(dest)
        score_attr = self._ckpt_config.checkpoint_score_attribute
        score = result["metrics"].get(score_attr) if score_attr else self._ckpt_counter
        self._saved_checkpoints.append((score, dest))
        keep = self._ckpt_config.num_to_keep
        if keep is not None and len(self._saved_checkpoints) > keep:
            reverse = self._ckpt_config.checkpoint_score_order == "max"
            self._saved_checkpoints.sort(key=lambda t: t[0], reverse=reverse)
            from ray_tpu_torch.train._internal.checkpoint_util import rmtree_any

            for _, path in self._saved_checkpoints[keep:]:
                rmtree_any(path)
            self._saved_checkpoints = self._saved_checkpoints[:keep]
        return persisted

    def shutdown(self):
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self.worker_group, self._backend_config)
            except Exception:  # noqa: BLE001 — backend hook is user code; shutdown proceeds
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001 — PG may already be gone with the cluster
                pass
            self._pg = None
