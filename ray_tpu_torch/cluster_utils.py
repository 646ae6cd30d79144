"""Multi-node clusters on one machine — the distributed-test workhorse.

reference: python/ray/cluster_utils.py (Cluster :135, add_node :202): N
raylets (each with its own object store, worker pool, and resource view)
against one GCS, all in the calling process; worker processes are real
subprocesses, so scheduling, spillback, object transfer, and failure paths
are exercised exactly as in a real multi-host deployment.
"""

from __future__ import annotations

from typing import Dict, Optional

from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.raylet import Raylet


class Cluster:
    def __init__(self, initialize_head: bool = True, head_node_args: Optional[dict] = None,
                 gcs_args: Optional[dict] = None):
        self._gcs_args = dict(gcs_args or {})
        self.gcs = GcsServer(**self._gcs_args)
        self.nodes: list[Raylet] = []
        self.head_node: Optional[Raylet] = None
        if initialize_head:
            self.head_node = self.add_node(**(head_node_args or {}))

    def kill_gcs(self):
        """Stop the GCS process-equivalent, leaving raylets/workers running."""
        self.gcs.shutdown()

    def restart_gcs(self):
        """Start a fresh GcsServer on the SAME address, reloading persisted
        state (requires gcs_args={"persistence_path": ...}; reference:
        gcs_server.h:115-122 + raylet re-registration node_manager.cc:948)."""
        port = self.gcs.address[1]
        args = dict(self._gcs_args)
        args["port"] = port
        self.gcs = GcsServer(**args)
        return self.gcs

    @property
    def address(self):
        return self.gcs.address

    def add_node(
        self,
        num_cpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
        env: Optional[Dict[str, str]] = None,
        **kwargs,
    ) -> Raylet:
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        node = Raylet(
            gcs_address=self.gcs.address,
            resources=res,
            labels=labels,
            object_store_memory=object_store_memory,
            is_head=self.head_node is None,
            env=env,
            **kwargs,  # e.g. testing_preemption_notice targets ONE node
        )
        self.nodes.append(node)
        if self.head_node is None:
            self.head_node = node
        return node

    def remove_node(self, node: Raylet, allow_graceful: bool = False):
        self.nodes.remove(node)
        node.shutdown()
        self.gcs.HandleNodeDead({"node_id": node.node_id, "reason": "removed by test"})
        if node is self.head_node:
            self.head_node = self.nodes[0] if self.nodes else None

    def connect_driver(self):
        """Create a driver CoreWorker attached to the head node's raylet."""
        import ray_tpu_torch

        assert self.head_node is not None
        return ray_tpu_torch.init(_raylet_addr=self.head_node.address, _gcs_addr=self.gcs.address)

    def shutdown(self):
        import ray_tpu_torch

        ray_tpu_torch.shutdown()
        for node in self.nodes:
            node.shutdown()
        self.nodes.clear()
        self.gcs.shutdown()
