"""Node bootstrap: assembles GCS + raylet for head/worker nodes.

reference: python/ray/_private/node.py (start_head_processes :1361,
start_ray_processes :1390).  The reference spawns separate OS processes for
gcs_server and raylet; here both are threaded servers hosted in the calling
process (workers are always real subprocesses), which is also how the
reference's test Cluster utility packs multiple raylets into one process.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.raylet import Raylet


class Node:
    def __init__(
        self,
        head: bool = True,
        gcs_address: Optional[Tuple[str, int]] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
        env: Optional[Dict[str, str]] = None,
        gcs_port: int = 0,
        gcs_host: str = "127.0.0.1",
        gcs_persistence_path: Optional[str] = None,
    ):
        self.gcs: Optional[GcsServer] = None
        if head:
            self.gcs = GcsServer(host=gcs_host, port=gcs_port,
                                 persistence_path=gcs_persistence_path)
            gcs_address = self.gcs.address
        assert gcs_address is not None, "worker node needs gcs_address"
        self.gcs_address = tuple(gcs_address)
        self.raylet = Raylet(
            gcs_address=self.gcs_address,
            resources=resources,
            labels=labels,
            object_store_memory=object_store_memory,
            is_head=head,
            env=env,
        )

    @property
    def node_id(self):
        return self.raylet.node_id

    @property
    def raylet_address(self):
        return self.raylet.address

    def shutdown(self):
        self.raylet.shutdown()
        if self.gcs is not None:
            self.gcs.shutdown()
