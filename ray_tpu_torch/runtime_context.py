"""Runtime context: who am I, where am I running.

reference: python/ray/runtime_context.py.
"""

from __future__ import annotations


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    @property
    def job_id(self):
        return self._worker.job_id

    @property
    def node_id(self):
        return self._worker.node_id

    @property
    def worker_id(self):
        return self._worker.worker_id

    @property
    def actor_id(self):
        return self._worker.actor_id

    @property
    def task_id(self):
        return self._worker.current_task_id

    def get_accelerator_ids(self):
        from ray_tpu_torch._private.accelerators.tpu import TPUAcceleratorManager

        ids = TPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        return {"TPU": ids or []}

    def preemption_deadline(self):
        """Wall-clock deadline (unix seconds) by which this process's node
        will be preempted/maintenance-cycled, or None when the node is not
        draining.  Long-running steps use it to checkpoint ahead of the
        platform taking the host (cheap: ~1 s-cached raylet poll)."""
        return self._worker.get_preemption_deadline()

    # reference-compat getter aliases (python/ray/runtime_context.py)
    def get_job_id(self):
        return self.job_id

    def get_node_id(self):
        return self.node_id

    def get_worker_id(self):
        return self.worker_id

    def get_actor_id(self):
        return self.actor_id

    def get_task_id(self):
        return self.task_id
