"""Gang of training-worker actors.

reference: python/ray/train/_internal/worker_group.py — WorkerGroup :102 of
RayTrainWorker actors :19. Each worker hosts a session; the train_fn runs on
a session thread inside the actor so the driver can poll results while
training proceeds.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


class RayTrainWorker:
    """The actor class hosting one training process
    (reference: worker_group.py:19)."""

    def __init__(self):
        self._train_thread: Optional[threading.Thread] = None

    # generic execution hooks -------------------------------------------------
    def _execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def _setup_session(self, **session_kwargs):
        from ray_tpu_torch.train._internal import session as session_mod

        session_mod.init_session(**session_kwargs)
        return True

    def _start_training(self, train_fn: Callable, config: Optional[Dict[str, Any]]):
        from ray_tpu_torch.train._internal import session as session_mod

        s = session_mod.get_session()
        assert s is not None, "_setup_session must run first"

        def run():
            try:
                import inspect

                if len(inspect.signature(train_fn).parameters) >= 1:
                    train_fn(config or {})
                else:
                    train_fn()
            except BaseException as e:  # noqa: BLE001
                s.error = e
            finally:
                s.finished.set()

        self._train_thread = threading.Thread(target=run, daemon=True, name="train-fn")
        self._train_thread.start()
        return True

    def _poll_results(self, timeout_s: float = 0.2):
        """Drain any reported results; returns (results, finished, error_repr).

        The driver polls this (reference: backend_executor.py:588)."""
        import queue as queue_mod

        from ray_tpu_torch.train._internal import session as session_mod

        s = session_mod.get_session()
        if s is None:
            return [], True, None
        results = []
        try:
            results.append(s.result_queue.get(timeout=timeout_s))
            while True:
                results.append(s.result_queue.get_nowait())
        except queue_mod.Empty:
            pass
        # a finished train_fn with an async snapshot still draining is NOT
        # finished: killing the worker now would abandon the final
        # snapshot mid-persist (crash-safe, but needlessly lost) and drop
        # its commit notification
        finished = (s.finished.is_set() and s.result_queue.empty()
                    and s.persistence_idle())
        err = None
        if s.error is not None:
            import traceback

            err = "".join(traceback.format_exception(s.error))
        return results, finished, err

    def _shutdown_session(self):
        from ray_tpu_torch.train._internal import session as session_mod

        session_mod.shutdown_session()
        return True

    def _node_info(self):
        import socket

        import ray_tpu_torch

        ctx = ray_tpu_torch.get_runtime_context()
        return {
            "node_id": ctx.get_node_id(),
            "hostname": socket.gethostname(),
            "gpu_ids": ray_tpu_torch.get_gpu_ids(),
        }


class WorkerGroup:
    """N RayTrainWorker actors, optionally on a placement group
    (reference: worker_group.py:102)."""

    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 placement_group=None, max_concurrency: int = 4):
        import ray_tpu_torch
        from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

        self._pg = placement_group
        opts: Dict[str, Any] = {
            "num_cpus": resources_per_worker.get("CPU", 1.0),
            "resources": {k: v for k, v in resources_per_worker.items() if k != "CPU"},
            "max_concurrency": max_concurrency,
        }
        cls = ray_tpu_torch.remote(RayTrainWorker)
        self.workers = []
        for i in range(num_workers):
            o = dict(opts)
            if placement_group is not None:
                o["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group, placement_group_bundle_index=i
                )
            self.workers.append(cls.options(**o).remote())

    def __len__(self):
        return len(self.workers)

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run fn on every worker, return all results."""
        import ray_tpu_torch

        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w._execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, index: int, fn: Callable, *args, **kwargs):
        import ray_tpu_torch

        return ray_tpu_torch.get(self.workers[index]._execute.remote(fn, *args, **kwargs))

    def call(self, method: str, *args, **kwargs) -> List[Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get([getattr(w, method).remote(*args, **kwargs) for w in self.workers])

    def shutdown(self):
        import ray_tpu_torch

        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — already-dead worker is
                pass            # the goal of shutdown
        self.workers = []
