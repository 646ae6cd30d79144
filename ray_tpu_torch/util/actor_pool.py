"""ActorPool: round-robin work distribution over a fixed set of actors.

reference: python/ray/util/actor_pool.py.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: List[tuple] = []

    def submit(self, fn: Callable, value):
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return self._next_return_index < self._next_task_index or bool(self._pending_submits)

    def get_next(self, timeout=None):
        import ray_tpu_torch

        if self._next_return_index >= self._next_task_index:
            raise StopIteration("no pending results")
        future = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        value = ray_tpu_torch.get(future, timeout=timeout)
        self._return_actor(self._future_to_actor.pop(future))
        return value

    def get_next_unordered(self, timeout=None):
        import ray_tpu_torch

        if not self._future_to_actor:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        value = ray_tpu_torch.get(future)
        self._return_actor(self._future_to_actor.pop(future))
        for idx, fut in list(self._index_to_future.items()):
            if fut == future:
                del self._index_to_future[idx]
        return value

    def _return_actor(self, actor):
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._idle.append(actor)

    def map(self, fn: Callable, values: Iterable):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable):
        for v in values:
            self.submit(fn, v)
        while self._future_to_actor or self._pending_submits:
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor):
        self._idle.append(actor)
