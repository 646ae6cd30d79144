"""Distributed FIFO queue backed by an actor.

reference: python/ray/util/queue.py.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: List[Any] = []

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def get(self):
        if not self.items:
            return (False, None)
        return (True, self.items.pop(0))

    def qsize(self) -> int:
        return len(self.items)

    def empty(self) -> bool:
        return not self.items


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        import ray_tpu_torch

        cls = ray_tpu_torch.remote(_QueueActor)
        if actor_options:
            cls = cls.options(**actor_options)
        self.actor = cls.remote(maxsize)

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put.remote(item)):
                return
            if not block or (deadline is not None and time.monotonic() > deadline):
                raise Full
            time.sleep(0.01)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get.remote())
            if ok:
                return item
            if not block or (deadline is not None and time.monotonic() > deadline):
                raise Empty
            time.sleep(0.01)

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.empty.remote())

    def shutdown(self):
        import ray_tpu_torch

        ray_tpu_torch.kill(self.actor)
