"""@serve.batch — opportunistic request batching.

reference: python/ray/serve/batching.py (@serve.batch decorator:
max_batch_size, batch_wait_timeout_s). Calls buffer until the batch fills or
the wait timeout lapses, then the wrapped function runs once on the list of
requests; each caller gets its element of the returned list.
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int, wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.wait_timeout_s = wait_timeout_s
        self._pending: List[tuple] = []  # (arg, future)
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None

    def submit(self, instance, arg) -> Future:
        fut: Future = Future()
        flush_now = False
        with self._lock:
            self._pending.append((arg, fut))
            if len(self._pending) >= self.max_batch_size:
                flush_now = True
            elif self._timer is None:
                self._timer = threading.Timer(
                    self.wait_timeout_s, self._flush, args=(instance,))
                self._timer.daemon = True
                self._timer.start()
        if flush_now:
            self._flush(instance)
        return fut

    def _flush(self, instance):
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            batch = self._pending
            self._pending = []
        if not batch:
            return
        args = [a for a, _ in batch]
        try:
            results = self.fn(instance, args) if instance is not None else self.fn(args)
            if hasattr(results, "__await__"):
                import asyncio

                results = asyncio.run(_await_it(results))
            if len(results) != len(args):
                raise ValueError(
                    f"batched fn returned {len(results)} results for {len(args)} inputs")
            for (_, fut), r in zip(batch, results):
                fut.set_result(r)
        except Exception as e:  # noqa: BLE001
            for _, fut in batch:
                fut.set_exception(e)


async def _await_it(coro):
    return await coro


_module_batchers = {}
_module_batchers_lock = threading.Lock()


def _get_batcher(registry, key, fn, max_batch_size, wait_s) -> _Batcher:
    b = registry.get(key)
    if b is None:
        b = registry.setdefault(key, _Batcher(fn, max_batch_size, wait_s))
    return b


def batch(_fn=None, *, max_batch_size: int = 10, batch_wait_timeout_s: float = 0.01):
    """Decorator for methods (or functions) taking a list of requests.

    The batcher (which holds locks/timers) is created lazily at call time and
    stored on the instance — the decorated class stays cloudpickle-able.
    """

    def wrap(fn):
        key = fn.__qualname__

        @functools.wraps(fn)
        def method_wrapper(self, arg):
            registry = self.__dict__.setdefault("_serve_batchers", {})
            b = _get_batcher(registry, key, fn, max_batch_size, batch_wait_timeout_s)
            return b.submit(self, arg).result()

        @functools.wraps(fn)
        def fn_wrapper(arg):
            with _module_batchers_lock:
                b = _get_batcher(_module_batchers, key, fn, max_batch_size,
                                 batch_wait_timeout_s)
            return b.submit(None, arg).result()

        import inspect

        params = list(inspect.signature(fn).parameters)
        is_method = params and params[0] == "self"
        return method_wrapper if is_method else fn_wrapper

    return wrap(_fn) if _fn is not None else wrap
