"""Model multiplexing: many models served by one replica pool.

reference: python/ray/serve/multiplex.py — @serve.multiplexed caches up to
``max_num_models_per_replica`` loaded models per replica (LRU), and the
request's model id is read via serve.get_multiplexed_model_id().
"""

from __future__ import annotations

import asyncio
import contextvars
import threading
from collections import OrderedDict
from functools import wraps
from typing import Any, Callable

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ray_tpu_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """reference: serve.get_multiplexed_model_id."""
    return _current_model_id.get()


def set_multiplexed_model_id(model_id: str):
    _current_model_id.set(model_id)


class _MultiplexWrapper:
    """Per-instance LRU of loaded models; thread-safe for concurrent
    replicas (reference: multiplex.py _ModelMultiplexWrapper)."""

    def __init__(self, load_fn: Callable, max_models: int):
        self._load_fn = load_fn
        self._max = max_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._loading: dict = {}  # model_id -> Event (first loader owns it)

    def load(self, instance, model_id: str):
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                loading = self._loading.get(model_id)
                if loading is None:
                    # we own the load; others wait on the event
                    loading = self._loading[model_id] = threading.Event()
                    break
            loading.wait()  # another thread is loading this model
        try:
            model = self._load_fn(instance, model_id)
            if asyncio.iscoroutine(model):
                model = asyncio.run(_await_coro(model))
            with self._lock:
                self._models[model_id] = model
                self._models.move_to_end(model_id)
                while len(self._models) > self._max:
                    evicted_id, evicted = self._models.popitem(last=False)
                    del_fn = getattr(evicted, "__del__", None)
                    if callable(del_fn):
                        try:
                            del_fn()
                        except Exception:  # noqa: BLE001 — user __del__ must not break eviction
                            pass
            return model
        finally:
            with self._lock:
                ev = self._loading.pop(model_id, None)
            if ev is not None:
                ev.set()

    @property
    def loaded_model_ids(self):
        with self._lock:
            return list(self._models)


async def _await_coro(coro):
    return await coro


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for a model-load method on a deployment class
    (reference: serve/multiplex.py @serve.multiplexed).

    The decorated method ``def get_model(self, model_id)`` becomes a cached
    loader; call it with the model id from the request.
    """

    def deco(load_fn: Callable):
        attr = f"__multiplex_{load_fn.__name__}"

        @wraps(load_fn)
        def wrapper(self, model_id: str):
            wrap = getattr(self, attr, None)
            if wrap is None:
                # atomic setdefault (GIL) — concurrent first calls agree on
                # ONE wrapper; a lock here would make the decorated class
                # unpicklable (cloudpickle captures referenced globals by
                # value).  Losing candidates are discarded before any model
                # load happens, so single-flight loading is preserved.
                candidate = _MultiplexWrapper(load_fn,
                                              max_num_models_per_replica)
                wrap = self.__dict__.setdefault(attr, candidate)
            set_multiplexed_model_id(model_id)
            return wrap.load(self, model_id)

        wrapper.__multiplexed__ = True
        return wrapper

    return deco
