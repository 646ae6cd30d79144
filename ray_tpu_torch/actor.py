"""Actor API: @ray_tpu_torch.remote classes, handles, options.

reference: python/ray/actor.py (ActorClass, options incl. max_restarts /
max_task_retries :385-432, max_concurrency, lifetime="detached", name,
num_gpus→num_tpus).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch.remote_function import _normalize_resources, _normalize_strategy


class ActorExitException(Exception):
    """Raised by exit_actor(); the in-flight call's reply carries it (so the
    caller's get() raises it), then the process exits."""


def exit_actor():
    """Terminate the current actor from inside one of its methods
    (reference: ray.actor.exit_actor).  The executor SENDS the in-flight
    call's reply (carrying ActorExitException) first, then marks the actor
    intentionally dead at the GCS and exits — no reply race, and the actor
    is NOT restarted (intentional exits don't count against max_restarts)."""
    from ray_tpu_torch._private.worker import get_global_worker

    w = get_global_worker()
    if w is None or w.actor_id is None:
        raise RuntimeError("exit_actor() called outside an actor method")
    raise ActorExitException(0)


def method(*, concurrency_group: Optional[str] = None):
    """Method decorator declaring per-method actor options (reference:
    python/ray/actor.py @ray.method). ``concurrency_group`` names one of the
    groups declared in ``@ray_tpu_torch.remote(concurrency_groups={...})``; the
    executor dispatches the method to that group's thread pool. (num_returns
    stays a per-call option — ``actor.f.options(num_returns=n)`` — because
    handles resolved by name don't carry class metadata.)"""

    def wrap(fn):
        if concurrency_group is not None:
            fn._ray_tpu_concurrency_group = concurrency_group
        return fn

    return wrap


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = 1
        self._concurrency_group: Optional[str] = None

    def options(self, num_returns: int = 1, concurrency_group: Optional[str] = None):
        m = ActorMethod(self._handle, self._method_name)
        m._num_returns = num_returns
        m._concurrency_group = concurrency_group
        return m

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.worker import get_global_worker

        w = get_global_worker()
        return w.submit_actor_task(
            self._handle._actor_id,
            self._method_name,
            args,
            kwargs,
            num_returns=self._num_returns,
            max_task_retries=self._handle._max_task_retries,
            concurrency_group=self._concurrency_group,
        )

    def bind(self, *args, **kwargs):
        """Bind into a lazy DAG (reference: python/ray/dag — actor-method
        .bind builds a ClassMethodNode instead of submitting)."""
        raise NotImplementedError(
            "lazy DAGs (dag/) are not ported yet: ROADMAP A16")


class ActorHandle:
    def __init__(self, actor_id: ActorID, max_task_retries: int = 0):
        self._actor_id = actor_id
        self._max_task_retries = max_task_retries

    def __getattr__(self, name):
        # Dunders must miss (pickle/copy probe them); single-underscore names
        # are legitimate actor methods (e.g. train's RayTrainWorker._execute).
        if name.startswith("__"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._max_task_retries))

    @property
    def actor_id(self):
        return self._actor_id


class ActorClass:
    def __init__(self, cls, **options):
        self._cls = cls
        self._options = options

    def options(self, **new_options) -> "ActorClass":
        return ActorClass(self._cls, **{**self._options, **new_options})

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch._private.worker import get_global_worker

        w = get_global_worker()
        opts = self._options
        actor_id, _spec = w.create_actor(
            self._cls,
            args,
            kwargs,
            name=opts.get("name"),
            resources=_normalize_resources(opts),
            strategy=_normalize_strategy(opts),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            concurrency_groups=opts.get("concurrency_groups"),
            lifetime=opts.get("lifetime"),
            namespace=opts.get("namespace", "default"),
            runtime_env=opts.get("runtime_env"),
        )
        return ActorHandle(actor_id, max_task_retries=opts.get("max_task_retries", 0))

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )
