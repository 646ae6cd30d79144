"""@ray_tpu_torch.remote functions.

reference: python/ray/remote_function.py:41 (RemoteFunction, _remote :314).
Options mirror the reference's: num_returns, num_cpus, num_tpus, resources,
max_retries, retry_exceptions, scheduling_strategy, runtime_env.
``num_tpus`` is first-class (the reference's ``num_gpus`` analog) and
validated against ICI-aligned chip blocks by the TPU accelerator manager.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private.accelerators import get_accelerator_manager
from ray_tpu_torch._private.scheduler import SchedulingStrategy


def _normalize_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        resources["CPU"] = float(opts["num_cpus"])
    elif "CPU" not in resources:
        resources["CPU"] = 1.0
    if opts.get("num_tpus") is not None:
        mgr = get_accelerator_manager("TPU")
        ok, err = mgr.validate_resource_request_quantity(opts["num_tpus"])
        if not ok:
            raise ValueError(err)
        resources["TPU"] = float(opts["num_tpus"])
    if opts.get("num_gpus") is not None:
        resources["GPU"] = float(opts["num_gpus"])
    if opts.get("memory") is not None:
        resources["memory"] = float(opts["memory"])
    if opts.get("accelerator_type"):
        resources[f"accelerator_type:{opts['accelerator_type']}"] = 0.001
    return resources


def _normalize_strategy(opts: Dict[str, Any]) -> SchedulingStrategy:
    strategy = opts.get("scheduling_strategy")
    if strategy is None or strategy == "DEFAULT":
        return SchedulingStrategy()
    if strategy == "SPREAD":
        return SchedulingStrategy(kind="spread")
    if isinstance(strategy, SchedulingStrategy):
        return strategy
    # Strategy objects from ray_tpu_torch.util.scheduling_strategies
    return strategy.to_internal()


class RemoteFunction:
    def __init__(self, fn, **options):
        self._fn = fn
        self._options = options
        functools.update_wrapper(self, fn)

    def options(self, **new_options) -> "RemoteFunction":
        merged = {**self._options, **new_options}
        return RemoteFunction(self._fn, **merged)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.worker import get_global_worker

        w = get_global_worker()
        opts = self._options
        return w.submit_task(
            self._fn,
            args,
            kwargs,
            name=opts.get("name") or self._fn.__name__,
            num_returns=opts.get("num_returns", 1),
            resources=_normalize_resources(opts),
            strategy=_normalize_strategy(opts),
            max_retries=opts.get("max_retries"),
            retry_exceptions=opts.get("retry_exceptions", False),
            runtime_env=opts.get("runtime_env"),
        )

    def bind(self, *args, **kwargs):
        """Bind into a lazy DAG (reference: python/ray/dag FunctionNode)."""
        raise NotImplementedError(
            "lazy DAGs (dag/) are not ported yet: ROADMAP A16")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__!r} cannot be called directly; "
            f"use {self._fn.__name__}.remote()."
        )
