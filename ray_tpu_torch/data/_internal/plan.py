"""Logical plan + streaming execution.

reference: python/ray/data/_internal/logical/operators/ (logical ops),
_internal/plan.py (ExecutionPlan — execute_to_iterator :413, execute :451),
_internal/execution/streaming_executor.py:57 (StreamingExecutor — loop
run :311, select_operator_to_run :443 backpressure-aware).

Design: operators form a chain; execution streams ObjectRefs to blocks
through the chain with a bounded number of in-flight tasks per operator
(backpressure), yielding output refs as soon as they complete. Map-family
stages fuse (reference: planner fusion) so one task runs read→map→map.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Logical operators
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LogicalOp:
    name: str


@dataclasses.dataclass
class InputData(LogicalOp):
    """Leaf: pre-materialized block refs."""

    refs: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Read(LogicalOp):
    """Leaf: read tasks from a datasource (reference: logical/operators/read_operator.py).

    `datasource`/`parallelism` let the optimizer RE-plan tasks with pushed
    columns/predicates (reference: logical/rules/); `read_tasks` is the
    materialized plan actually executed."""

    read_tasks: List[Callable] = dataclasses.field(default_factory=list)
    datasource: Optional[Any] = None
    parallelism: int = 0
    columns: Optional[List[str]] = None
    predicate: Optional[List[tuple]] = None


@dataclasses.dataclass
class MapBlocks(LogicalOp):
    """block -> block transform (map_batches/map/filter/flat_map lower here)."""

    fn: Callable = None
    # actor-pool compute (reference: ActorPoolMapOperator actor_pool_map_operator.py:45)
    compute: Optional[Any] = None
    fn_constructor: Optional[Callable] = None
    resources: Optional[Dict[str, float]] = None
    # optimizer metadata (reference: logical/rules/ projection / predicate
    # pushdown): a SelectColumns op carries `projection`; a filter(expr=)
    # op carries `predicate` [(col, op, val)] — opaque fns carry neither
    projection: Optional[List[str]] = None
    predicate: Optional[List[tuple]] = None


@dataclasses.dataclass
class AllToAll(LogicalOp):
    """Materializing barrier op: repartition/shuffle/sort (reference:
    hash_shuffle.py; these need every input block)."""

    fn: Callable = None  # List[ref] -> List[ref]


# ---------------------------------------------------------------------------
# Execution plan (remote execution lives in streaming_executor.py)
# ---------------------------------------------------------------------------

class ExecutionPlan:
    def __init__(self, ops: List[LogicalOp]):
        self.ops = ops

    def with_op(self, op: LogicalOp) -> "ExecutionPlan":
        return ExecutionPlan(self.ops + [op])

    # -- streaming execution ------------------------------------------------
    def execute_iter(self, ctx) -> Iterator[Any]:
        """Yield output block refs as they become available.

        Execution is delegated to the backpressured StreamingExecutor
        (streaming_executor.py — reference: streaming_executor.py:57);
        stages produced by _fuse map 1:1 onto physical operators.
        """
        from ray_tpu_torch.data._internal.streaming_executor import execute_streaming

        return execute_streaming(self._fuse(ctx), ctx)

    def execute(self, ctx) -> List[Any]:
        return list(self.execute_iter(ctx))

    # -- optimizer (reference: _internal/logical/rules/) --------------------
    def optimized_ops(self) -> List[LogicalOp]:
        """Projection + predicate pushdown into pushdown-capable reads.

        Rules applied to fixpoint on Read-adjacent ops:
          - a MapBlocks carrying `predicate` folds into the Read (and
            disappears: the parquet filter is exact, not just row-group
            pruning)
          - a MapBlocks carrying `projection` narrows Read.columns (and
            disappears)
        Opaque fns stop the scan — the optimizer can't see through them.
        """
        ops = list(self.ops)
        changed = True
        while changed:
            changed = False
            for i, op in enumerate(ops):
                if not isinstance(op, Read) or op.datasource is None:
                    continue
                supported = tuple(getattr(op.datasource, "supports_pushdown",
                                          tuple)())
                if i + 1 >= len(ops) or not supported:
                    continue
                nxt = ops[i + 1]
                if not isinstance(nxt, MapBlocks):
                    continue
                if nxt.predicate and "predicate" in supported:
                    if op.columns is not None and any(
                            p[0] not in op.columns for p in nxt.predicate):
                        # a predicate on a column the Read no longer emits:
                        # the unoptimized block path raises KeyError there,
                        # so folding (where pyarrow would happily filter on
                        # a non-projected column) would change observable
                        # semantics — keep the op unfused
                        continue
                    new = dataclasses.replace(
                        op, predicate=(op.predicate or []) + list(nxt.predicate))
                elif nxt.projection and "columns" in supported:
                    cols = (nxt.projection if op.columns is None
                            else [c for c in op.columns
                                  if c in nxt.projection])
                    new = dataclasses.replace(op, columns=cols)
                else:
                    continue
                new.read_tasks = new.datasource.get_read_tasks(
                    new.parallelism, columns=new.columns,
                    predicate=new.predicate)
                ops[i:i + 2] = [new]
                changed = True
                break
        return ops

    # -- fusion -------------------------------------------------------------
    def _fuse(self, ctx) -> List[Tuple[str, Any]]:
        """Group the op chain into executable stages, fusing consecutive
        task-based MapBlocks (and a leading Read) into single tasks."""
        stages: List[Tuple[str, Any]] = []
        pending_fns: List[Callable] = []
        pending_sources: Optional[List[Callable]] = None  # read thunks

        def flush():
            nonlocal pending_fns, pending_sources
            if pending_sources is not None:
                fns = list(pending_fns)
                srcs = list(pending_sources)
                stages.append(("tasks", ("source", fns, srcs)))
            elif pending_fns:
                fns = list(pending_fns)
                stages.append(("tasks", ("map", fns, None)))
            pending_fns, pending_sources = [], None

        for op in self.optimized_ops():
            if isinstance(op, InputData):
                flush()
                stages.append(("input", op.refs))
            elif isinstance(op, Read):
                flush()
                pending_sources = list(op.read_tasks)
            elif isinstance(op, MapBlocks):
                if op.compute is not None:
                    # actor stage: carry any pending plain fns into it
                    fns_before = list(pending_fns)
                    srcs = pending_sources
                    pending_fns, pending_sources = [], None
                    if srcs is not None:
                        stages.append(("tasks", ("source", fns_before, srcs)))
                        fns_before = []
                    stages.append(("actor_pool", (op, fns_before)))
                else:
                    pending_fns.append(op.fn)
            elif isinstance(op, AllToAll):
                flush()
                stages.append(("barrier", op.fn))
            else:
                raise TypeError(f"unknown op {op}")
        flush()
        return stages
