"""Dataset: lazy, distributed, streaming-executed collections of blocks.

reference: python/ray/data/dataset.py — Dataset :166, map_batches :455;
plan execution _internal/plan.py:413,451; streaming executor
_internal/execution/streaming_executor.py:57.

The JAX package's block functions run on Arrow tables (``pyarrow.compute``,
Acero joins); the port's run the same operations on numpy blocks
(``ray_tpu_torch.data.block``) and give the same rows as Python values:
one row per group with the key first,
joins with the right side's clashing names suffixed ``_r`` and null keys
unmatched, sorts stable with NaN and nulls last in both directions.
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

from ray_tpu_torch.data._internal.plan import (
    AllToAll,
    ExecutionPlan,
    InputData,
    LogicalOp,
    MapBlocks,
    Read,
)
from ray_tpu_torch.data.context import DataContext


def _connector(name: str):
    raise NotImplementedError(
        f"{name}: the warehouse, lake, Avro, audio and video connectors "
        f"(data/connectors.py, data/_internal/avro.py) are not ported yet "
        f"(ROADMAP A16, data/ connectors)")


class ActorPoolStrategy:
    """reference: data ActorPoolStrategy (compute arg of map_batches)."""

    def __init__(self, size: Optional[int] = None, min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        self.size = size
        self.min_size = min_size or size or 2
        self.max_size = max_size or size or self.min_size


# -- block-transform builders (top-level so tasks pickle by reference) ------

def _map_batches_block(fn, batch_format, batch_size, zero_copy, block):
    from ray_tpu_torch.data.block import batch_to_block, block_to_batch, concat_blocks, num_rows, slice_block, to_block

    t = to_block(block)
    n = num_rows(t)
    if batch_size is None or n <= batch_size:
        batches = [t] if n else []
    else:
        batches = [slice_block(t, s, min(s + batch_size, n))
                   for s in range(0, n, batch_size)]
    outs = []
    for b in batches:
        out = fn(block_to_batch(b, batch_format))
        outs.append(batch_to_block(out))
    return concat_blocks(outs) if outs else t


def _map_rows_block(fn, block):
    from ray_tpu_torch.data.block import empty_like, iter_block_rows, rows_to_block

    rows = [fn(r) for r in iter_block_rows(block)]
    return rows_to_block(rows) if rows else empty_like(block)


def _flat_map_block(fn, block):
    from ray_tpu_torch.data.block import empty_like, iter_block_rows, rows_to_block

    rows = [out for r in iter_block_rows(block) for out in fn(r)]
    return rows_to_block(rows) if rows else empty_like(block)


def _filter_block(fn, block):
    from ray_tpu_torch.data.block import empty_like, iter_block_rows, rows_to_block

    rows = [r for r in iter_block_rows(block) if fn(r)]
    return rows_to_block(rows) if rows else empty_like(block)


def _add_column_block(name, fn, block):
    """``fn`` gets the block's numpy batch (the reference hands a pandas
    DataFrame; a column expression such as ``b["x"] * 2`` reads the same
    on both) and returns the new column."""
    from ray_tpu_torch.data.block import as_column, to_block

    t = dict(to_block(block))
    col = fn(dict(t))
    t[name] = as_column(col if isinstance(col, (list, tuple))
                        else np.asarray(col))
    return t


def _drop_columns_block(cols, block):
    from ray_tpu_torch.data.block import to_block

    t = to_block(block)
    return {c: v for c, v in t.items() if c not in cols}


def _select_columns_block(cols, block):
    from ray_tpu_torch.data.block import to_block

    t = to_block(block)
    return {c: t[c] for c in cols}


_FILTER_OPS = ("<=", ">=", "==", "!=", "<", ">")


def _parse_filter_expr(expr: str) -> tuple:
    """``"col <op> literal"`` -> (col, op, value); literals are ints,
    floats, or quoted strings."""
    for op in _FILTER_OPS:
        if op in expr:
            col, _, lit = expr.partition(op)
            col, lit = col.strip(), lit.strip()
            if not col or not lit:
                break
            if lit[0] in "'\"" and lit[-1] == lit[0]:
                val: Any = lit[1:-1]
            else:
                try:
                    val = int(lit)
                except ValueError:
                    try:
                        val = float(lit)
                    except ValueError:
                        raise ValueError(
                            f"unsupported literal in filter expr: {expr!r}"
                        ) from None
            return (col, op, val)
    raise ValueError(
        f"filter expr must be 'column <op> literal' with op in "
        f"{_FILTER_OPS}: {expr!r}")


def _predicate_block(pred, block):
    """Exact row filter for a (col, op, val) predicate (the block-level
    fallback when the source can't absorb the pushdown).  A null never
    passes, as under Arrow's comparison kernels."""
    import operator

    from ray_tpu_torch.data.block import take, to_block

    col, op, val = pred
    t = to_block(block)
    c = t[col]
    fn = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
          "<=": operator.le, ">": operator.gt, ">=": operator.ge}[op]
    if c.dtype == object:
        keep = np.array([v is not None and bool(fn(v, val)) for v in c],
                        dtype=bool)
    else:
        keep = np.asarray(fn(c, val), dtype=bool)
    return take(t, np.nonzero(keep)[0])


# -- all-to-all implementations --------------------------------------------

# -- distributed all-to-all kernels (reference: _internal/planner hash
# shuffle / sort / repartition — map tasks partition each block, reduce
# tasks own one output partition; NOTHING materializes on the driver) ------

def _block_num_rows(block) -> int:
    from ray_tpu_torch.data.block import num_rows, to_block

    return num_rows(to_block(block))


def _gather_slices(slices, *blocks):
    """One output block from [(block_idx, start, end), ...] over inputs."""
    from ray_tpu_torch.data.block import concat_blocks, empty_like, slice_block

    tables = [slice_block(blocks[i], s, e) for i, s, e in slices]
    return (concat_blocks(tables) if tables
            else empty_like(concat_blocks(list(blocks))))


def _repartition_refs(num_blocks: int, refs: List[Any]) -> List[Any]:
    """Equal-row repartition without driver materialization: count rows per
    block (tiny tasks), compute global ranges, then one gather task per
    OUTPUT block reading only the input slices it needs."""
    import ray_tpu_torch
    from ray_tpu_torch.data.block import even_split_ranges

    refs = list(refs)
    if not refs:
        return refs
    count = ray_tpu_torch.remote(_block_num_rows)
    counts = ray_tpu_torch.get([count.remote(r) for r in refs])
    offsets = [0]
    for c in counts:
        offsets.append(offsets[-1] + c)
    total = offsets[-1]
    gather = ray_tpu_torch.remote(_gather_slices)
    if total == 0:
        return [gather.remote([], refs[0]) for _ in range(num_blocks)]
    out = []
    for g_start, g_end in even_split_ranges(total, num_blocks):
        specs, needed = [], []
        for i, c in enumerate(counts):
            b_start, b_end = offsets[i], offsets[i + 1]
            lo, hi = max(g_start, b_start), min(g_end, b_end)
            if lo < hi:
                specs.append((len(needed), lo - b_start, hi - b_start))
                needed.append(refs[i])
        # an empty range still yields a (schema-preserving) empty block so
        # repartition(n) returns exactly n blocks — zip/per-worker splits
        # depend on the shape
        out.append(gather.remote(specs, *needed) if specs
                   else gather.remote([], refs[0]))
    return out


def _random_split_block(seed: Optional[int], block_idx: int, num_parts: int, block):
    """Map side of the distributed shuffle: assign each row a random output
    partition (seeded per input block for determinism)."""
    from ray_tpu_torch.data.block import num_rows, take, to_block

    t = to_block(block)
    rng = np.random.default_rng(None if seed is None else seed * 1_000_003 + block_idx)
    assign = rng.integers(0, num_parts, num_rows(t))
    parts = tuple(take(t, np.nonzero(assign == p)[0])
                  for p in range(num_parts))
    return parts if num_parts > 1 else parts[0]


def _merge_shuffle_parts(seed: Optional[int], part_idx: int, *parts):
    """Reduce side: concat this partition's pieces + a local permutation."""
    from ray_tpu_torch.data.block import concat_blocks, num_rows, take

    merged = concat_blocks(list(parts))
    if num_rows(merged) == 0:
        return merged
    rng = np.random.default_rng(None if seed is None else seed * 7_000_003 + part_idx)
    return take(merged, rng.permutation(num_rows(merged)))


def _shuffle_refs(seed: Optional[int], refs: List[Any]) -> List[Any]:
    import ray_tpu_torch

    refs = list(refs)
    num_parts = max(1, len(refs))
    if num_parts == 1:
        merge = ray_tpu_torch.remote(_merge_shuffle_parts)
        return [merge.remote(seed, 0, *refs)] if refs else refs
    split = ray_tpu_torch.remote(_random_split_block)
    parts: List[List[Any]] = [[] for _ in range(num_parts)]
    for i, ref in enumerate(refs):
        outs = split.options(num_returns=num_parts).remote(seed, i, num_parts, ref)
        for p, r in enumerate(outs):
            parts[p].append(r)
    merge = ray_tpu_torch.remote(_merge_shuffle_parts)
    return [merge.remote(seed, p, *parts[p]) for p in range(num_parts)]


_AGG_COLUMN_NAMES = {
    "count": lambda col: f"count({col})" if col else "count()",
    "sum": lambda col: f"sum({col})",
    "mean": lambda col: f"mean({col})",
    "min": lambda col: f"min({col})",
    "max": lambda col: f"max({col})",
    "stddev": lambda col: f"std({col})",
}


def _stddev(vals, ddof):
    if len(vals) <= ddof:
        return None
    return float(np.std(np.asarray(vals, dtype=np.float64), ddof=ddof))


def _variance(vals, ddof):
    if len(vals) <= ddof:
        return None
    return float(np.var(np.asarray(vals, dtype=np.float64), ddof=ddof))


def _product(vals):
    out = 1
    for v in vals:
        out *= v
    return out


# Arrow's hash aggregates on one group's values: nulls are skipped (``valid``
# holds the rest) except by "list"; a group with no valid value gives a
# null where Arrow's does
_AGGREGATES = {
    "count": lambda valid, _all: len(valid),
    "count_distinct": lambda valid, _all: len(set(valid)),
    "sum": lambda valid, _all: sum(valid) if valid else None,
    "product": lambda valid, _all: _product(valid) if valid else None,
    "mean": lambda valid, _all: sum(valid) / len(valid) if valid else None,
    "min": lambda valid, _all: min(valid) if valid else None,
    "max": lambda valid, _all: max(valid) if valid else None,
    "stddev": lambda valid, _all: _stddev(valid, 0),
    "variance": lambda valid, _all: _variance(valid, 0),
    "first": lambda valid, _all: valid[0] if valid else None,
    "last": lambda valid, _all: valid[-1] if valid else None,
    "any": lambda valid, _all: any(valid) if valid else None,
    "all": lambda valid, _all: all(valid) if valid else None,
    "list": lambda _valid, every: list(every),
}


def _group_index(values: List[Any]):
    """(group keys in order of first appearance, each row's group id);
    null keys form one group, as Arrow's grouper makes them."""
    index: Dict[Any, int] = {}
    keys: List[Any] = []
    ids = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values):
        g = index.get(v)
        if g is None:
            g = index[v] = len(keys)
            keys.append(v)
        ids[i] = g
    return keys, ids


def _groupby_agg_refs(key: str, aggs: List[tuple], refs: List[Any]) -> List[Any]:
    """Grouped aggregation (reference: grouped_data.py), as the JAX
    package's Arrow ``group_by(key).aggregate(aggs)`` gives it: one row per
    group, the key column first.  The groups come in order of first
    appearance (Arrow's order is its grouper's and unspecified).

    aggs: [(column, arrow_agg_name)] -> output columns named like the
    reference's "sum(col)" convention.
    """
    import ray_tpu_torch
    from ray_tpu_torch.data.block import column_from_values, concat_blocks

    merged = concat_blocks(ray_tpu_torch.get(list(refs)))
    keys, ids = _group_index(merged[key].tolist())
    order = np.argsort(ids, kind="stable")
    bounds = np.searchsorted(ids[order], np.arange(len(keys) + 1))
    out = {key: column_from_values(keys)}
    for col, agg in aggs:
        fn = _AGGREGATES.get(agg)
        if fn is None:
            raise ValueError(f"unsupported aggregate {agg!r} (one of "
                             f"{sorted(_AGGREGATES)})")
        values = merged[col].tolist()
        results = []
        for g in range(len(keys)):
            every = [values[i] for i in order[bounds[g]:bounds[g + 1]]]
            results.append(fn([v for v in every if v is not None], every))
        arrow_name = f"{col}_{agg}" if col else f"{agg}"
        name = _AGG_COLUMN_NAMES.get(agg, lambda c: arrow_name)(col)
        out[name] = column_from_values(results)
    return [ray_tpu_torch.put(out)]


def _map_groups_block(fn, key, block):
    from ray_tpu_torch.data.block import (
        concat_blocks,
        empty_like,
        iter_block_rows,
        num_rows,
        rows_to_block,
        slice_block,
        to_block,
    )

    t = to_block(block)
    if num_rows(t) == 0:
        return t
    t = _sort_block(t, key, False)
    keys = t[key].tolist()
    outs = []
    start = 0
    for i in range(1, len(keys) + 1):
        if i == len(keys) or keys[i] != keys[start]:
            group = slice_block(t, start, i)
            result = fn(list(iter_block_rows(group)))
            if isinstance(result, dict):
                result = [result]
            if isinstance(result, list):
                result = rows_to_block(result)
            outs.append(to_block(result))
            start = i
    return concat_blocks(outs) if outs else empty_like(t)


def _hash_partition_refs(key: str, num_partitions: int, refs: List[Any]) -> List[Any]:
    """Partition rows by hash(key) so every occurrence of a key lands in one
    block — the shuffle half of a distributed groupby."""
    import ray_tpu_torch
    from ray_tpu_torch.data.block import concat_blocks

    from ray_tpu_torch.data.block import empty_like, num_rows, take

    merged = concat_blocks(ray_tpu_torch.get(list(refs)))
    if num_rows(merged) == 0:
        return [ray_tpu_torch.put(merged)]
    keys = merged[key].tolist()
    assignment = np.array([hash(k) % num_partitions for k in keys])
    out = []
    for part in range(num_partitions):
        idx = np.nonzero(assignment == part)[0]
        if len(idx):
            out.append(ray_tpu_torch.put(take(merged, idx)))
    return out or [ray_tpu_torch.put(empty_like(merged))]


class GroupedData:
    """reference: data/grouped_data.py — Dataset.groupby(key) handle."""

    def __init__(self, ds: "Dataset", key: str):
        self._ds = ds
        self._key = key

    def _agg(self, aggs: List[tuple]) -> "Dataset":
        return Dataset(self._ds._plan.with_op(
            AllToAll(name="GroupByAgg",
                     fn=functools.partial(_groupby_agg_refs, self._key, aggs))),
            self._ds._ctx)

    def count(self) -> "Dataset":
        return self._agg([(self._key, "count")])

    def sum(self, on: str) -> "Dataset":
        return self._agg([(on, "sum")])

    def mean(self, on: str) -> "Dataset":
        return self._agg([(on, "mean")])

    def min(self, on: str) -> "Dataset":
        return self._agg([(on, "min")])

    def max(self, on: str) -> "Dataset":
        return self._agg([(on, "max")])

    def std(self, on: str) -> "Dataset":
        return self._agg([(on, "stddev")])

    def aggregate(self, *aggs: tuple) -> "Dataset":
        """aggs: (column, arrow_aggregate_name) pairs, e.g. ("v", "sum")."""
        return self._agg(list(aggs))

    def map_groups(self, fn: Callable[[List[Dict]], Any],
                   *, num_partitions: int = 8) -> "Dataset":
        """Apply ``fn(rows_of_one_group) -> rows`` per group, in parallel
        over hash partitions (reference: map_groups)."""
        ds = Dataset(self._ds._plan.with_op(
            AllToAll(name="HashPartition",
                     fn=functools.partial(_hash_partition_refs, self._key,
                                          num_partitions))),
            self._ds._ctx)
        return Dataset(ds._plan.with_op(
            MapBlocks(name="MapGroups",
                      fn=functools.partial(_map_groups_block, fn, self._key))),
            ds._ctx)


def _stable_hash(v) -> int:
    """Process-independent value hash: builtin hash() is salt-randomized
    per worker, which would route the same key to different partitions on
    different workers and silently drop join matches."""
    import zlib

    return zlib.crc32(repr(v).encode())


def _hash_split_block(key: str, n: int, block) -> tuple:
    """Split one block into n sub-blocks by key hash (runs as a task)."""
    from ray_tpu_torch.data.block import empty_like, take, to_block

    block = to_block(block)
    col = block[key].tolist()
    buckets = [[] for _ in range(n)]
    for i, v in enumerate(col):
        buckets[_stable_hash(v) % n].append(i)
    return tuple(take(block, idx) if idx else empty_like(block)
                 for idx in buckets)


def _taken(col: np.ndarray, idx: List[Optional[int]]) -> np.ndarray:
    """``col``'s rows at ``idx``; a None index is a null row."""
    from ray_tpu_torch.data.block import object_column

    if all(i is not None for i in idx):
        return col[np.asarray(idx, dtype=np.int64)]
    vals = col.tolist() if col.ndim == 1 else list(col)
    return object_column(vals[i] if i is not None else None for i in idx)


def _hash_join(left, right, on: str, right_on: str, how: str):
    """One partition pair joined as the JAX package's Arrow (Acero) join
    lays it out: the left columns (the key coalesced from both sides; for
    a right join the left's other columns come first), then the right's
    non-key columns, a name the left has suffixed ``_r``; a right join
    names the key as the right side does.  Null keys never
    match.  Rows: each left row's matches in right order, then (left and
    outer) unmatched left rows, then (right and outer) unmatched right
    rows; Acero's own order is unspecified."""
    lk, rk = left[on].tolist(), right[right_on].tolist()
    index: Dict[Any, List[int]] = {}
    for j, v in enumerate(rk):
        if v is not None:
            index.setdefault(v, []).append(j)
    li: List[Optional[int]] = []
    ri: List[Optional[int]] = []
    matched_right = set()
    unmatched_left = []
    for i, v in enumerate(lk):
        js = index.get(v) if v is not None else None
        if js:
            li.extend([i] * len(js))
            ri.extend(js)
            matched_right.update(js)
        else:
            unmatched_left.append(i)
    if how in ("left", "outer"):
        li.extend(unmatched_left)
        ri.extend([None] * len(unmatched_left))
    if how in ("right", "outer"):
        rest = [j for j in range(len(rk)) if j not in matched_right]
        li.extend([None] * len(rest))
        ri.extend(rest)
    if any(i is None for i in li):  # coalesced from the right side
        from ray_tpu_torch.data.block import column_from_values

        key = column_from_values(
            lk[i] if i is not None else rk[j] for i, j in zip(li, ri))
    else:
        key = _taken(left[on], li)
    if how != "right":
        out = {c: (key if c == on else _taken(left[c], li)) for c in left}
    else:  # the key takes the right side's name, after the left's columns
        out = {c: _taken(left[c], li) for c in left if c != on}
        out[right_on] = key
    for c in right:
        if c == right_on:
            continue
        out[f"{c}_r" if c in left else c] = _taken(right[c], ri)
    return out


def _join_partition(on: str, right_on: str, how: str, left_refs, right_refs):
    """Hash join of one aligned partition pair (runs as a task; nested refs
    are fetched here, off the driver)."""
    import ray_tpu_torch
    from ray_tpu_torch.data.block import concat_blocks

    left = concat_blocks(ray_tpu_torch.get(list(left_refs)))
    right = concat_blocks(ray_tpu_torch.get(list(right_refs)))
    return _hash_join(left, right, on, right_on, how)


def _join_refs(on: str, right_on: str, how: str, num_partitions: int,
               right_refs: List[Any], refs: List[Any]) -> List[Any]:
    """Distributed hash join (reference: _internal/planner join.py):
    hash-partition both sides by key with one task per block, then one
    Acero join task per partition."""
    import ray_tpu_torch

    split = ray_tpu_torch.remote(_hash_split_block)
    join = ray_tpu_torch.remote(_join_partition)

    def partition(side_refs, key):
        if num_partitions == 1:
            return [list(side_refs)]  # no split needed (and num_returns=1
            # would wrap the 1-tuple as a single object)
        parts = [[] for _ in range(num_partitions)]
        for ref in side_refs:
            out = split.options(num_returns=num_partitions).remote(
                key, num_partitions, ref)
            for p, r in enumerate(out):
                parts[p].append(r)
        return parts

    left_parts = partition(list(refs), on)
    right_parts = partition(list(right_refs), right_on)
    return [join.remote(on, right_on, how, left_parts[p], right_parts[p])
            for p in range(num_partitions)]


def _zip_partition(left_block, right_refs, right_counts, offset: int):
    """Zip one left block against its aligned right row-range; fetches only
    the overlapping right blocks (runs as a task).  Blocks may be any
    supported format (dict/rows, or Table/DataFrame where installed);
    output is a numpy block."""
    import ray_tpu_torch
    from ray_tpu_torch.data.block import concat_blocks, num_rows, slice_block, to_block

    left = to_block(left_block)
    cnt = num_rows(left)
    pieces, pos = [], 0
    for ref, n in zip(right_refs, right_counts):
        start, end = pos, pos + n
        pos = end
        if end <= offset or start >= offset + cnt:
            continue
        pieces.append(slice_block(ray_tpu_torch.get(ref), max(0, offset - start),
                                  min(n, offset + cnt - start)))
    if pieces:
        right = concat_blocks(pieces)
    elif right_refs:
        # empty left block: still emit the right columns (zero rows) so
        # every output block shares one schema.  (Costs one right-block
        # fetch — rare, and schema lives only in the data itself.)
        right = slice_block(ray_tpu_torch.get(right_refs[0]), 0, 0)
    else:
        right = None
    out = dict(left)
    for name in (list(right) if right is not None else []):
        col_name = f"{name}_1" if name in out else name
        out[col_name] = right[name]
    return out


def _zip_refs(right_refs: List[Any], refs: List[Any]) -> List[Any]:
    """Row-aligned column concatenation, one task per left block — neither
    side is ever fully materialized in one process (reference: dataset.zip's
    per-partition alignment)."""
    import ray_tpu_torch

    nrows = ray_tpu_torch.remote(_block_num_rows)
    left_counts = ray_tpu_torch.get([nrows.remote(r) for r in refs])
    right_counts = ray_tpu_torch.get([nrows.remote(r) for r in right_refs])
    if sum(left_counts) != sum(right_counts):
        raise ValueError(
            f"zip() needs equal row counts, got {sum(left_counts)} vs "
            f"{sum(right_counts)}")
    zip_task = ray_tpu_torch.remote(_zip_partition)
    out, offset = [], 0
    for ref, cnt in zip(refs, left_counts):
        out.append(zip_task.remote(ref, list(right_refs), right_counts, offset))
        offset += cnt
    return out


def _random_sample_block(fraction: float, seed, block):
    import random as _random

    from ray_tpu_torch.data.block import num_rows, python_rows, take, to_block

    block = to_block(block)
    n = num_rows(block)
    # per-block stream: the same Random(seed) for every block would select
    # an identical index pattern in each, correlating the sample; mix in a
    # content fingerprint so blocks draw independently yet deterministically
    if seed is None:
        rng = _random.Random()
    else:
        head = python_rows(block, 4)
        rng = _random.Random(seed * 1_000_003
                             + n * 97 + _stable_hash(head))
    idx = [i for i in range(n) if rng.random() < fraction]
    return take(block, idx)


def _batches_over_blocks(block_iter, batch_size, batch_format, drop_last,
                         source: Optional[str] = None):
    """Re-batch a stream of BLOCKS into fixed-size batches.

    Batches fully contained in one block are zero-copy slices (views over
    the block's buffers — for plasma-resident blocks, views over the
    store's shared memory); only a batch straddling a block boundary
    concatenates (the "copy only at ragged batch boundaries" invariant,
    provable from the ingest byte counters).  ``source`` enables the
    accounting numpy converter for the ingest metric families."""
    from ray_tpu_torch.data.block import (
        block_to_batch,
        concat_blocks,
        num_rows,
        numpy_batch_accounted,
        slice_block,
        to_block,
    )

    def emit(tbl, copied=False):
        if source is not None and batch_format in ("numpy", "default"):
            return numpy_batch_accounted(tbl, source, copied)
        return block_to_batch(tbl, batch_format)

    pending: List[Dict[str, np.ndarray]] = []  # head may be a partial slice
    pending_rows = 0
    for block in block_iter:
        t = to_block(block)
        n = num_rows(t)
        if batch_size is None:
            if n:
                yield emit(t)
            continue
        if n:
            pending.append(t)
            pending_rows += n
        while pending_rows >= batch_size:
            head = pending[0]
            rows = num_rows(head)
            if rows > batch_size:
                yield emit(slice_block(head, 0, batch_size))
                pending[0] = slice_block(head, batch_size, rows)
            elif rows == batch_size:
                yield emit(pending.pop(0))
            else:  # batch straddles blocks: the one copying boundary
                parts, need = [], batch_size
                while need > 0:
                    h = pending[0]
                    if num_rows(h) <= need:
                        parts.append(pending.pop(0))
                        need -= num_rows(h)
                    else:
                        parts.append(slice_block(h, 0, need))
                        pending[0] = slice_block(h, need, num_rows(h))
                        need = 0
                yield emit(concat_blocks(parts), copied=True)
            pending_rows -= batch_size
    if pending_rows and not drop_last:
        yield emit(concat_blocks(pending) if len(pending) > 1
                   else pending[0], copied=len(pending) > 1)


def _batches_over_refs(ref_iter, batch_size, batch_format, drop_last,
                       source: Optional[str] = None,
                       window: Optional[int] = None):
    """Re-batch a stream of block refs into fixed-size batches (shared by
    Dataset.iter_batches and streaming-split iterators).  Refs resolve
    through the windowed zero-copy path: locally-sealed plasma blocks in
    the lookahead window resolve in ONE raylet round-trip and reconstruct
    as buffer views over the store's shared memory."""
    from ray_tpu_torch.data._internal.ingest import resolved_blocks

    yield from _batches_over_blocks(
        resolved_blocks(ref_iter, window=window or 1), batch_size,
        batch_format, drop_last, source=source)


def _torch_batches(batches, dtypes, device):
    """Numpy batches -> dicts of torch tensors.  A read-only column (a view
    over the store's memory) is copied first: ``torch.as_tensor`` on it
    would warn and alias memory the tensor may write."""
    import torch

    for batch in batches:
        out = {}
        for name, col in batch.items():
            arr = np.asarray(col)
            if not arr.flags.writeable:
                arr = arr.copy()
            t = torch.as_tensor(arr)
            want = dtypes.get(name) if dtypes else None
            if want is not None or device is not None:
                t = t.to(device=device, dtype=want)  # one copy
            out[name] = t
        yield out


class _SplitCoordinator:
    """Actor executing the plan ONCE and handing blocks to n consumers
    (reference: _internal/execution StreamSplitDataIterator coordinator).

    Per-consumer buffers are CAPPED (``DataContext.split_buffer_blocks``):
    when the round-robin target's buffer is full, the producer pull parks
    (``PARKED``) instead of buffering the whole stream against a slow
    consumer — end-to-end backpressure, the executor's own op budget
    upstream and this cap downstream bound the store bytes one split
    pipeline can hold.  ``reassign`` is the elastic re-shard hook: a
    drained consumer's remaining blocks move to the surviving consumers,
    no row lost or duplicated."""

    WAIT = "__WAIT__"
    PARKED = "__PARKED__"

    def __init__(self, ds_blob: bytes, n: int, equal: bool,
                 idle_timeout_s: float = 600.0,
                 max_buffered_blocks: Optional[int] = None):
        import threading as _threading
        import time as _time

        import cloudpickle

        self._ds = cloudpickle.loads(ds_blob)
        self._n = n
        self._equal = equal
        self._cap = (max_buffered_blocks
                     or getattr(self._ds._ctx, "split_buffer_blocks", 16))
        self._lock = _threading.Lock()
        self._epoch = 0
        # {consumer: epoch it detached in} — persists ACROSS epochs so a
        # gone consumer's round-robin share keeps flowing to survivors; a
        # replacement polling a LATER epoch reattaches itself
        self._detached: Dict[int, int] = {}
        self._start_epoch_locked()
        # self-reaping: with consumers scattered across processes no single
        # one can own the coordinator's lifetime; it exits after idling.
        # In-flight next_block calls (which can legitimately block for a
        # long time while the plan produces its first blocks) pin the
        # coordinator alive — only true idleness reaps.
        self._last_access = _time.monotonic()
        self._inflight = 0
        self._access_lock = _threading.Lock()  # inflight counter only
        self._idle_timeout_s = idle_timeout_s
        _threading.Thread(target=self._idle_reaper, daemon=True,
                          name="split-coordinator-reaper").start()

    def _idle_reaper(self):
        import os as _os
        import time as _time

        while True:
            _time.sleep(min(self._idle_timeout_s / 4, 30.0))
            if (self._inflight == 0
                    and _time.monotonic() - self._last_access
                    > self._idle_timeout_s):
                _os._exit(0)

    def _start_epoch_locked(self):
        self._iter = self._ds._plan.execute_iter(self._ds._ctx)
        self._buffers: List[List[Any]] = [[] for _ in range(self._n)]
        self._counter = 0
        self._done = False
        self._finished: set = set()  # consumers that drained this epoch
        self._returned: List[Any] = []  # equal=False give-backs

    def _next_target_locked(self) -> Optional[int]:
        """Round-robin target of the next pulled block, skipping detached
        consumers (their assignment flows to survivors)."""
        for _ in range(self._n):
            t = self._counter % self._n
            if t not in self._detached:
                return t
            self._counter += 1
        return None

    def next_block(self, i: int, epoch: int):
        """Next block ref for consumer ``i`` in its ``epoch``.  None =
        epoch exhausted; WAIT = another consumer is still on the previous
        epoch (retry shortly); PARKED = backpressure (a peer's buffer is
        at its cap — retry, the producer is deliberately paused).  A new
        epoch re-executes the plan, so splits are re-iterable across
        training epochs."""
        import time as _time

        self._last_access = _time.monotonic()
        with self._access_lock:
            self._inflight += 1
        try:
            return self._next_block(i, epoch)
        finally:
            with self._access_lock:
                self._inflight -= 1
            self._last_access = _time.monotonic()

    def _next_block(self, i: int, epoch: int):
        with self._lock:
            if epoch > self._epoch:
                if len(self._finished | set(self._detached)) < self._n:
                    return self.WAIT  # stragglers still draining
                self._epoch = epoch
                self._start_epoch_locked()
            elif epoch < self._epoch:
                return None  # stale epoch: it was fully consumed
            if i in self._detached:
                if self._detached[i] == self._epoch:
                    return None  # detached THIS epoch: its share moved on
                del self._detached[i]  # a later epoch: the rank rejoined
            while True:
                if self._buffers[i]:
                    return self._buffers[i].pop(0)
                if not self._equal and self._returned:
                    return self._returned.pop(0)
                if self._done:
                    self._finished.add(i)
                    return None
                if self._equal:
                    target = self._next_target_locked()
                    if target is None:
                        self._done = True
                        continue
                    if (target != i and target not in self._finished
                            and len(self._buffers[target]) >= self._cap):
                        # a slow peer's assignment is full: park the
                        # producer pull instead of buffering the stream.
                        # A FINISHED peer (abandoned mid-epoch) never
                        # drains its buffer, so its cap must not park the
                        # survivors — its assignment buffers as before.
                        from ray_tpu_torch._private import runtime_metrics

                        runtime_metrics.inc_ingest_backpressure("split")
                        return self.PARKED
                try:
                    ref = next(self._iter)
                except StopIteration:
                    self._done = True
                    continue
                if self._equal:
                    # fixed round-robin: every consumer sees a near-equal,
                    # disjoint block set regardless of consumption speed
                    self._buffers[target].append(ref)
                    self._counter += 1
                else:
                    return ref  # first-come-first-served

    def finish(self, i: int, epoch: int):
        """A consumer abandoned (or closed) its epoch-``epoch`` iterator:
        count it as drained so the other consumers' next epoch can start
        instead of livelocking on WAIT."""
        with self._lock:
            if epoch == self._epoch:
                self._finished.add(i)
        return True

    def reassign(self, i: int, epoch: int, unread_refs=()):
        """Elastic re-shard (preemption drain moved consumer ``i`` away):
        everything still assigned to ``i`` — its coordinator buffer plus
        any refs it pulled but never consumed — is redistributed round-
        robin over the consumers still active in this epoch, and ``i`` is
        detached (future round-robin skips it; the epoch can complete
        without it).  Returns the number of blocks moved.  Exactly-once:
        a block is either consumed by ``i`` before the drain or delivered
        to exactly one survivor, never both."""
        with self._lock:
            if epoch != self._epoch:
                return 0  # the epoch already rolled; nothing left to move
            blocks = list(self._buffers[i]) + list(unread_refs)
            self._buffers[i] = []
            self._detached[i] = self._epoch
            self._finished.add(i)
            if not blocks:
                return 0
            if not self._equal:
                self._returned.extend(blocks)
                return len(blocks)
            active = [j for j in range(self._n)
                      if j not in self._detached and j not in self._finished]
            if not active:
                # every survivor already drained this epoch: the blocks
                # are undeliverable within it (nobody will pull again).
                # A multi-epoch loop re-delivers them from the next
                # epoch's fresh plan execution; a single-epoch run has
                # lost them — say so loudly instead of silently.
                import logging as _logging

                _logging.getLogger(__name__).warning(
                    "streaming_split reassign: consumer %d drained with "
                    "%d block(s) left but every surviving consumer "
                    "already finished the epoch — these blocks are only "
                    "re-delivered if the split is iterated again",
                    i, len(blocks))
                return 0
            for k, ref in enumerate(blocks):
                self._buffers[active[k % len(active)]].append(ref)
            return len(blocks)


class StreamSplit:
    """One consumer's slice of a streaming_split (reference: DataIterator).
    Each iter_* call is one epoch; the coordinator re-executes the plan
    when every consumer finished the previous epoch."""

    def __init__(self, coordinator, index: int, ctx, _epoch: int = 0,
                 wait_timeout_s: float = 600.0):
        self._coord = coordinator
        self._index = index
        self._ctx = ctx
        self._epoch = _epoch
        self._active_epoch: Optional[int] = None
        self._wait_timeout_s = wait_timeout_s

    def _coord_call(self, method, *args):
        """One coordinator round-trip with the self-reap translated: the
        coordinator exits after ``idle_timeout_s`` without consumers, so a
        late (re)connect must fail with a nameable cause, not an opaque
        actor-death error (or a hang inside a retry loop)."""
        import ray_tpu_torch
        from ray_tpu_torch import ActorDiedError, ActorUnavailableError

        try:
            return ray_tpu_torch.get(getattr(self._coord, method).remote(*args))
        except (ActorDiedError, ActorUnavailableError) as e:
            raise RuntimeError(
                "streaming_split coordinator is gone — it self-reaps "
                "after idling (idle_timeout_s, default 600s); recreate "
                f"the splits with Dataset.streaming_split: {e}") from None

    def _ref_iter(self):
        import time as _time

        import ray_tpu_torch
        from ray_tpu_torch.data.dataset import _SplitCoordinator

        epoch = self._epoch
        self._epoch += 1
        self._active_epoch = epoch
        exhausted = False
        wait_deadline = None
        try:
            while True:
                ref = self._coord_call("next_block", self._index, epoch)
                if ref is None:
                    exhausted = True
                    return
                if ref == _SplitCoordinator.WAIT:
                    if wait_deadline is None:
                        wait_deadline = _time.monotonic() + self._wait_timeout_s
                    elif _time.monotonic() > wait_deadline:
                        raise RuntimeError(
                            "streaming_split: another consumer never "
                            "finished the previous epoch (dead consumer?)")
                    _time.sleep(0.05)
                    continue
                if ref == _SplitCoordinator.PARKED:
                    # backpressure: a peer's buffer is at its cap and the
                    # producer pull is parked — not a liveness problem
                    # unless it persists past the same deadline
                    if wait_deadline is None:
                        wait_deadline = _time.monotonic() + self._wait_timeout_s
                    elif _time.monotonic() > wait_deadline:
                        raise RuntimeError(
                            "streaming_split: backpressured for the whole "
                            "wait timeout (a peer stopped consuming "
                            "without detaching?)")
                    _time.sleep(0.02)
                    continue
                wait_deadline = None
                yield ref
        finally:
            self._active_epoch = None
            if not exhausted:
                # abandoned mid-epoch (break / error): count this consumer
                # as drained so peers' next epoch doesn't livelock
                try:
                    self._coord.finish.remote(self._index, epoch)
                except Exception:  # noqa: BLE001 — coordinator gone: epoch accounting died with it
                    pass

    def iter_blocks(self):
        """Public block-ref iterator for the ingest layer (one epoch)."""
        return self._ref_iter()

    def release(self, unread_refs=()) -> int:
        """Elastic re-shard hand-back: detach this consumer from its
        CURRENT epoch, returning ``unread_refs`` (pulled but never
        consumed) plus whatever the coordinator still holds for it to the
        surviving consumers.  Returns the number of blocks moved."""
        epoch = (self._active_epoch if self._active_epoch is not None
                 else self._epoch - 1)
        if epoch < 0:
            return 0
        return self._coord_call("reassign", self._index, epoch,
                                list(unread_refs))

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: Optional[str] = None,
                     drop_last: bool = False):
        batch_format = batch_format or self._ctx.default_batch_format
        yield from _batches_over_refs(
            self._ref_iter(), batch_size, batch_format, drop_last,
            source="split",
            window=getattr(self._ctx, "ingest_resolve_window", 4))

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           drop_last: bool = False,
                           dtypes: Optional[Dict[str, Any]] = None,
                           device: Optional[str] = None):
        """This consumer's batches as dicts of torch tensors (reference:
        DataIterator.iter_torch_batches; one epoch)."""
        yield from _torch_batches(
            self.iter_batches(batch_size=batch_size, batch_format="numpy",
                              drop_last=drop_last), dtypes, device)

    def iter_rows(self):
        import ray_tpu_torch
        from ray_tpu_torch.data.block import iter_block_rows

        for ref in self._ref_iter():
            yield from iter_block_rows(ray_tpu_torch.get(ref))

    def __reduce__(self):
        # _epoch travels: a re-serialized split must resume AT its epoch,
        # not silently restart from 0 (which next_block reads as consumed)
        return (StreamSplit, (self._coord, self._index, self._ctx,
                              self._epoch, self._wait_timeout_s))


def _skip_rows(refs: List[Any], n: int) -> List[Any]:
    """Refs covering everything AFTER the first n rows."""
    import ray_tpu_torch
    from ray_tpu_torch.data.block import num_rows, slice_block

    out, to_skip = [], n
    for ref in refs:
        if to_skip <= 0:
            out.append(ref)
            continue
        b = ray_tpu_torch.get(ref)
        if num_rows(b) <= to_skip:
            to_skip -= num_rows(b)
            continue
        out.append(ray_tpu_torch.put(slice_block(b, to_skip, num_rows(b))))
        to_skip = 0
    return out


def _sample_key(key: str, n: int, block):
    from ray_tpu_torch.data.block import num_rows, to_block

    t = to_block(block)
    rows = num_rows(t)
    if rows == 0:
        return []
    idx = np.linspace(0, rows - 1, min(n, rows)).astype(np.int64)
    # nulls never become cut points (sorts place them at the end)
    return [v for v in t[key][idx].tolist() if v is not None]


def _range_split_block(key: str, bounds: List[Any], null_part: int, block):
    """Map side of the sample sort: range-partition by the cut points
    (always >= 2 partitions). Null keys go to ``null_part`` so they land at
    the GLOBAL end after the per-partition sort (which also places
    nulls last). Comparisons run only over NON-NULL values, so any
    orderable column (ints, floats, strings) works."""
    from ray_tpu_torch.data.block import empty_like, num_rows, take, to_block

    t = to_block(block)
    num_parts = len(bounds) + 1
    rows = num_rows(t)
    if rows == 0:
        empty = empty_like(t)
        return tuple(empty for _ in range(num_parts))
    col = t[key]
    if col.dtype == object:
        # the non-null values as the numpy array Arrow's to_numpy gives
        # (ints and floats numeric, so NaN orders as numpy orders it)
        null_mask = np.array([v is None for v in col], dtype=bool)
        vals = np.asarray(col[~null_mask].tolist())
    else:
        null_mask = np.zeros(rows, dtype=bool)
        vals = col
    assign = np.full(rows, null_part, dtype=np.int64)
    if len(vals):
        assign[~null_mask] = np.searchsorted(
            np.asarray(bounds), vals, side="right")
    parts = tuple(take(t, np.nonzero(assign == p)[0])
                  for p in range(num_parts))
    return parts


def _sort_block(block, key: str, descending: bool):
    """``block`` sorted stably by ``key``, NaN and then nulls last in both
    directions (Arrow's ``sort_by`` placement)."""
    from ray_tpu_torch.data.block import num_rows, take, to_block

    t = to_block(block)
    if num_rows(t) == 0:
        return t
    col = t[key]
    if col.ndim == 1 and col.dtype != object and col.dtype.kind in "biuf":
        if not descending:
            order = np.argsort(col, kind="stable")
        elif col.dtype.kind == "f":
            order = np.argsort(-col, kind="stable")
        else:  # ~x reverses the order of ints and bools without overflow
            order = np.argsort(~col, kind="stable")
        return take(t, order)
    vals = col.tolist()
    valid, nans, nulls = [], [], []
    for i, v in enumerate(vals):
        if v is None:
            nulls.append(i)
        elif isinstance(v, float) and v != v:
            nans.append(i)
        else:
            valid.append(i)
    valid.sort(key=vals.__getitem__, reverse=descending)  # stable both ways
    return take(t, valid + nans + nulls)


def _sort_merge_parts(key: str, descending: bool, *parts):
    from ray_tpu_torch.data.block import concat_blocks

    return _sort_block(concat_blocks(list(parts)), key, descending)


def _sort_refs(key: str, descending: bool, refs: List[Any]) -> List[Any]:
    """Distributed sample sort (reference: planner sort — sample -> range
    partition -> per-partition sort; only the tiny samples touch the
    driver). Output blocks are globally ordered ascending, reversed for
    descending."""
    import ray_tpu_torch

    refs = list(refs)
    num_parts = len(refs)
    merge = ray_tpu_torch.remote(_sort_merge_parts)
    if num_parts <= 1:
        return [merge.remote(key, descending, *refs)] if refs else refs
    sample = ray_tpu_torch.remote(_sample_key)
    samples = sorted(
        v for vs in ray_tpu_torch.get([sample.remote(key, 20, r) for r in refs])
        for v in vs)
    if not samples:
        return [merge.remote(key, descending, *refs)]
    # P-1 cut points from the pooled samples
    bounds = [samples[(i + 1) * len(samples) // num_parts]
              for i in range(num_parts - 1)]
    bounds = [b for i, b in enumerate(bounds) if i == 0 or b != bounds[i - 1]]
    split = ray_tpu_torch.remote(_range_split_block)
    n_out = len(bounds) + 1  # >= 2: the dedup above always keeps bounds[0]
    # global null placement: ascending ends at the last partition; for
    # descending the output order is reversed, so nulls ride partition 0
    null_part = 0 if descending else n_out - 1
    parts: List[List[Any]] = [[] for _ in range(n_out)]
    for ref in refs:
        outs = split.options(num_returns=n_out).remote(key, bounds, null_part, ref)
        for p, r in enumerate(outs):
            parts[p].append(r)
    out = [merge.remote(key, descending, *parts[p]) for p in range(n_out)]
    return out[::-1] if descending else out


class Dataset:
    """reference: data/dataset.py:166."""

    def __init__(self, plan: ExecutionPlan, ctx: Optional[DataContext] = None):
        self._plan = plan
        self._ctx = ctx or DataContext.get_current()

    # -- transforms (lazy) --------------------------------------------------
    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_size: Optional[int] = None,
        batch_format: Optional[str] = None,
        compute: Optional[ActorPoolStrategy] = None,
        fn_constructor_args: Optional[tuple] = None,
        num_gpus: Optional[float] = None,
        num_cpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        zero_copy_batch: bool = False,
    ) -> "Dataset":
        """reference: dataset.py:455. Callable-class fn + compute=ActorPoolStrategy
        runs on an autoscaling actor pool (workers on cards via num_gpus,
        where the JAX package books TPUs through num_tpus)."""
        batch_format = batch_format or self._ctx.default_batch_format
        res: Dict[str, float] = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = num_cpus
        if num_gpus is not None:
            res["GPU"] = num_gpus
        if isinstance(fn, type) or compute is not None:
            if not isinstance(fn, type):
                raise ValueError("compute=ActorPoolStrategy requires a callable class fn")
            compute = compute or ActorPoolStrategy()
            ctor_args = fn_constructor_args or ()

            def make_callable(cls=fn, args=ctor_args, bf=batch_format, bs=batch_size):
                inst = cls(*args)
                return functools.partial(_map_batches_block, inst, bf, bs, False)

            op = MapBlocks(
                name=f"MapBatches({fn.__name__})",
                fn=None,
                compute=compute,
                fn_constructor=make_callable,
                resources=res or None,
            )
            return Dataset(self._plan.with_op(op), self._ctx)
        op = MapBlocks(
            name=f"MapBatches({getattr(fn, '__name__', 'fn')})",
            fn=functools.partial(_map_batches_block, fn, batch_format, batch_size,
                                 zero_copy_batch),
            resources=res or None,
        )
        return Dataset(self._plan.with_op(op), self._ctx)

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return Dataset(self._plan.with_op(
            MapBlocks(name="Map", fn=functools.partial(_map_rows_block, fn))), self._ctx)

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        return Dataset(self._plan.with_op(
            MapBlocks(name="FlatMap", fn=functools.partial(_flat_map_block, fn))), self._ctx)

    def filter(self, fn: Optional[Callable[[Dict], bool]] = None, *,
               expr: Optional[str] = None) -> "Dataset":
        """Row filter: a Python callable OR a simple comparison expression
        (``"col > 5"``, ``"name == 'x'"``).  Expressions are optimizer-
        visible and push into pushdown-capable sources (parquet row-group
        pruning; reference: logical/rules/ predicate pushdown) — callables
        are opaque and always run as a block transform."""
        if (fn is None) == (expr is None):
            raise ValueError("filter() takes exactly one of fn or expr")
        if expr is not None:
            pred = _parse_filter_expr(expr)
            return Dataset(self._plan.with_op(
                MapBlocks(name=f"Filter({expr})",
                          fn=functools.partial(_predicate_block, pred),
                          predicate=[pred])), self._ctx)
        return Dataset(self._plan.with_op(
            MapBlocks(name="Filter", fn=functools.partial(_filter_block, fn))), self._ctx)

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        return Dataset(self._plan.with_op(
            MapBlocks(name=f"AddColumn({name})",
                      fn=functools.partial(_add_column_block, name, fn))), self._ctx)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return Dataset(self._plan.with_op(
            MapBlocks(name="DropColumns",
                      fn=functools.partial(_drop_columns_block, cols))), self._ctx)

    def select_columns(self, cols: List[str]) -> "Dataset":
        return Dataset(self._plan.with_op(
            MapBlocks(name="SelectColumns",
                      fn=functools.partial(_select_columns_block, cols),
                      projection=list(cols))), self._ctx)

    def repartition(self, num_blocks: int) -> "Dataset":
        return Dataset(self._plan.with_op(
            AllToAll(name="Repartition",
                     fn=functools.partial(_repartition_refs, num_blocks))), self._ctx)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return Dataset(self._plan.with_op(
            AllToAll(name="RandomShuffle",
                     fn=functools.partial(_shuffle_refs, seed))), self._ctx)

    def groupby(self, key: str) -> "GroupedData":
        """reference: dataset.py groupby -> GroupedData."""
        return GroupedData(self, key)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return Dataset(self._plan.with_op(
            AllToAll(name="Sort",
                     fn=functools.partial(_sort_refs, key, descending))), self._ctx)

    def limit(self, n: int) -> "Dataset":
        def _limit(refs):
            import ray_tpu_torch
            from ray_tpu_torch.data.block import num_rows, slice_block

            out, remaining = [], n
            for ref in refs:
                if remaining <= 0:
                    break
                b = ray_tpu_torch.get(ref)
                if num_rows(b) <= remaining:
                    out.append(ref)
                    remaining -= num_rows(b)
                else:
                    out.append(ray_tpu_torch.put(slice_block(b, 0, remaining)))
                    remaining = 0
            return out

        return Dataset(self._plan.with_op(AllToAll(name="Limit", fn=_limit)), self._ctx)

    def join(self, other: "Dataset", on: str, *, right_on: Optional[str] = None,
             how: str = "inner", num_partitions: int = 8) -> "Dataset":
        """Distributed hash join (reference: dataset join via
        _internal/planner join.py; how in inner/left/right/outer)."""
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"unsupported join type {how!r}")
        right_refs = other._materialize_refs()
        return Dataset(self._plan.with_op(
            AllToAll(name="Join",
                     fn=functools.partial(_join_refs, on, right_on or on,
                                          how, num_partitions, right_refs))),
            self._ctx)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two equal-length datasets (reference:
        dataset.zip; clashing column names get a _1 suffix)."""
        right_refs = other._materialize_refs()
        return Dataset(self._plan.with_op(
            AllToAll(name="Zip",
                     fn=functools.partial(_zip_refs, right_refs))), self._ctx)

    def random_sample(self, fraction: float,
                      *, seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (reference: dataset.random_sample)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        return Dataset(self._plan.with_op(
            MapBlocks(name="RandomSample",
                      fn=functools.partial(_random_sample_block, fraction,
                                           seed))), self._ctx)

    def unique(self, column: str) -> List[Any]:
        """Distinct values of one column (reference: dataset.unique), in
        order of first appearance."""
        seen = []
        seen_set = set()
        import ray_tpu_torch

        for ref in self._plan.execute_iter(self._ctx):
            for v in ray_tpu_torch.get(ref)[column].tolist():
                if v not in seen_set:
                    seen_set.add(v)
                    seen.append(v)
        return seen

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None):
        """(train, test) datasets (reference: dataset.train_test_split)."""
        if not 0.0 < test_size < 1.0:
            raise ValueError("test_size must be in (0, 1)")
        import ray_tpu_torch

        ds = self.random_shuffle(seed=seed) if shuffle else self
        refs = ds._materialize_refs()  # execute the plan ONCE
        from ray_tpu_torch.data.block import num_rows

        rows = sum(num_rows(ray_tpu_torch.get(r)) for r in refs)
        n_test = int(rows * test_size)
        train = Dataset(ExecutionPlan([InputData(name="Train", refs=refs)]),
                        self._ctx).limit(rows - n_test)
        # test = the tail: skip the first rows - n_test rows
        test_refs = _skip_rows(refs, rows - n_test)
        test = Dataset(ExecutionPlan([InputData(name="Test", refs=test_refs)]),
                       self._ctx)
        return train, test

    def union(self, *others: "Dataset") -> "Dataset":
        refs = self._materialize_refs()
        for o in others:
            refs.extend(o._materialize_refs())
        return Dataset(ExecutionPlan([InputData(name="Union", refs=refs)]), self._ctx)

    # -- split (for Train integration; reference: dataset.py split/streaming_split)
    def split(self, n: int, *, equal: bool = True) -> List["Dataset"]:
        from ray_tpu_torch.data.block import even_split_ranges

        refs = self.repartition(n)._materialize_refs()
        return [
            Dataset(ExecutionPlan([InputData(name="Split", refs=refs[s:e])]), self._ctx)
            for s, e in even_split_ranges(len(refs), n)
        ]

    def streaming_split(self, n: int, *, equal: bool = True,
                        idle_timeout_s: float = 600.0) -> List[StreamSplit]:
        """n coordinated iterators over ONE execution of this dataset
        (reference: dataset.streaming_split for per-worker Train ingest).
        equal=True assigns blocks round-robin (near-equal, disjoint);
        equal=False hands blocks out first-come-first-served.  Per-consumer
        coordinator buffers are capped (DataContext.split_buffer_blocks)
        so a slow consumer parks the producer instead of buffering the
        stream; a consumer drained away mid-epoch hands its remaining
        blocks to survivors via ``StreamSplit.release`` (elastic
        re-shard)."""
        import cloudpickle

        import ray_tpu_torch

        # the coordinator self-reaps after idling (consumers are scattered
        # across processes, so no single one can own its lifetime)
        coordinator = ray_tpu_torch.remote(_SplitCoordinator).options(
            num_cpus=0.1, max_concurrency=max(n + 1, 2)).remote(
            cloudpickle.dumps(self), n, equal, idle_timeout_s)
        return [StreamSplit(coordinator, i, self._ctx) for i in range(n)]

    # -- execution ----------------------------------------------------------
    def _materialize_refs(self) -> List[Any]:
        return list(self._plan.execute_iter(self._ctx))

    def materialize(self) -> "Dataset":
        """Execute the plan, pin blocks (reference: dataset.materialize)."""
        refs = self._materialize_refs()
        return Dataset(ExecutionPlan([InputData(name="Materialized", refs=refs)]), self._ctx)

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: Optional[str] = None,
        drop_last: bool = False,
        prefetch_batches: int = 1,
    ) -> Iterator[Any]:
        """Stream batches as blocks complete (reference: iterator over
        execute_to_iterator, plan.py:413). ``prefetch_batches`` runs batch
        preparation on a background thread so it overlaps the caller's
        consumption (0 disables).  Blocks resolve through the windowed
        zero-copy path (locally-sealed plasma blocks in one raylet
        round-trip); numpy batches of fixed-dtype columns are READ-ONLY
        views over the store's shared memory — ``arr.copy()`` before
        mutating in place."""
        batch_format = batch_format or self._ctx.default_batch_format
        gen = _batches_over_refs(
            self._plan.execute_iter(self._ctx), batch_size, batch_format,
            drop_last, source="iter",
            window=getattr(self._ctx, "ingest_resolve_window", 4))
        if prefetch_batches and prefetch_batches > 0:
            from ray_tpu_torch.data._internal.ingest import HostPrefetcher

            gen = iter(HostPrefetcher(gen, depth=prefetch_batches,
                                      source="iter", stage="host"))
        yield from gen

    def iter_device_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        drop_last: bool = False,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Optional[Any] = None,
        prefetch_batches: int = 2,
        partial_batch: str = "error",
    ) -> Iterator[Dict[str, Any]]:
        """Stream batches as dicts of tensors on the card — the counterpart
        of the JAX package's ``iter_jax_batches``, with a device-side
        double buffer: the prefetch thread copies the next batch into a
        pinned staging ring and issues its host-to-device copy on a side
        stream while the caller steps; the caller's stream waits on the
        copy's event when the batch is handed over (no
        ``torch.cuda.synchronize``, the host never waits on the step).

        dtypes:   optional {column: torch dtype} casts (on the device,
                  after the copy)
        device:   a torch.device or name (default: the current CUDA
                  device; ``"cpu"`` gives host tensors; raises without a
                  GPU).  Where ``iter_jax_batches`` takes a sharding, a
                  port Mesh is refused: each trainer rank already gets its
                  own shard
        prefetch_batches: device-resident buffer depth (2 = classic double
                  buffering; 0 = synchronous copies, no overlap)
        partial_batch: what to do with a final batch that doesn't fill
                  ``batch_size``: "error" (hand it over at its own
                  shape), "drop", or "pad" (zero-pad to ``batch_size`` and
                  add a float32 ``mask`` column)
        """
        from ray_tpu_torch.data._internal.ingest import (
            DevicePrefetcher,
            DeviceStager,
            resolve_device,
            staged_batches,
        )

        target = resolve_device(device)

        def _gen():  # lazy: nothing executes before the first next()
            host = self.iter_batches(batch_size=batch_size,
                                     batch_format="numpy",
                                     drop_last=drop_last,
                                     prefetch_batches=0)
            if prefetch_batches and prefetch_batches > 0:
                yield from DevicePrefetcher(
                    host, target, dtypes=dtypes, depth=prefetch_batches,
                    batch_size=batch_size, partial_batch=partial_batch,
                    source="iter")
            else:
                stager = DeviceStager(target, dtypes=dtypes, depth=0)
                yield from staged_batches(host, stager, batch_size,
                                          partial_batch, hand_over=True)

        return _gen()

    def iter_torch_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        drop_last: bool = False,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Optional[str] = None,
        prefetch_batches: int = 1,
    ) -> Iterator[Dict[str, Any]]:
        """Stream batches as dicts of torch tensors (reference:
        dataset.iter_torch_batches; host tensors, as the JAX package's;
        the double-buffered device path is iter_device_batches).

        dtypes: optional {column: torch dtype}; device: torch device string.
        """

        def _gen():
            yield from _torch_batches(
                self.iter_batches(batch_size=batch_size,
                                  batch_format="numpy", drop_last=drop_last,
                                  prefetch_batches=0), dtypes, device)

        if prefetch_batches and prefetch_batches > 0:
            from ray_tpu_torch.data._internal.ingest import HostPrefetcher

            def lazy():
                yield from HostPrefetcher(_gen(), depth=prefetch_batches,
                                          source="torch", stage="host")
            return lazy()
        return _gen()

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        import ray_tpu_torch
        from ray_tpu_torch.data.block import iter_block_rows

        for ref in self._plan.execute_iter(self._ctx):
            yield from iter_block_rows(ray_tpu_torch.get(ref))

    def take(self, limit: int = 20) -> List[Dict[str, Any]]:
        return list(itertools.islice(self.iter_rows(), limit))

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        import ray_tpu_torch
        from ray_tpu_torch.data.block import num_rows

        return sum(num_rows(ray_tpu_torch.get(ref))
                   for ref in self._plan.execute_iter(self._ctx))

    def schema(self):
        """The first block's ``block.Schema`` (names and numpy dtypes)."""
        import ray_tpu_torch
        from ray_tpu_torch.data.block import schema_of

        for ref in self._plan.execute_iter(self._ctx):
            return schema_of(ray_tpu_torch.get(ref))
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def num_blocks(self) -> int:
        return len(self._materialize_refs())

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The whole dataset as one numpy block."""
        import ray_tpu_torch
        from ray_tpu_torch.data.block import concat_blocks

        return concat_blocks(ray_tpu_torch.get(self._materialize_refs()))

    def to_pandas(self):
        from ray_tpu_torch.data.block import to_pandas

        return to_pandas(self.to_numpy())

    def to_arrow(self):
        from ray_tpu_torch.data.block import to_arrow

        return to_arrow(self.to_numpy())

    # -- aggregates (nulls skipped; None where nothing is left) -------------
    def sum(self, on: str):
        return self._agg("sum", on)

    def min(self, on: str):
        return self._agg("min", on)

    def max(self, on: str):
        return self._agg("max", on)

    def mean(self, on: str):
        return self._agg("mean", on)

    def std(self, on: str):
        return _stddev(self._valid(on), 1)

    def _valid(self, on: str) -> list:
        t = self.to_numpy()
        return [v for v in t[on].tolist() if v is not None] if t else []

    def _agg(self, op: str, on: str):
        return _AGGREGATES[op](self._valid(on), None)

    # -- writes -------------------------------------------------------------
    def write_parquet(self, path: str) -> List[str]:
        return self._write(path, "parquet")

    def write_csv(self, path: str) -> List[str]:
        return self._write(path, "csv")

    def write_json(self, path: str) -> List[str]:
        return self._write(path, "json")

    def write_avro(self, path: str) -> List[str]:
        """reference: data avro support (not ported: connectors)."""
        _connector("write_avro")

    def write_tfrecords(self, path: str) -> List[str]:
        """reference: tfrecords_datasink.py (not ported: connectors)."""
        _connector("write_tfrecords")

    def write_webdataset(self, path: str) -> List[str]:
        """reference: webdataset_datasink.py (not ported: connectors)."""
        _connector("write_webdataset")

    def _write(self, path: str, fmt: str) -> List[str]:
        import os

        import ray_tpu_torch
        from ray_tpu_torch.data import datasource as ds

        if "://" not in path:
            os.makedirs(path, exist_ok=True)
        writer = {"parquet": ds.write_block_parquet, "csv": ds.write_block_csv,
                  "json": ds.write_block_json}[fmt]
        out = []
        for i, ref in enumerate(self._plan.execute_iter(self._ctx)):
            out.append(writer(ray_tpu_torch.get(ref), path, i))
        return out

    def write_sql(self, table: str, connection_factory) -> str:
        """reference: sql_datasink.py (not ported: connectors)."""
        _connector("write_sql")

    def write_mongo(self, client_factory, database: str, collection: str) -> str:
        """reference: mongo_datasink.py (not ported: connectors)."""
        _connector("write_mongo")

    def write_bigquery(self, project: str, dataset: str, *, transport=None) -> str:
        """reference: bigquery_datasink.py (not ported: connectors)."""
        _connector("write_bigquery")

    def write_clickhouse(self, dsn: str, table: str, *, transport=None) -> str:
        """reference: clickhouse_datasink.py (not ported: connectors)."""
        _connector("write_clickhouse")

    def write_delta(self, table_path: str, *, mode: str = "append") -> int:
        """Delta Lake commit (not ported: connectors)."""
        _connector("write_delta")

    def write_iceberg(self, table_path: str) -> int:
        """Iceberg append snapshot (not ported: connectors)."""
        _connector("write_iceberg")

    def write_lance(self, uri: str) -> str:
        """reference: lance_datasink.py (not ported: connectors)."""
        _connector("write_lance")

    def __repr__(self):
        names = [op.name for op in self._plan.ops]
        return f"Dataset(plan={' -> '.join(names)})"

    def stats(self) -> str:
        """Human-readable execution stats of the MOST RECENT execution of
        this process (reference: dataset.stats() — per-operator wall/tasks;
        here the streaming executor's operator counters)."""
        from ray_tpu_torch.data._internal import streaming_executor as se

        lines = [repr(self)]
        ex = se.LAST_EXECUTOR
        if ex is None:
            return lines[0] + "\n(no execution yet)"
        for name, st in ex.stats().items():
            parts = [f"tasks={st['tasks_submitted']}",
                     f"peak_in_flight={st['peak_outstanding']}",
                     f"peak_queued_bytes={st['peak_downstream_bytes']}"]
            if "peak_pool_size" in st:
                parts.append(f"peak_pool={st['peak_pool_size']}")
                parts.append(f"scale_downs={st.get('scale_down_events', 0)}")
            lines.append(f"  {name}: " + ", ".join(parts))
        return "\n".join(lines)


