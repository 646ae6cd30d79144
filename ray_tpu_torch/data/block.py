"""Blocks: the unit of data exchanged between operators.

reference: python/ray/data/_internal/arrow_block.py / pandas_block.py —
operators exchange ObjectRefs to blocks, never the data itself (RefBundle
pattern, execution/interfaces/).

The JAX package's blocks are Arrow tables.  The port's are a dict of numpy
columns, so the data layer runs where neither pyarrow nor pandas is
installed (the card's machine has neither):

  - a column is a numpy array whose first axis is the row.  A numeric
    column is 1-D; a fixed-shape tensor column (``from_numpy`` of a [n, s]
    array) keeps its trailing axes, so a batch of token rows is one
    contiguous array (the store hands it back as a read-only view over
    its shared memory, no copy);
  - ragged, string, bytes, list and dict columns are 1-D object arrays of
    Python values; a null is ``None`` in an object column (a numeric
    column that holds a null becomes an object column);
  - a row is ``{name: value}`` with Python scalars for 1-D numeric
    columns, the row's numpy sub-array for a tensor column, the object
    itself for an object column.

``batch_format="pyarrow"``/``"pandas"`` convert on request and raise
``ImportError`` naming the package where it is absent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class Schema:
    """Column names and numpy dtypes (``object`` for Python-valued ones);
    a tensor column's dtype reads ``float32[2048]`` (its row shape)."""

    names: tuple
    types: tuple

    def __repr__(self):
        return "Schema(" + ", ".join(
            f"{n}: {t}" for n, t in zip(self.names, self.types)) + ")"


@dataclasses.dataclass
class BlockMetadata:
    """reference: data/block.py BlockMetadata (num_rows, size_bytes, schema)."""

    num_rows: int
    size_bytes: int
    schema: Optional[Schema] = None


# -- columns ---------------------------------------------------------------

def object_column(values) -> np.ndarray:
    """A 1-D object array holding ``values`` as they are (equal-length
    lists stay lists: ``np.array`` would stack them into a 2-D array)."""
    values = list(values)
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def column_from_values(values) -> np.ndarray:
    """A column from a sequence of Python values, typed as Arrow infers a
    list: all bools -> bool, all ints -> int64, ints and floats -> float64,
    equal-shaped numpy arrays of one dtype -> a tensor column, anything
    else (strings, bytes, lists, dicts, mixed kinds, any ``None``) -> an
    object column."""
    values = list(values)
    kinds = set()
    for v in values:
        if v is None:
            return object_column(values)
        if isinstance(v, (bool, np.bool_)):
            kinds.add("b")
        elif isinstance(v, (int, np.integer)):
            kinds.add("i")
        elif isinstance(v, (float, np.floating)):
            kinds.add("f")
        elif isinstance(v, np.ndarray) and v.ndim > 0:
            kinds.add("a")
        else:
            return object_column(values)
    if kinds == {"b"}:
        return np.array(values, dtype=bool)
    if kinds == {"i"}:
        try:
            return np.array(values, dtype=np.int64)
        except OverflowError:
            return object_column(values)
    if kinds <= {"i", "f"} and kinds:
        return np.array(values, dtype=np.float64)
    if kinds == {"a"}:
        first = values[0]
        if all(v.shape == first.shape and v.dtype == first.dtype
               for v in values):
            return np.stack(values)
    return object_column(values)


def as_column(value) -> np.ndarray:
    """A column from whatever a batch dict holds: a numpy array (kept,
    rows on its first axis), a torch tensor (its host copy), or a
    sequence of values (typed by :func:`column_from_values`)."""
    if isinstance(value, np.ndarray):
        if value.ndim == 0:
            raise ValueError("a column needs one entry per row; got a 0-d "
                             "array")
        return value
    if hasattr(value, "detach") and hasattr(value, "numpy"):  # a torch tensor
        return value.detach().cpu().numpy()
    if isinstance(value, (list, tuple)):
        return column_from_values(value)
    return column_from_values(list(value))


def _is_arrow(x) -> bool:
    return type(x).__module__.split(".")[0] == "pyarrow"


def _is_pandas(x) -> bool:
    return type(x).__module__.split(".")[0] == "pandas"


def _from_arrow(table) -> Block:
    out: Block = {}
    for name, col in zip(table.column_names, table.columns):
        try:
            if col.null_count:
                raise ValueError("nulls")
            arr = col.to_numpy()
            if arr.dtype == object:
                raise ValueError("not a fixed-width column")
            out[name] = arr
        except Exception:  # noqa: BLE001 — strings, lists, nulls: Python values
            out[name] = column_from_values(col.to_pylist())
    return out


def _from_pandas(df) -> Block:
    out: Block = {}
    for name in df.columns:
        arr = df[name].to_numpy()
        out[str(name)] = (column_from_values(arr.tolist())
                          if arr.dtype == object else arr)
    return out


def to_block(block: Any) -> Block:
    """The canonical block of ``block``: a dict of columns, a list of row
    dicts, or (where those packages are installed) an Arrow table or a
    pandas DataFrame."""
    if isinstance(block, dict):
        cols = {str(k): as_column(v) for k, v in block.items()}
        lens = {len(v) for v in cols.values()}
        if len(lens) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lens)}")
        return cols
    if isinstance(block, list):  # list of row dicts
        return rows_to_block(block)
    if _is_arrow(block) and hasattr(block, "column_names"):
        return _from_arrow(block)
    if _is_pandas(block) and hasattr(block, "columns"):
        return _from_pandas(block)
    raise TypeError(f"cannot convert {type(block)} to a block")


def rows_to_block(rows: List[Dict[str, Any]]) -> Block:
    """Rows to columns; the columns are the first row's keys (a later
    row's extra keys are dropped, a missing key is a null), as Arrow's
    ``Table.from_pylist`` does."""
    if not rows:
        return {}
    names = list(rows[0].keys())
    return {str(n): column_from_values([r.get(n) for r in rows])
            for n in names}


# -- shape -----------------------------------------------------------------

def num_rows(block: Block) -> int:
    for col in block.values():
        return len(col)
    return 0


def size_bytes(block: Block) -> int:
    """Bytes the block's columns hold: numpy buffers, plus the payload of
    str/bytes values in object columns."""
    total = 0
    for col in block.values():
        total += col.nbytes
        if col.dtype == object:
            total += sum(len(v) for v in col if isinstance(v, (str, bytes)))
    return total


def _type_name(col: np.ndarray) -> str:
    if col.ndim > 1:
        return f"{col.dtype}{list(col.shape[1:])}"
    return str(col.dtype)


def schema_of(block: Block) -> Schema:
    return Schema(tuple(block), tuple(_type_name(c) for c in block.values()))


def block_metadata(block: Block) -> BlockMetadata:
    b = to_block(block)
    return BlockMetadata(num_rows=num_rows(b), size_bytes=size_bytes(b),
                         schema=schema_of(b))


# -- conversions -----------------------------------------------------------

def _require(package: str):
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(
            f"batch_format needs {package!r}, which is not installed; the "
            f"port's blocks are numpy columns (batch_format='numpy' or "
            f"'pydict' need no other package)") from e


def column_values(col: np.ndarray) -> list:
    """A column as Python values (nested lists for a tensor column)."""
    return col.tolist()


def to_arrow(block: Block):
    """An Arrow table of ``block`` (needs pyarrow)."""
    pa = _require("pyarrow")
    b = to_block(block)
    return pa.table({name: (pa.array(col) if col.ndim == 1 and col.dtype != object
                            else pa.array(column_values(col)))
                     for name, col in b.items()})


def to_pandas(block: Block):
    """A pandas DataFrame of ``block`` (needs pandas)."""
    pd = _require("pandas")
    b = to_block(block)
    return pd.DataFrame({name: (col if col.ndim == 1 else list(col))
                         for name, col in b.items()})


def block_to_batch(block: Block, batch_format: str):
    """Materialize a block in the user-requested format
    (reference: iter_batches batch_format semantics)."""
    b = to_block(block)
    if batch_format in ("numpy", "default"):
        return dict(b)
    if batch_format == "pydict":  # plain python lists (ragged-friendly)
        return {name: column_values(col) for name, col in b.items()}
    if batch_format in ("pyarrow", "arrow"):
        return to_arrow(b)
    if batch_format == "pandas":
        return to_pandas(b)
    raise ValueError(f"unknown batch_format {batch_format!r}")


def batch_to_block(batch: Any) -> Block:
    return to_block(batch)


def numpy_batch_accounted(block: Block, source: str,
                          copied: bool = False) -> Dict[str, np.ndarray]:
    """The numpy batch of ``block``, booked into the
    ``ray_tpu_data_ingest_bytes_total{kind=view|copy}`` family: a batch
    cut from one block is a view over that block's buffers (for a block
    in the store, over its shared memory: no pickle round trip, no host
    memcpy); ``copied`` marks a batch concatenated across a block
    boundary, the one place a batch costs a copy."""
    from ray_tpu_torch._private import runtime_metrics

    b = to_block(block)
    nbytes = sum(col.nbytes for col in b.values())
    runtime_metrics.add_ingest_bytes(source, "view", 0 if copied else nbytes)
    runtime_metrics.add_ingest_bytes(source, "copy", nbytes if copied else 0)
    runtime_metrics.add_ingest_rows(source, num_rows(b))
    return dict(b)


def iter_block_rows(block: Block) -> Iterator[Dict[str, Any]]:
    b = to_block(block)
    names = list(b)
    cols = [col.tolist() if col.ndim == 1 else list(col)
            for col in b.values()]
    for values in zip(*cols):
        yield dict(zip(names, values))


def python_rows(block: Block, limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Rows as plain Python values (tensor rows as nested lists): what
    Arrow's ``to_pylist`` gives, for hashing and comparisons."""
    b = to_block(block)
    n = num_rows(b) if limit is None else min(limit, num_rows(b))
    cols = {name: col[:n].tolist() for name, col in b.items()}
    return [{name: cols[name][i] for name in cols} for i in range(n)]


def take(block: Block, indices) -> Block:
    idx = np.asarray(indices, dtype=np.int64)
    return {name: col[idx] for name, col in to_block(block).items()}


def slice_block(block: Block, start: int, end: int) -> Block:
    return {name: col[start:end] for name, col in to_block(block).items()}


def empty_like(block: Block) -> Block:
    return slice_block(block, 0, 0)


def even_split_ranges(total: int, n: int) -> List[tuple]:
    """[(start, end)] splitting ``total`` rows into ``n`` near-equal pieces."""
    n = max(1, n)
    size, rem = divmod(total, n)
    out, start = [], 0
    for i in range(n):
        end = start + size + (1 if i < rem else 0)
        out.append((start, end))
        start = end
    return out


def _concat_column(pieces: List[np.ndarray]) -> np.ndarray:
    if len(pieces) == 1:
        return pieces[0]
    if any(p.dtype == object for p in pieces) or len(
            {p.shape[1:] for p in pieces}) > 1:
        return object_column(
            v for p in pieces
            for v in (p.tolist() if p.ndim == 1 else list(p)))
    return np.concatenate(pieces)


def concat_blocks(blocks: List[Block]) -> Block:
    """One block of ``blocks`` in order.  Columns are the union in order of
    first appearance; a block missing a column contributes nulls (Arrow's
    ``promote_options="default"``).  All-empty inputs keep the first
    block's columns (joins and aggregations on an empty partition still
    need them)."""
    tables = [b for b in map(to_block, blocks) if num_rows(b) > 0]
    if not tables:
        return empty_like(to_block(blocks[0])) if blocks else {}
    if len(tables) == 1:
        return tables[0]
    names: List[str] = []
    for t in tables:
        names.extend(n for n in t if n not in names)
    out: Block = {}
    for name in names:
        pieces = [t[name] if name in t
                  else object_column([None] * num_rows(t)) for t in tables]
        out[name] = _concat_column(pieces)
    return out
