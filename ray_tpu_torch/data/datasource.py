"""Datasources: pluggable readers producing read tasks.

reference: python/ray/data/datasource/ + _internal/datasource/ (~40 sources);
the core contract is Datasource.get_read_tasks(parallelism) -> [callable
returning a block] (reference: datasource/datasource.py).

Paths may be local, globs, directories, or any fsspec URI (gs://, s3://,
http://, ...) — the reference reaches cloud storage through pyarrow/fsspec
filesystems the same way (datasource/path_util.py).

Every reader returns a numpy block (``ray_tpu_torch.data.block``).  Text,
binary, numpy, images (PIL), SQL, TFRecord and WebDataset readers need no
Arrow; the parquet, ORC, CSV and JSON readers and writers import pyarrow
inside the call, so nothing here touches it at import.
"""

from __future__ import annotations

import functools
import glob as glob_mod
import os
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block


class Datasource:
    def get_read_tasks(self, parallelism: int) -> List[Callable[[], Block]]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None


def _is_remote(path: str) -> bool:
    return "://" in path and not path.startswith("file://")


def _open(path: str, mode: str = "rb"):
    """Open a local path or any fsspec URI (gs://, s3://, http://, ...)."""
    if _is_remote(path):
        import fsspec

        return fsspec.open(path, mode).open()
    return open(path, mode)


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if _is_remote(p):
            import fsspec

            fs, _ = fsspec.core.url_to_fs(p)
            proto = p.split("://", 1)[0]
            if any(c in p for c in "*?["):
                out.extend(sorted(f"{proto}://{m}" for m in fs.glob(p)))
            elif fs.isdir(p):
                out.extend(sorted(
                    f"{proto}://{f}" for f in fs.find(p)
                    if not f.rsplit("/", 1)[-1].startswith(".")))
            else:
                out.append(p)
        elif os.path.isdir(p):
            out.extend(sorted(
                os.path.join(dp, f) for dp, _, fs in os.walk(p) for f in fs
                if not f.startswith(".")
            ))
        elif any(c in p for c in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return out


def _chunk(items: List[Any], n: int) -> List[List[Any]]:
    n = max(1, min(n, len(items)))
    size, rem = divmod(len(items), n)
    chunks, start = [], 0
    for i in range(n):
        end = start + size + (1 if i < rem else 0)
        chunks.append(items[start:end])
        start = end
    return [c for c in chunks if c]


class RangeDatasource(Datasource):
    """reference: read_api.py range()."""

    def __init__(self, n: int, column: str = "id"):
        self.n = n
        self.column = column

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        from ray_tpu_torch.data.block import even_split_ranges

        n = self.n
        parallelism = max(1, min(parallelism, n)) if n else 1
        tasks = [functools.partial(_read_range, s, e, self.column)
                 for s, e in even_split_ranges(n, parallelism) if e > s]
        return tasks or [functools.partial(_read_range, 0, 0, self.column)]


def _read_range(start: int, end: int, column: str) -> Block:
    return {column: np.arange(start, end, dtype=np.int64)}


class ItemsDatasource(Datasource):
    """reference: from_items (read_api.py)."""

    def __init__(self, items: List[Any]):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        return [functools.partial(_items_to_block, chunk)
                for chunk in _chunk(self.items, parallelism)] or \
            [functools.partial(_items_to_block, [])]


def _items_to_block(items: List[Any]) -> Block:
    from ray_tpu_torch.data.block import column_from_values, rows_to_block

    if items and isinstance(items[0], dict):
        return rows_to_block(items)
    return {"item": column_from_values(items)}


class FileDatasource(Datasource):
    """One read task per file group.

    ``pushdown``: which optimizer rewrites this reader honors — parquet
    supports both columns and predicate (reference: logical/rules/)."""

    def __init__(self, paths, reader: Callable[[str], Block],
                 pushdown: tuple = ()):
        self.files = _expand_paths(paths)
        self.reader = reader
        self.pushdown = tuple(pushdown)

    def supports_pushdown(self) -> tuple:
        return self.pushdown

    def get_read_tasks(self, parallelism: int, *, columns=None,
                       predicate=None) -> List[Callable]:
        return [functools.partial(_read_files, chunk, self.reader,
                                  columns, predicate)
                for chunk in _chunk(self.files, parallelism)]


def _read_files(files: List[str], reader, columns=None,
                predicate=None) -> Block:
    from ray_tpu_torch.data.block import concat_blocks

    kw = {}
    if columns is not None:
        kw["columns"] = columns
    if predicate is not None:
        kw["predicate"] = predicate
    return concat_blocks([reader(f, **kw) for f in files])


def _arrow_block(table) -> Block:
    from ray_tpu_torch.data.block import to_block

    return to_block(table)


def read_parquet_file(path: str, columns=None, predicate=None) -> Block:
    """Parquet read with optimizer pushdown: `columns` prunes at the column
    chunks, `predicate` [(col, op, val), ...] prunes row groups by stats and
    filters rows (reference: logical/rules/ projection+predicate pushdown;
    executed here by pyarrow's read_table columns=/filters=)."""
    import pyarrow.parquet as pq

    kw = {}
    if columns is not None:
        kw["columns"] = list(columns)
    if predicate:
        kw["filters"] = [tuple(p) for p in predicate]
    if _is_remote(path):
        with _open(path) as f:
            return _arrow_block(pq.read_table(f, **kw))
    return _arrow_block(pq.read_table(path, **kw))


def read_csv_file(path: str) -> Block:
    import pyarrow.csv as pacsv

    if _is_remote(path):
        with _open(path) as f:
            return _arrow_block(pacsv.read_csv(f))
    # path string keeps pyarrow's extension-based compression inference
    return _arrow_block(pacsv.read_csv(path))


def read_json_file(path: str) -> Block:
    import pyarrow.json as pajson

    if _is_remote(path):
        with _open(path) as f:
            return _arrow_block(pajson.read_json(f))
    return _arrow_block(pajson.read_json(path))


def read_text_file(path: str) -> Block:
    from ray_tpu_torch.data.block import object_column

    with _open(path, "rb") as f:
        lines = [ln.decode("utf-8", "replace").rstrip("\n")
                 for ln in f.read().splitlines()]
    return {"text": object_column(lines)}


def read_binary_file(path: str) -> Block:
    from ray_tpu_torch.data.block import object_column

    with _open(path, "rb") as f:
        data = f.read()
    return {"path": object_column([path]), "bytes": object_column([data])}


def read_numpy_file(path: str) -> Block:
    """.npy -> one "data" column of rows; .npz -> one column per array
    (reference: datasource/numpy_datasource.py).  A 2-D or wider array is
    a tensor column: its rows stay one contiguous array."""
    with _open(path, "rb") as f:
        loaded = np.load(f, allow_pickle=False)
        if hasattr(loaded, "files"):  # npz archive
            return {name: np.asarray(loaded[name]) for name in loaded.files}
        arr = np.asarray(loaded)
    return {"data": arr}


def read_orc_file(path: str) -> Block:
    from pyarrow import orc

    with _open(path, "rb") as f:
        return _arrow_block(orc.ORCFile(f).read())


def read_image_file(path: str) -> Block:
    """One row per image: raw HWC uint8 bytes + shape + path (reference:
    datasource/image_datasource.py; kept as bytes+shape instead of nested
    lists so blocks stay compact and zero-copy restorable)."""
    from PIL import Image

    with _open(path, "rb") as f:
        img = np.asarray(Image.open(f).convert("RGB"), np.uint8)
    from ray_tpu_torch.data.block import object_column

    return {
        "path": object_column([path]),
        "image": object_column([img.tobytes()]),
        "height": np.array([img.shape[0]], np.int64),
        "width": np.array([img.shape[1]], np.int64),
        "channels": np.array([img.shape[2]], np.int64),
    }


def read_tfrecords_file(path: str) -> Block:
    """TFRecord framing without tensorflow: each record is
    [len u64][len_crc u32][data][data_crc u32]; rows carry the raw bytes
    (reference: read_tfrecords — feature parsing is the consumer's job
    here, the tf.train.Example proto dependency stays out)."""
    import struct as _struct

    records = []
    with _open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                break
            (length,) = _struct.unpack("<Q", header[:8])
            data = f.read(length)
            f.read(4)  # data crc
            if len(data) < length:
                break
            records.append(data)
    from ray_tpu_torch.data.block import object_column

    return {"bytes": object_column(records)}


def read_webdataset_file(path: str) -> Block:
    """One tar shard -> rows grouped by sample key (reference:
    datasource/webdataset_datasource.py): members `key.ext` become columns
    `ext` of binary payloads."""
    import tarfile

    samples: Dict[str, Dict[str, bytes]] = {}
    order: List[str] = []
    with _open(path, "rb") as f:
        with tarfile.open(fileobj=f) as tar:
            for member in tar:
                if not member.isfile():
                    continue
                dirname, _, base = member.name.rpartition("/")
                stem, _, ext = base.partition(".")
                # webdataset convention: the key keeps the directory prefix
                # (train/0001 and val/0001 are DIFFERENT samples)
                key = f"{dirname}/{stem}" if dirname else stem
                if key not in samples:
                    samples[key] = {}
                    order.append(key)
                samples[key][ext or "bin"] = tar.extractfile(member).read()
    cols: Dict[str, list] = {"__key__": order}
    exts = sorted({e for s in samples.values() for e in s})
    for e in exts:
        cols[e] = [samples[k].get(e) for k in order]
    from ray_tpu_torch.data.block import object_column

    return {k: object_column(v) for k, v in cols.items()}


class SQLDatasource(Datasource):
    """reference: datasource/sql_datasource.py — a connection FACTORY (the
    connection itself can't travel to workers) + a query; one read task
    (relational engines parallelize server-side)."""

    def __init__(self, sql: str, connection_factory: Callable[[], Any]):
        self.sql = sql
        self.connection_factory = connection_factory

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        return [functools.partial(_read_sql, self.sql, self.connection_factory)]


def _read_sql(sql: str, connection_factory) -> Block:
    conn = connection_factory()
    try:
        cur = conn.cursor()
        cur.execute(sql)
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    from ray_tpu_torch.data.block import column_from_values

    return {n: column_from_values([r[i] for r in rows])
            for i, n in enumerate(names)}


# -- writers (reference: data write_parquet/csv/json) -----------------------

def _out_path(path: str, name: str) -> str:
    if _is_remote(path):
        return path.rstrip("/") + "/" + name
    os.makedirs(path, exist_ok=True)
    return os.path.join(path, name)


def write_block_parquet(block: Block, path: str, index: int) -> str:
    import pyarrow.parquet as pq

    from ray_tpu_torch.data.block import to_arrow

    block = to_arrow(block)

    out = _out_path(path, f"part-{index:05d}.parquet")
    if _is_remote(out):
        with _open(out, "wb") as f:
            pq.write_table(block, f)
    else:
        pq.write_table(block, out)
    return out


def write_block_csv(block: Block, path: str, index: int) -> str:
    import pyarrow.csv as pacsv

    from ray_tpu_torch.data.block import to_arrow

    block = to_arrow(block)

    out = _out_path(path, f"part-{index:05d}.csv")
    with _open(out, "wb") as f:
        pacsv.write_csv(block, f)
    return out


def write_block_json(block: Block, path: str, index: int) -> str:
    out = _out_path(path, f"part-{index:05d}.jsonl")
    import json

    from ray_tpu_torch.data.block import python_rows

    with _open(out, "wb") as f:
        for row in python_rows(block):
            f.write((json.dumps(row, default=str) + "\n").encode())
    return out
