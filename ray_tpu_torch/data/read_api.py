"""Read API: dataset constructors.

reference: python/ray/data/read_api.py (read_* :242,796; range, from_items,
from_pandas, from_numpy, from_arrow).

``from_arrow``/``from_pandas`` and the parquet, ORC, CSV and JSON readers
need pyarrow (pandas) and import it inside the call; everything else runs
without either.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from ray_tpu_torch.data._internal.plan import ExecutionPlan, InputData, Read
from ray_tpu_torch.data.block import to_block
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.datasource import (
    Datasource,
    FileDatasource,
    ItemsDatasource,
    RangeDatasource,
    SQLDatasource,
    read_binary_file,
    read_csv_file,
    read_image_file,
    read_json_file,
    read_numpy_file,
    read_orc_file,
    read_parquet_file,
    read_text_file,
    read_tfrecords_file,
    read_webdataset_file,
)

DEFAULT_PARALLELISM = 8


def read_datasource(datasource: Datasource, *, parallelism: int = -1) -> Dataset:
    if parallelism <= 0:
        parallelism = DEFAULT_PARALLELISM
    tasks = datasource.get_read_tasks(parallelism)
    plan = ExecutionPlan([Read(name=f"Read{type(datasource).__name__}",
                               read_tasks=tasks, datasource=datasource,
                               parallelism=parallelism)])
    return Dataset(plan)


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return read_datasource(RangeDatasource(n), parallelism=parallelism)


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    return read_datasource(ItemsDatasource(items), parallelism=parallelism)


def from_numpy(arrays: Union[np.ndarray, Dict[str, np.ndarray]],
               column: str = "data") -> Dataset:
    """One block of numpy columns.  A 2-D or wider array is a tensor
    column (rows on its first axis), one contiguous array in the store:
    batches of it come back as views, no copy.  (The JAX package's Arrow
    blocks take 1-D arrays only.)"""
    if isinstance(arrays, dict):
        block = {k: np.asarray(v) for k, v in arrays.items()}
    else:
        block = {column: np.asarray(arrays)}
    return _from_block(to_block(block), "FromNumpy")


def from_pandas(df) -> Dataset:
    return _from_block(to_block(df), "FromPandas")


def from_arrow(table) -> Dataset:
    return _from_block(to_block(table), "FromArrow")


def _from_block(block, name: str) -> Dataset:
    import ray_tpu_torch

    ref = ray_tpu_torch.put(block)
    return Dataset(ExecutionPlan([InputData(name=name, refs=[ref])]))


def read_parquet(paths, *, parallelism: int = -1) -> Dataset:
    # parquet honors both optimizer pushdown rules (columns + predicate)
    return read_datasource(
        FileDatasource(paths, read_parquet_file,
                       pushdown=("columns", "predicate")),
        parallelism=parallelism)


def read_csv(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(FileDatasource(paths, read_csv_file), parallelism=parallelism)


def read_json(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(FileDatasource(paths, read_json_file), parallelism=parallelism)


def read_text(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(FileDatasource(paths, read_text_file), parallelism=parallelism)


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    return read_datasource(FileDatasource(paths, read_binary_file), parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = -1) -> Dataset:
    """reference: read_api.py read_numpy (.npy / .npz files)."""
    return read_datasource(FileDatasource(paths, read_numpy_file), parallelism=parallelism)


def read_orc(paths, *, parallelism: int = -1) -> Dataset:
    """reference: read_api.py read_orc (pyarrow ORC)."""
    return read_datasource(FileDatasource(paths, read_orc_file), parallelism=parallelism)


def read_images(paths, *, parallelism: int = -1) -> Dataset:
    """reference: read_api.py read_images — rows of raw HWC uint8 bytes +
    shape columns (decode with np.frombuffer(...).reshape(h, w, c))."""
    return read_datasource(FileDatasource(paths, read_image_file), parallelism=parallelism)


def read_tfrecords(paths, *, parallelism: int = -1) -> Dataset:
    """reference: read_api.py read_tfrecords — rows carry the raw record
    bytes (no tensorflow dependency; parse Examples downstream)."""
    return read_datasource(FileDatasource(paths, read_tfrecords_file), parallelism=parallelism)


def read_webdataset(paths, *, parallelism: int = -1) -> Dataset:
    """reference: read_api.py read_webdataset — tar shards of key-grouped
    samples; one column per member extension."""
    return read_datasource(FileDatasource(paths, read_webdataset_file), parallelism=parallelism)


def read_sql(sql: str, connection_factory, *, parallelism: int = -1) -> Dataset:
    """reference: read_api.py read_sql(sql, connection_factory) — DB-API 2
    connections (sqlite3, psycopg2, ...)."""
    return read_datasource(SQLDatasource(sql, connection_factory), parallelism=parallelism)


def from_torch(torch_dataset, *, parallelism: int = -1) -> Dataset:
    """reference: read_api.py from_torch — map-style torch datasets; tensor
    values land as numpy."""
    import builtins

    def to_np(v):
        if hasattr(v, "numpy"):
            return v.numpy()
        if isinstance(v, dict):
            return {k: to_np(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(to_np(x) for x in v)
        return v

    items = []
    for i in builtins.range(len(torch_dataset)):  # module-level range() is the Dataset ctor
        row = to_np(torch_dataset[i])
        items.append(row if isinstance(row, dict) else {"item": row})
    return from_items(items, parallelism=parallelism)


def from_huggingface(hf_dataset, *, parallelism: int = -1) -> Dataset:
    """reference: read_api.py from_huggingface — any iterable of row dicts
    with column_names (datasets.Dataset satisfies this)."""
    return from_items(list(hf_dataset), parallelism=parallelism)


# -- connector long tail (reference: _internal/datasource/): not ported yet


def _connector(name: str):
    raise NotImplementedError(
        f"{name}: the warehouse, lake, Avro, audio and video connectors "
        f"(data/connectors.py, data/_internal/avro.py) are not ported yet "
        f"(ROADMAP A16, data/ connectors)")


def read_avro(paths, *, parallelism: int = -1) -> Dataset:
    _connector("read_avro")


def read_audio(paths, *, parallelism: int = -1) -> Dataset:
    _connector("read_audio")


def read_videos(paths, *, frame_stride: int = 1, parallelism: int = -1) -> Dataset:
    _connector("read_videos")


def read_bigquery(project: str, *, query: str = None, dataset: str = None,
                  transport=None, parallelism: int = -1) -> Dataset:
    _connector("read_bigquery")


def read_clickhouse(dsn: str, *, table: str = None, query: str = None,
                    transport=None, parallelism: int = -1) -> Dataset:
    _connector("read_clickhouse")


def read_mongo(client_factory, database: str, collection: str, *,
               match: Optional[dict] = None, parallelism: int = -1) -> Dataset:
    _connector("read_mongo")


def read_delta(table_path: str, *, parallelism: int = -1) -> Dataset:
    _connector("read_delta")


def read_iceberg(table_path: str, *, snapshot_id: Optional[int] = None,
                 parallelism: int = -1) -> Dataset:
    _connector("read_iceberg")


def read_hudi(table_path: str, *, parallelism: int = -1) -> Dataset:
    _connector("read_hudi")


def read_lance(uri: str, *, columns: Optional[List[str]] = None,
               parallelism: int = -1) -> Dataset:
    _connector("read_lance")
