"""ray_tpu_torch.data — streaming distributed datasets.

reference: python/ray/data/ (SURVEY §2.3, §3.5): lazy logical plans executed
by a streaming executor over ray_tpu_torch tasks/actor pools; blocks are
dicts of numpy columns in the object store (the JAX package's are Arrow
tables), so the package imports neither pyarrow nor pandas.
"""

from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import ActorPoolStrategy, Dataset
from ray_tpu_torch.data.datasource import Datasource
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    from_torch,
    range,  # noqa: A004
    read_audio,
    read_avro,
    read_bigquery,
    read_binary_files,
    read_clickhouse,
    read_csv,
    read_datasource,
    read_delta,
    read_hudi,
    read_iceberg,
    read_images,
    read_json,
    read_lance,
    read_mongo,
    read_numpy,
    read_orc,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_videos,
    read_webdataset,
)

__all__ = [
    "Dataset",
    "DataContext",
    "ActorPoolStrategy",
    "Datasource",
    "range",
    "from_items",
    "from_numpy",
    "from_pandas",
    "from_arrow",
    "read_parquet",
    "read_csv",
    "read_json",
    "read_text",
    "read_binary_files",
    "read_datasource",
    "read_numpy",
    "read_orc",
    "read_images",
    "read_sql",
    "read_tfrecords",
    "read_webdataset",
    "read_avro",
    "read_audio",
    "read_videos",
    "read_bigquery",
    "read_clickhouse",
    "read_mongo",
    "read_delta",
    "read_iceberg",
    "read_hudi",
    "read_lance",
    "from_torch",
    "from_huggingface",
]
