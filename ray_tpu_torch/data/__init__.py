"""ray_tpu_torch.data: streaming datasets (counterpart of ``ray_tpu/data/``).

Lazy logical plans over columnar numpy blocks, executed by a pull-based
streaming executor on the port's in-process runtime (``core``, thread
mode), terminating in ``iter_device_batches``: pinned host batches copied
to the card one step ahead of the train step, on a side stream. With the
driver attached to a cluster (``init(address=...)``) the tasks and actor
pools run in its workers, and an exchange places each reduce by the
locality of its inputs (one batched lookup of their holders).
"""

from ray_tpu_torch.data.aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum
from ray_tpu_torch.data.block import Block, BlockMetadata
from ray_tpu_torch.data.dataset import (
    ActorPoolStrategy,
    Dataset,
    from_items,
    from_numpy,
    from_pandas,
    range,
    from_arrow,
    read_arrow,
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)
from ray_tpu_torch.data.datasource import Datasource, ReadTask
from ray_tpu_torch.data.iterator import DataIterator

__all__ = [
    "ActorPoolStrategy",
    "AggregateFn",
    "Block",
    "BlockMetadata",
    "Count",
    "DataIterator",
    "Dataset",
    "Datasource",
    "Max",
    "Mean",
    "Min",
    "ReadTask",
    "Std",
    "Sum",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_arrow",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_images",
    "read_json",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
]
