"""ray_tpu_torch.data — streaming datasets over the task runtime: the
port of ``ray_tpu.data``.

Reference parity: ray.data (python/ray/data/) — lazy plans, block-based
streaming execution with bounded in-flight work, map/map_batches/filter
transforms, actor-pool compute, all-to-all exchanges (random_shuffle /
sort / groupby-aggregate / join), Arrow-backed parquet IO, per-shard
Train ingestion, and `Dataset.iter_torch_batches`, which feeds a train
step torch tensors on the card.

It runs on the port's local runtime: call
``ray_tpu_torch.init(local_mode=True)`` first (read, map and exchange
tasks run on threads of this process). Parquet, `from_arrow` and
``batch_format="pyarrow"`` need pyarrow, which is imported only where
they are used.
"""

from ray_tpu_torch.data.dataset import (
    AggregateFn,
    Count,
    Dataset,
    GroupedData,
    Max,
    Mean,
    Min,
    Std,
    Sum,
    from_arrow,
    from_items,
    from_numpy,
    range,
    read_csv,
    read_datasource,
    read_json,
    read_parquet,
    read_text,
)
from ray_tpu_torch.data.datasource import Datasource, ReadTask

__all__ = ["AggregateFn", "Count", "Dataset", "Datasource", "GroupedData",
           "Max", "Mean", "Min", "ReadTask", "Std", "Sum", "from_arrow",
           "from_items", "from_numpy", "range", "read_csv",
           "read_datasource", "read_json", "read_parquet", "read_text"]
