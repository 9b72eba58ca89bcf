"""Input pipeline of the port: the native threaded batcher, its Python
twin, the shard format and the device feed."""

from kubeflow_tpu_torch.data.loader import (  # noqa: F401
    DataLoader,
    PyDataLoader,
    device_feed,
    read_shards,
    shard_path,
    write_shards,
)
