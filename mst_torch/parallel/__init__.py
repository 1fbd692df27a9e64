"""Training over ranks: the (data, seq) process mesh, the ranks' join, and
the sequence-parallel LSTM recurrence (counterpart of mst_tpu/parallel);
and the device mesh of one process that serving shards over."""

from mst_torch.parallel.mesh import (  # noqa: F401
    DeviceMesh, Mesh, create_device_mesh, create_mesh, local_device,
    make_sharded_train_step, replicate, shard_batch,
)
from mst_torch.parallel.multihost import (  # noqa: F401
    default_backend, initialize_multihost, shard_files_for_host,
)
