"""ivfadc_tpu_torch.parallel: scale-out (port of `ivfadc_tpu/parallel/`):
device meshes, sharded serving, the distributed build, the multi-process
bootstrap on `torch.distributed`, and shard-aware persistence."""

from ivfadc_tpu_torch.parallel.bootstrap import (initialize_cluster,
                                                 process_info,
                                                 shutdown_cluster)
from ivfadc_tpu_torch.parallel.mesh import DATA_AXIS, SHARD_AXIS, Mesh, make_mesh
from ivfadc_tpu_torch.parallel.persistence import (consolidate_sharded_index,
                                                   consolidate_sharded_to_file,
                                                   load_sharded_index,
                                                   save_sharded_index)
from ivfadc_tpu_torch.parallel.sharded import ShardedIVFADCIndex

__all__ = [
    "ShardedIVFADCIndex", "make_mesh", "Mesh", "SHARD_AXIS", "DATA_AXIS",
    "save_sharded_index", "load_sharded_index", "consolidate_sharded_index",
    "consolidate_sharded_to_file",
    "initialize_cluster", "shutdown_cluster", "process_info",
]
