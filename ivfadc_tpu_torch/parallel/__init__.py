"""ivfadc_tpu_torch.parallel: one index's inverted lists sharded over the
devices of one process (port of the single-process half of
`ivfadc_tpu/parallel/`)."""

from ivfadc_tpu_torch.parallel.mesh import DATA_AXIS, SHARD_AXIS, Mesh, make_mesh
from ivfadc_tpu_torch.parallel.sharded import ShardedIVFADCIndex

__all__ = ["ShardedIVFADCIndex", "make_mesh", "Mesh", "SHARD_AXIS",
           "DATA_AXIS"]
