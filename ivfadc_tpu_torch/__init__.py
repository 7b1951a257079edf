"""ivfadc_tpu_torch — the IVFADC approximate-nearest-neighbor engine on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of `ivfadc_tpu` (JAX/Pallas): same public API, same configuration
and the same on-disk format. This package imports torch and never jax.
"""

from ivfadc_tpu_torch.config import IVFADCConfig
from ivfadc_tpu_torch.models.index import IVFADCIndex
from ivfadc_tpu_torch.ops.metrics import Metric, get_metric, register_metric
from ivfadc_tpu_torch.ops.pq import ProductQuantizer
from ivfadc_tpu_torch.serving import BatchingSearcher

__version__ = "0.1.0"


def knn_search(index, points, k: int, w: int = 1):
    """Single point or batch search (see IVFADCIndex.search); works on
    plain and `ShardedIVFADCIndex` indexes alike."""
    return index.search(points, k, w=w)


def delete_from_index(index: IVFADCIndex, ids) -> None:
    """Delete by 0-based ids (see IVFADCIndex.delete); surviving ids shift
    down to stay contiguous."""
    index.delete(ids)


def save_ivfadc_index(path: str, index: IVFADCIndex) -> None:
    index.save(path)


def load_ivfadc_index(path: str, device=None) -> IVFADCIndex:
    return IVFADCIndex.load(path, device=device)


def __getattr__(name: str):
    # lazy: the sharded layer loads when a user reaches for it
    if name == "ShardedIVFADCIndex":
        from ivfadc_tpu_torch.parallel.sharded import ShardedIVFADCIndex
        return ShardedIVFADCIndex
    if name == "make_mesh":
        from ivfadc_tpu_torch.parallel.mesh import make_mesh
        return make_mesh
    raise AttributeError(
        f"module 'ivfadc_tpu_torch' has no attribute {name!r}")


__all__ = [
    "BatchingSearcher", "IVFADCConfig", "IVFADCIndex", "Metric", "ProductQuantizer",
    "ShardedIVFADCIndex", "get_metric", "make_mesh", "register_metric",
    "knn_search", "delete_from_index", "save_ivfadc_index",
    "load_ivfadc_index",
]
