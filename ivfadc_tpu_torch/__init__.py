"""ivfadc_tpu_torch — the IVFADC approximate-nearest-neighbor engine on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of `ivfadc_tpu` (JAX/Pallas): same public API, same configuration
and the same on-disk format. This package imports torch and never jax.
"""

from ivfadc_tpu_torch.config import IVFADCConfig
from ivfadc_tpu_torch.models.index import IVFADCIndex
from ivfadc_tpu_torch.ops.metrics import Metric, get_metric, register_metric
from ivfadc_tpu_torch.ops.pq import ProductQuantizer

__version__ = "0.1.0"


def knn_search(index, points, k: int, w: int = 1):
    """Single point or batch search (see IVFADCIndex.search)."""
    return index.search(points, k, w=w)


def save_ivfadc_index(path: str, index: IVFADCIndex) -> None:
    index.save(path)


def load_ivfadc_index(path: str, device=None) -> IVFADCIndex:
    return IVFADCIndex.load(path, device=device)


__all__ = [
    "IVFADCConfig", "IVFADCIndex", "Metric", "ProductQuantizer",
    "get_metric", "register_metric", "knn_search", "save_ivfadc_index",
    "load_ivfadc_index",
]
