"""Metric registry (port of `ivfadc_tpu/ops/metrics.py`).

A metric is a small frozen object of plain functions on tensors. Only
metrics whose subspace decomposition is additive make the ADC estimator
exact (true for sqeuclidean / cityblock / inner_product; euclidean is
handled by finalizing with sqrt at the very end); `.additive` records it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    # pairwise(X:(n,d), Y:(c,d)) -> (n,c) distances, as a matmul wherever
    # possible.
    pairwise: Callable
    # finalize(d) applied to accumulated distances before returning to user.
    finalize: Callable
    # Whether sum-over-subspaces of this metric equals the metric on the
    # concatenated vector (makes the ADC table sum exact).
    additive: bool
    # Whether k-means training under this metric is supported (Lloyd updates
    # assume a mean minimizer, i.e. squared-euclidean geometry).
    trainable: bool = True
    # ADC tables: True -> built from the query residual (translation-invariant
    # metrics); False -> built from the query itself (inner-product family),
    # in which case the coarse term is always part of the score.
    residual_based: bool = True


def _sqeuclidean_pairwise(x, y):
    # ||x - y||^2 = ||x||^2 + ||y||^2 - 2 x.y  — one matmul.
    xn = torch.sum(x * x, dim=-1, keepdim=True)            # (n, 1)
    yn = torch.sum(y * y, dim=-1)                          # (c,)
    cross = x @ y.T
    return torch.clamp_min(xn + yn[None, :] - 2.0 * cross, 0.0)


def _cityblock_pairwise(x, y):
    return torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)


def _inner_product_pairwise(x, y):
    # Negated inner product so that "smaller is closer" holds uniformly.
    return -(x @ y.T)


def _cosine_pairwise(x, y):
    xn = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-30)
    yn = y / torch.clamp_min(torch.linalg.norm(y, dim=-1, keepdim=True), 1e-30)
    return 1.0 - xn @ yn.T


def _identity(d):
    return d


SQEUCLIDEAN = Metric("sqeuclidean", _sqeuclidean_pairwise, _identity,
                     additive=True)
# euclidean accumulates squared distances and takes sqrt at the end, so the
# ADC sum stays additive and the user sees true euclidean distances.
EUCLIDEAN = Metric("euclidean", _sqeuclidean_pairwise,
                   lambda d: torch.sqrt(torch.clamp_min(d, 0.0)),
                   additive=True)
# cityblock / inner_product / cosine train like the JAX package trains them:
# assign under the metric, update centroids by MEAN.
CITYBLOCK = Metric("cityblock", _cityblock_pairwise, _identity, additive=True)
INNER_PRODUCT = Metric("inner_product", _inner_product_pairwise, _identity,
                       additive=True, residual_based=False)
COSINE = Metric("cosine", _cosine_pairwise, _identity, additive=False)

_REGISTRY = {
    m.name: m for m in (SQEUCLIDEAN, EUCLIDEAN, CITYBLOCK, INNER_PRODUCT, COSINE)
}


def get_metric(name: str) -> Metric:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown metric {name!r}; available: {sorted(_REGISTRY)}") from None


def register_metric(metric: Metric) -> None:
    _REGISTRY[metric.name] = metric
