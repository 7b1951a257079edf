"""Product quantization (port of `ivfadc_tpu/ops/pq.py`).

  * `train_quantizer` — per-subspace k-means over the m contiguous subspaces
    of the residuals, as one batched program (the JAX package's vmapped
    layout) or one subspace at a time for large inputs (its sequential
    layout); both draw the same per-subspace random streams. OPQ (Ge et
    al. 2013) alternates codebook training on the rotated residuals with
    the rotation's orthogonal Procrustes solve, an SVD in float64 on the
    host.
  * `encode` — batched distance matmul + argmin, chunked over n.
  * `decode` / `decode_rotated` / `decode_rotated_int8` — codeword gathers.
    The int8 cache gathers the pre-quantized codebook rows where the JAX
    package runs a one-hot matmul: integers <= 127 are exact either way, so
    the rows are identical.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ivfadc_tpu_torch.config import code_dtype_for_k
from ivfadc_tpu_torch.ops import kmeans as kmeans_ops
from ivfadc_tpu_torch.ops.metrics import Metric, SQEUCLIDEAN

# random-stream ids of make_generator: subspace i trains from stream
# _STREAM_SUBSPACE + i; OPQ's iteration it from _STREAM_OPQ + it *
# _STREAM_OPQ_STRIDE + i (the JAX package folds the iteration into its key)
_STREAM_SUBSPACE = 1000
_STREAM_OPQ = 1 << 32
_STREAM_OPQ_STRIDE = 1 << 20


class ProductQuantizer(NamedTuple):
    """Trained residual quantizer.

    codebooks: (m, k, dsub) float32 per-subspace codeword tables.
    rotation:  (d, d) float32 orthogonal — identity for method="pq".
    method:    "pq" | "opq".
    """
    codebooks: torch.Tensor
    rotation: torch.Tensor
    method: str

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def d(self) -> int:
        return self.m * self.dsub

    @property
    def code_dtype(self) -> np.dtype:
        return np.dtype(code_dtype_for_k(self.k))


def _torch_code_dtype(k: int) -> torch.dtype:
    # uint8 codes for k <= 256; wider codes are held as int32 on device
    return torch.uint8 if k <= 256 else torch.int32


def _to_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) -> (m, n, dsub) contiguous-rows split (rowrange parity)."""
    n, d = x.shape
    return x.reshape(n, m, d // m).permute(1, 0, 2).contiguous()


# subspace tensors bigger than this train one subspace at a time
_SEQ_TRAIN_BYTES = 2 << 30


def _train_codebooks(gens, x: torch.Tensor, m: int, k: int, maxiter: int,
                     metric: Metric, block: int) -> torch.Tensor:
    """(m, k, dsub) codebooks of the m subspaces of x (n, d): one batched
    k-means, or one subspace at a time when the subspace tensor would
    exceed _SEQ_TRAIN_BYTES; subspace i draws from gens[i] either way."""
    dsub = x.shape[1] // m
    if x.numel() * 4 > _SEQ_TRAIN_BYTES:
        return torch.stack([kmeans_ops.kmeans_batched(
            [gens[i]], x[None, :, i * dsub:(i + 1) * dsub].contiguous(), k,
            maxiter=maxiter, metric=metric, block=block)[0]
            for i in range(m)])
    return kmeans_ops.kmeans_batched(gens, _to_subspaces(x, m), k,
                                     maxiter=maxiter, metric=metric,
                                     block=block)


def train_quantizer(seed: int, residuals: torch.Tensor, *, m: int, k: int,
                    method: str = "pq", maxiter: int = 25,
                    metric: Metric = SQEUCLIDEAN, opq_iters: int = 4,
                    block: int = 16384) -> ProductQuantizer:
    """Train a PQ or OPQ quantizer on (n, d) residual vectors.

    When m does not divide d, the quantizer space is zero-padded to
    m * ceil(d/m): padded dims carry zero residual mass, so distances are
    unchanged; `encode` pads inputs and decoding callers slice back to d.
    OPQ runs max(1, opq_iters) outer iterations: codebooks trained on the
    residuals rotated by the current R, the rotated residuals encoded and
    reconstructed, then R = U V^T from the SVD of residuals^T recon,
    solved in float64 on the host so R stays orthogonal."""
    if method not in ("pq", "opq"):
        raise ValueError(f"unknown quantization method {method!r}")
    n, d = residuals.shape
    residuals = residuals.to(torch.float32)
    dq = -(-d // m) * m
    if dq != d:
        residuals = torch.nn.functional.pad(residuals, (0, dq - d))
        d = dq
    block = min(block, max(256, n))
    dev = residuals.device
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    if method == "pq":
        gens = [kmeans_ops.make_generator(seed, _STREAM_SUBSPACE + i, dev)
                for i in range(m)]
        return ProductQuantizer(_train_codebooks(
            gens, residuals, m, k, maxiter, metric, block), eye, "pq")
    rot, cb = eye, None
    for it in range(max(1, opq_iters)):
        xr = residuals @ rot
        gens = [kmeans_ops.make_generator(
            seed, _STREAM_OPQ + it * _STREAM_OPQ_STRIDE + i, dev)
            for i in range(m)]
        cb = _train_codebooks(gens, xr, m, k, maxiter, metric, block)
        recon = _gather(cb, _encode_rotated(cb, xr, metric))
        cov = (residuals.T @ recon).cpu().numpy().astype(np.float64)
        u, _, vt = np.linalg.svd(cov, full_matrices=False)
        rot = torch.as_tensor(u @ vt, dtype=torch.float32, device=dev)
    return ProductQuantizer(cb, rot, "opq")


def _encode_rotated(codebooks: torch.Tensor, x: torch.Tensor,
                    metric: Metric, block: int = 262144) -> torch.Tensor:
    """(n, d) rotated, padded residuals -> (n, m) int64 codes, chunked over
    n so the (m, block, k) distances stay modest."""
    m, k, _ = codebooks.shape
    block = max(4096, min(block, (1 << 28) // max(m * k, 1)))
    outs = []
    for s in range(0, x.shape[0], block):
        sub = _to_subspaces(x[s:s + block], m)
        dist = kmeans_ops._pairwise(metric, sub, codebooks)      # (m, b, k)
        outs.append(torch.argmin(dist, dim=2).T)
    return torch.cat(outs) if outs else torch.empty(
        (0, m), dtype=torch.int64, device=x.device)


def encode(pq: ProductQuantizer, residuals: torch.Tensor,
           metric: Metric = SQEUCLIDEAN, block: int = 262144) -> torch.Tensor:
    """Encode (n, d) residuals -> (n, m) codes (uint8 for k <= 256)."""
    residuals = residuals.to(torch.float32)
    if residuals.shape[1] != pq.d:      # ragged-subspace zero padding
        residuals = torch.nn.functional.pad(
            residuals, (0, pq.d - residuals.shape[1]))
    if pq.method == "opq":
        residuals = residuals @ pq.rotation
    return _encode_rotated(pq.codebooks, residuals, metric, block).to(
        _torch_code_dtype(pq.k))


def _gather(table: torch.Tensor, codes: torch.Tensor,
            block: int = 262144) -> torch.Tensor:
    """table (m, k, dsub), codes (n, m) -> (n, m * dsub) rows table[i][code]."""
    m, _, dsub = table.shape
    sub = torch.arange(m, device=table.device)[None, :]
    outs = [table[sub, codes[s:s + block].to(torch.int64)]
            .reshape(-1, m * dsub)
            for s in range(0, codes.shape[0], block)]
    return torch.cat(outs) if outs else table.new_empty((0, m * dsub))


def decode_rotated(pq: ProductQuantizer, codes) -> torch.Tensor:
    """(n, m) codes -> (n, d) bf16 decoded residuals in the ROTATED space."""
    return _gather(pq.codebooks.to(torch.bfloat16), torch.as_tensor(codes))


def cache_scale(pq: ProductQuantizer) -> torch.Tensor:
    """Per-column int8 dequantization scale for the decoded-residual cache:
    column j of any decoded residual is an entry of codebook[j // dsub][:,
    j % dsub], so max |codebook| per column bounds every cache value."""
    amax = torch.amax(torch.abs(pq.codebooks), dim=1)          # (m, dsub)
    return torch.clamp_min(amax.reshape(-1) / 127.0, 1e-12).to(torch.float32)


def decode_rotated_int8(pq: ProductQuantizer, codes,
                        scale: torch.Tensor) -> torch.Tensor:
    """(n, m) codes -> (n, d) int8 cache rows: round(codeword / scale),
    round half to even, clipped to [-127, 127]."""
    m, k, dsub = pq.codebooks.shape
    scale = scale[:m * dsub]     # callers may hold a lane-padded scale
    qcb = torch.clamp(torch.round(pq.codebooks / scale.reshape(m, 1, dsub)),
                      -127, 127).to(torch.int8)
    return _gather(qcb, torch.as_tensor(codes))


def decode(pq: ProductQuantizer, codes) -> torch.Tensor:
    """Decode (n, m) codes -> (n, d) approximate residuals, applying rot^T
    for OPQ."""
    recon = _gather(pq.codebooks, torch.as_tensor(codes))
    if pq.method == "opq":
        recon = recon @ pq.rotation.T
    return recon
