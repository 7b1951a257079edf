"""Product quantization (port of `ivfadc_tpu/ops/pq.py`).

  * `train_quantizer` — per-subspace k-means over the m contiguous subspaces
    of the residuals, as one batched program (the JAX package's vmapped
    layout) or one subspace at a time for large inputs (its sequential
    layout); both draw the same per-subspace random streams.
  * `encode` — batched distance matmul + argmin, chunked over n.
  * `decode` / `decode_rotated` / `decode_rotated_int8` — codeword gathers.
    The int8 cache gathers the pre-quantized codebook rows where the JAX
    package runs a one-hot matmul: integers <= 127 are exact either way, so
    the rows are identical.

OPQ training is not ported yet; `ProductQuantizer` still carries a rotation,
so a loaded OPQ quantizer decodes and searches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ivfadc_tpu_torch.config import code_dtype_for_k
from ivfadc_tpu_torch.ops import kmeans as kmeans_ops
from ivfadc_tpu_torch.ops.metrics import Metric, SQEUCLIDEAN

# random-stream ids of make_generator: subspace i trains from stream
# _STREAM_SUBSPACE + i
_STREAM_SUBSPACE = 1000


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


def train_quantizer(seed: int, residuals: torch.Tensor, *, m: int, k: int,
                    method: str = "pq", maxiter: int = 25,
                    metric: Metric = SQEUCLIDEAN,
                    block: int = 16384) -> ProductQuantizer:
    """Train a PQ quantizer on (n, d) residual vectors.

    When m does not divide d, the quantizer space is zero-padded to
    m * ceil(d/m): padded dims carry zero residual mass, so distances are
    unchanged; `encode` pads inputs and decoding callers slice back to d."""
    if method == "opq":
        raise NotImplementedError(
            "OPQ training is not ported yet (ROADMAP A.7)")
    if method != "pq":
        raise ValueError(f"unknown quantization method {method!r}")
    n, d = residuals.shape
    residuals = residuals.to(torch.float32)
    dq = -(-d // m) * m
    if dq != d:
        residuals = torch.nn.functional.pad(residuals, (0, dq - d))
        d = dq
    block = min(block, max(256, n))
    dev = residuals.device
    gens = [kmeans_ops.make_generator(seed, _STREAM_SUBSPACE + i, dev)
            for i in range(m)]
    dsub = d // m
    if residuals.numel() * 4 > _SEQ_TRAIN_BYTES:
        cbs = [kmeans_ops.kmeans_batched(
            [gens[i]], residuals[None, :, i * dsub:(i + 1) * dsub]
            .contiguous(), k, maxiter=maxiter, metric=metric, block=block)[0]
            for i in range(m)]
        cb = torch.stack(cbs)
    else:
        cb = kmeans_ops.kmeans_batched(gens, _to_subspaces(residuals, m), k,
                                       maxiter=maxiter, metric=metric,
                                       block=block)
    return ProductQuantizer(cb, torch.eye(d, dtype=torch.float32, device=dev),
                            "pq")


def encode(pq: ProductQuantizer, residuals: torch.Tensor,
           metric: Metric = SQEUCLIDEAN, block: int = 262144) -> torch.Tensor:
    """Encode (n, d) residuals -> (n, m) codes (uint8 for k <= 256),
    chunked over n so the (m, block, k) distances stay modest."""
    residuals = residuals.to(torch.float32)
    if residuals.shape[1] != pq.d:      # ragged-subspace zero padding
        residuals = torch.nn.functional.pad(
            residuals, (0, pq.d - residuals.shape[1]))
    if pq.method == "opq":
        residuals = residuals @ pq.rotation
    n = residuals.shape[0]
    block = max(4096, min(block, (1 << 28) // max(pq.m * pq.k, 1)))
    outs = []
    for s in range(0, n, block):
        sub = _to_subspaces(residuals[s:s + block], pq.m)
        dist = kmeans_ops._pairwise(metric, sub, pq.codebooks)   # (m, b, k)
        outs.append(torch.argmin(dist, dim=2).T)
    codes = torch.cat(outs) if outs else torch.empty(
        (0, pq.m), dtype=torch.int64, device=residuals.device)
    return codes.to(_torch_code_dtype(pq.k))


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
