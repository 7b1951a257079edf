"""Smallest-k along the last dim with an int32 payload.

Port of `ivfadc_tpu/ops/topk.py::topk_lastdim_payload`, the dense search's
final merge. The CUDA kernel is `csrc/topk.cu`; `topk_lastdim_payload_plain`
is the same function written as plain tensor code (k min-extract passes,
the lowest index winning ties, the winner masked to +inf).

`topk_lastdim` (the payload-free kernel of the coarse fallback and the
small-batch path) is not ported yet.
"""

from __future__ import annotations

import torch

from ivfadc_tpu_torch import _build

KERNEL = _build.Kernel("topk", "topk_payload",
                       [_build.P, _build.P, _build.P, _build.P,
                        _build.I, _build.I, _build.I, _build.P])


def topk_lastdim_payload_plain(x: torch.Tensor, payload: torch.Tensor,
                               k: int):
    """Plain version of the kernel: same passes, same tie and +inf rules."""
    xs = x.to(torch.float32).clone()
    B = xs.shape[0]
    rows = torch.arange(B, device=xs.device)
    vals = torch.empty((B, k), dtype=torch.float32, device=xs.device)
    pays = torch.empty((B, k), dtype=torch.int32, device=xs.device)
    for j in range(k):
        a = torch.argmin(xs, dim=1)          # first index of the minimum
        vals[:, j] = xs[rows, a]
        pays[:, j] = payload[rows, a].to(torch.int32)
        xs[rows, a] = float("inf")
    return vals, pays


def topk_lastdim_payload(x: torch.Tensor, payload: torch.Tensor, k: int):
    """Smallest-k of x (B, N) f32 along the last dim, carrying `payload`
    (B, N) i32 for the winners: returns (vals (B, k) ascending, payload
    (B, k)). Rows with fewer than k finite entries re-select +inf lanes, so
    payloads of +inf entries are meaningful only if the input used -1
    padding: callers mask by isfinite(vals).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    B, N = x.shape
    if payload.shape != x.shape:
        raise ValueError(f"payload {tuple(payload.shape)} != x {(B, N)}")
    if not 1 <= k <= min(N, 128):
        raise ValueError(f"k must be in [1, min(N, 128)], got k={k}, N={N}")
    if x.device.type == "cpu":
        return topk_lastdim_payload_plain(x, payload, k)
    x = x.to(torch.float32).contiguous()
    payload = payload.to(torch.int32).contiguous()
    if payload.device != x.device:
        raise ValueError("x and payload must be on one device")
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    pays = torch.empty((B, k), dtype=torch.int32, device=x.device)
    KERNEL(x.data_ptr(), payload.data_ptr(), vals.data_ptr(),
           pays.data_ptr(), B, N, k, _build.stream_ptr(x.device))
    return vals, pays
