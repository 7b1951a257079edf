"""Smallest-k along the last dim, with an int32 payload or the indices.

Port of `ivfadc_tpu/ops/topk.py`: `topk_lastdim_payload` is the grouped
dense search's final merge, `topk_lastdim` the small-batch merge over
position payloads and the coarse quantizer's pairwise fallback. The CUDA
kernels are in `csrc/topk.cu` (one streamed read of each row, a running
top-k list with a threshold, merges by rank); the `*_plain` functions are
the same functions written as plain tensor code (k min-extract passes, the
lowest index winning ties, the winner masked to +inf), which define the
result the kernels equal bit for bit: ascending (value, index) order with
-0.0 == +0.0, each winner's own bits, and (+inf, index 0) where a row holds
fewer than k entries below +inf.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ivfadc_tpu_torch import _build

KERNEL = _build.Kernel("topk", "topk_payload",
                       [_build.P, _build.P, _build.P, _build.P,
                        _build.I, _build.I, _build.I, _build.P])
INDEX_KERNEL = _build.Kernel("topk", "topk_index",
                             [_build.P, _build.P, _build.P,
                              _build.I, _build.I, _build.I, _build.P])

# longest row routed to the kernels (f32 elements; they take any length):
# longer rows take the stable sort, as k > 128 does
MAX_N = 49152


@functools.lru_cache(maxsize=None)
def topk_fit(B: int, N: int, k: int, payload: bool,
             device_index: int = 0) -> dict:
    """The launch shape of a (B, N) selection of k on a CUDA device
    (payload: kernel 4, else kernel 6): warps (rows) a block, resident
    blocks per SM (the occupancy API), shared bytes a block, registers and
    local (spilled) bytes a thread, the grid and the SM count."""
    out = (ctypes.c_int * 7)()
    fit = _build.HostFn("topk", "topk_fit", [_build.I] * 4 + [_build.P])
    with torch.cuda.device(device_index):
        fit(B, N, k, int(payload), ctypes.addressof(out))
    return dict(warps=out[0], blocks_per_sm=out[1], smem_bytes=out[2],
                registers=out[3], local_bytes=out[4], grid=out[5],
                sms=out[6])


def topk_lastdim_payload_plain(x: torch.Tensor, payload: torch.Tensor,
                               k: int):
    """Plain version of the kernel: the TPU kernel's k min-extract passes,
    whose result (ties, +inf tail, a winner's own bits) the kernel equals."""
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
    (B, k)). Rows with fewer than k entries below +inf end in (+inf,
    payload[row, 0]): callers mask by isfinite(vals).

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


def topk_lastdim_plain(x: torch.Tensor, k: int):
    """Plain version of the index kernel: the TPU kernel's k min-extract
    passes -> (vals (B, k) f32 ascending, idx (B, k) i32)."""
    xs = x.to(torch.float32).clone()
    B = xs.shape[0]
    rows = torch.arange(B, device=xs.device)
    vals = torch.empty((B, k), dtype=torch.float32, device=xs.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=xs.device)
    for j in range(k):
        a = torch.argmin(xs, dim=1)          # first index of the minimum
        vals[:, j] = xs[rows, a]
        idx[:, j] = a.to(torch.int32)
        xs[rows, a] = float("inf")
    return vals, idx


def topk_lastdim(x: torch.Tensor, k: int):
    """Smallest-k of x (B, N) along the last dim -> (vals (B, k) f32
    ascending, idx (B, k) i32), equal values in index order. When a row
    holds fewer than k entries below +inf the kernel's tail is (+inf, 0),
    repeated: callers mask by isfinite(vals).

    k <= 128 on rows of at most 49152 entries is the kernel's range (CPU
    tensors run its plain version, CUDA tensors launch it). Beyond it,
    where the JAX package leaves its kernel for a sort as well, a stable
    sort gives the same values and tie order (its +inf tail holds distinct
    indices)."""
    B, N = x.shape
    if not 1 <= k <= N:
        raise ValueError(f"k must be in [1, N], got k={k}, N={N}")
    x = x.to(torch.float32)
    if k > 128 or N > MAX_N:
        vals, idx = torch.sort(x, dim=1, stable=True)
        return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)
    if x.device.type == "cpu":
        return topk_lastdim_plain(x, k)
    x = x.contiguous()
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    INDEX_KERNEL(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), B, N, k,
                 _build.stream_ptr(x.device))
    return vals, idx
