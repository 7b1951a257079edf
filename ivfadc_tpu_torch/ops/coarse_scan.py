"""Fused coarse probes: exact top-w cells, alone or with the dense scan's
inputs.

Port of `ivfadc_tpu/ops/coarse_scan.py`: `coarse_probe_vbase` (the v1
engine) and `coarse_topw`. The CUDA kernels are in `csrc/coarse_scan.cu`;
`coarse_vbase_plain` and `coarse_topw_plain` are the same functions as
plain tensor code. Scores are exact f32 (the naive coarse quantizer is
contractually the exact brute-force scan). The per-query `||q||^2` term is
rank-constant and added back outside the kernels, as in the JAX package.

The v2 engine is not ported yet.
"""

from __future__ import annotations

import torch

from ivfadc_tpu_torch import _build

KERNEL = _build.Kernel("coarse_scan", "coarse_vbase",
                       [_build.P, _build.P, _build.P, _build.P, _build.I,
                        _build.I, _build.I, _build.I, _build.I, _build.P,
                        _build.P, _build.P, _build.P, _build.P])
TOPW_KERNEL = _build.Kernel("coarse_scan", "coarse_topw",
                            [_build.P, _build.P, _build.P, _build.I,
                             _build.I, _build.I, _build.I, _build.P,
                             _build.P, _build.P])


def coarse_vbase_plain(q32, c32, cn, rot, w: int, apply_rot: bool):
    """Plain version of the kernel -> (vals (B,w) f32 scores without
    ||q||^2, cells (B,w) i32, v (B,w,d) bf16, rn (B,w) f32)."""
    B = q32.shape[0]
    scores = cn[None, :] - 2.0 * (q32 @ c32.T)
    rows = torch.arange(B, device=q32.device)
    vals, cells, vs, rns = [], [], [], []
    for _ in range(w):
        a = torch.argmin(scores, dim=1)          # first index of the minimum
        vals.append(scores[rows, a])
        cells.append(a.to(torch.int32))
        r = q32 - c32[a]
        if apply_rot:
            r = r @ rot
        vs.append((-2.0 * r).to(torch.bfloat16))
        rns.append(torch.sum(r * r, dim=1))
        scores[rows, a] = float("inf")
    return (torch.stack(vals, 1), torch.stack(cells, 1),
            torch.stack(vs, 1), torch.stack(rns, 1))


def coarse_vbase(q32, c32, cn, rot, w: int, apply_rot: bool):
    """The kernel's wrapper: CPU tensors run the plain version, CUDA tensors
    launch the kernel."""
    if q32.device.type == "cpu":
        return coarse_vbase_plain(q32, c32, cn, rot, w, apply_rot)
    B, d = q32.shape
    kc = c32.shape[0]
    dev = q32.device
    args = [t.to(torch.float32).contiguous() for t in (q32, c32, cn, rot)]
    if any(t.device != dev for t in args):
        raise ValueError("coarse_vbase inputs must be on one device")
    vals = torch.empty((B, w), dtype=torch.float32, device=dev)
    cells = torch.empty((B, w), dtype=torch.int32, device=dev)
    v = torch.empty((B, w, d), dtype=torch.bfloat16, device=dev)
    rn = torch.empty((B, w), dtype=torch.float32, device=dev)
    KERNEL(*(t.data_ptr() for t in args), B, d, kc, w, int(apply_rot),
           vals.data_ptr(), cells.data_ptr(), v.data_ptr(), rn.data_ptr(),
           _build.stream_ptr(dev))
    return vals, cells, v, rn


def coarse_probe_vbase(queries, centroids, w: int, rotation,
                       apply_rot: bool, include_base: bool):
    """Fused coarse probe + scan-input construction (squared-euclidean).

    Returns (cells (B,w) i32, cdists (B,w) f32, v (B,w,d) bf16,
    base (B,w) f32), v = -2 * rot(q - c), base = |rot(q - c)|^2 (+ cdist
    when include_base). Unlike the JAX wrapper it never returns None: the
    kernel streams the centroid table in chunks and takes every kc."""
    B, d = queries.shape
    kc = centroids.shape[0]
    if apply_rot and rotation.shape[0] != d:
        raise NotImplementedError(
            "ragged-subspace (zero-padded) rotations are not ported yet")
    if not 1 <= w <= min(kc, 128):
        raise NotImplementedError(
            f"the fused coarse probe takes 1 <= w <= min(kc, 128), got w={w}")
    q32 = queries.to(torch.float32)
    c32 = centroids.to(torch.float32)
    cn = torch.sum(c32 * c32, dim=1)
    rot = rotation.to(torch.float32) if apply_rot \
        else torch.eye(d, dtype=torch.float32, device=q32.device)
    qn = torch.sum(q32 * q32, dim=1, keepdim=True)
    vals, cells, v, rn = coarse_vbase(q32, c32, cn, rot, w, apply_rot)
    cdists = torch.clamp_min(vals + qn, 0.0)
    base = rn + cdists if include_base else rn
    return cells, cdists, v, base


def coarse_topw_plain(q32, c32, cn, w: int):
    """Plain version of the top-w kernel -> (vals (B,w) f32 scores without
    ||q||^2, cells (B,w) i32): w argmin passes, lowest index on ties."""
    B = q32.shape[0]
    scores = cn[None, :] - 2.0 * (q32 @ c32.T)
    rows = torch.arange(B, device=q32.device)
    vals, cells = [], []
    for _ in range(w):
        a = torch.argmin(scores, dim=1)          # first index of the minimum
        vals.append(scores[rows, a])
        cells.append(a.to(torch.int32))
        scores[rows, a] = float("inf")
    return torch.stack(vals, 1), torch.stack(cells, 1)


def coarse_topw(queries, centroids, w: int):
    """Exact brute-force squared-euclidean top-w cells without materializing
    the (B, kc) matrix in device memory. queries (B, d), centroids (kc, d)
    -> (cells (B, w) i32, sqdists (B, w) f32 ascending), for 1 <= w <=
    min(kc, 128). Unlike the JAX wrapper it never returns None: the kernel
    streams the centroid table in chunks and takes every kc. CPU tensors
    run the plain version, CUDA tensors launch the kernel."""
    B, d = queries.shape
    kc = centroids.shape[0]
    if not 1 <= w <= min(kc, 128):
        raise NotImplementedError(
            f"the fused coarse probe takes 1 <= w <= min(kc, 128), got w={w}")
    q32 = queries.to(torch.float32).contiguous()
    c32 = centroids.to(torch.float32).contiguous()
    if c32.device != q32.device:
        raise ValueError("coarse_topw inputs must be on one device")
    cn = torch.sum(c32 * c32, dim=1)
    if q32.device.type == "cpu":
        vals, cells = coarse_topw_plain(q32, c32, cn, w)
    else:
        vals = torch.empty((B, w), dtype=torch.float32, device=q32.device)
        cells = torch.empty((B, w), dtype=torch.int32, device=q32.device)
        TOPW_KERNEL(q32.data_ptr(), c32.data_ptr(), cn.data_ptr(), B, d, kc,
                    w, vals.data_ptr(), cells.data_ptr(),
                    _build.stream_ptr(q32.device))
    qn = torch.sum(q32 * q32, dim=1, keepdim=True)
    return cells, torch.clamp_min(vals + qn, 0.0)
