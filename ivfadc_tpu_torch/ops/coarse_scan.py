"""Fused coarse probes: exact top-w cells, alone or with the dense scan's
inputs.

Port of `ivfadc_tpu/ops/coarse_scan.py`: `coarse_probe_vbase` (engines v1
and v2) and `coarse_topw`. The CUDA kernels are in `csrc/coarse_scan.cu`;
`coarse_vbase_plain`, `coarse_vbase_v2_plain` and `coarse_topw_plain` are
the same functions as plain tensor code. Scores are exact f32 (the naive
coarse quantizer is contractually the exact brute-force scan). The
per-query `||q||^2` term is rank-constant and added back outside the
kernels, as in the JAX package.

v1 emits v = bf16(-2 rot(q - c)) and ||rot(q - c)||^2 per winner; v2
rebuilds each winner's rotated row from a bf16 hi/lo split of the
pre-rotated table (rotation once per query) and takes the base from the
scores, which holds only for an orthogonal rotation.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ivfadc_tpu_torch import _build
from ivfadc_tpu_torch.utils.profiling import planned

# Fallback engine when a caller omits `engine`, read once at import as the
# JAX package reads it; the index's dispatch sites read
# IVFADC_COARSE_ENGINE per search and pass it explicitly.
_DEFAULT_ENGINE = os.environ.get("IVFADC_COARSE_ENGINE", "v1")

_P, _I = _build.P, _build.I
KERNEL = _build.Kernel("coarse_scan", "coarse_vbase",
                       [_P] * 4 + [_I] * 7 + [_P] * 7)
V2_KERNEL = _build.Kernel("coarse_scan", "coarse_vbase_v2",
                          [_P] * 6 + [_I] * 7 + [_P] * 6)
TOPW_KERNEL = _build.Kernel("coarse_scan", "coarse_topw",
                            [_P] * 3 + [_I] * 6 + [_P] * 5)
_FIT = _build.HostFn("coarse_scan", "coarse_fit", [_I, _I, _I, _I, _P])
_KINDS = {"topw": 0, "vbase": 1, "vbase_v2": 2}
TQS = (4, 1)        # register tiles: tq x 8 sums a thread, 16 * tq queries

# The plan's cost model, in query rows x features at the 64-query tile's
# FMA rate. Its four constants picked the fastest plan (within 0.4 %) at
# each of 17 shapes of an H100 sweep over every (tq, S) at w = 8 (PERF.md),
# where the rule before it (the most splits whose blocks all fit the
# resident slots at once) lost 24-66 % at three of them, GIST's among them.
# RATE: each tile's FMA rate. Beside its d features, each 128-centroid tile
# costs TILE_COST (the scores' offer to the lists); a split SPLIT_COST (its
# lists published, the ticket, the last block's merge). LONE: the rate of
# a SM that runs fewer blocks than it holds (`coarse_fit`'s blocks a SM).
# Under the large-w selection (`coarse_fit`'s `wide`, w > 32) a split's
# lists, the offers that fill them and the last block's merge grow with w,
# and so does its cost: SPLIT_COST w / 8.
RATE = {4: 1.0, 1: 0.55}
TILE_COST = 64
SPLIT_COST = 625
LONE = 0.6


def plan_cost(B: int, bq: int, sms: int, d: int, tq: int, splits: int,
              tps: int, per_sm: int = 2, w: int = 8,
              wide: bool = False) -> float:
    """The model's time of a plan: the rounds of blocks each of `sms` SMs
    runs (ceil(blocks / sms): a last round that fills few SMs costs a
    whole one) times a block's work, bq rows by its tps tiles of
    d + TILE_COST features and the split's cost (w / 8 of it under the
    large-w selection), at the tile's RATE, and LONE of it where a SM runs
    fewer blocks than `per_sm`."""
    blocks = -(-B // bq) * splits
    n = max(1, -(-blocks // sms))
    split = SPLIT_COST * (w / 8 if wide else 1)
    work = tps * (d + TILE_COST) + (split if splits > 1 else 0)
    return n * bq * work / RATE[tq] / (LONE if n < per_sm else 1.0)


def split_plan(B: int, kc: int, bq: int, bc: int, sms: int, d: int = 128,
               tq: int = 4, per_sm: int = 2, w: int = 8,
               wide: bool = False):
    """(S, tiles per split): the kernels' grid is ceil(B / bq) query tiles
    times S splits of the ceil(kc / bc) centroid tiles, S from 1 to one
    tile a split, tiles spread evenly so no split is empty; the least
    `plan_cost` wins, fewer splits on a tie."""
    tiles = -(-kc // bc)
    best = None
    for s in range(1, tiles + 1):
        tps = -(-tiles // s)            # as the kernel spreads the tiles
        if -(-tiles // tps) != s:       # an empty split: the same as fewer
            continue
        cost = plan_cost(B, bq, sms, d, tq, s, tps, per_sm, w, wide)
        if best is None or cost < best[2]:
            best = (s, tps, cost)
    return best[:2]


def choose(B: int, d: int, kc: int, w: int, sms: int, fits: dict) -> dict:
    """The launch plan from what the card reports: `fits` maps each query
    tile tq in TQS whose block fits (for this d, w and kernel kind) to its
    `coarse_fit` dict (bq, bc, smem_bytes, blocks_per_sm, ...). Each tile
    takes its `split_plan` on `sms` SMs and the cheapest plan wins, the
    wider tile on a tie: 64-query tiles where the batch gives them work
    enough to fill the card, 16-query tiles below that (on an H100 up to
    about 4096 queries at d = 128 and 1024 at d = 960: a smaller batch
    spreads over more blocks and wastes fewer rows). `narrow`: the plan
    runs 16-query tiles; `wide` (from the fit) the large-w selection."""
    plans = []
    for tq in TQS:
        fit = fits.get(tq)
        if fit is None:
            continue
        bq, bc, per_sm = fit["bq"], fit["bc"], fit["blocks_per_sm"]
        wide = fit.get("wide", False)
        s, tps = split_plan(B, kc, bq, bc, sms, d, tq, per_sm, w, wide)
        cost = plan_cost(B, bq, sms, d, tq, s, tps, per_sm, w, wide)
        plans.append((cost, -tq, dict(fit, tq=tq, splits=s, wide=wide,
                                      tiles_per_split=tps,
                                      grid=-(-B // bq) * s, sms=sms,
                                      narrow=tq == 1)))
    if not plans:
        raise ValueError(f"the coarse kernels take no d={d}, w={w} here: "
                         f"their shared memory would exceed the card's")
    return min(plans, key=lambda p: p[:2])[2]


@functools.lru_cache(maxsize=None)
def _fit(d: int, w: int, kind: int, tq: int, device_index: int):
    """The fit of query tiles of 16 * tq rows for (d, w) and a kernel kind
    (`coarse_fit`): bq, bc, shared bytes, resident blocks per SM,
    registers and spilled bytes a thread, `resident` (the query tile held
    whole in shared memory, else streamed in slabs), `wide` (the large-w
    selection, w > 32) and its `cap` (candidate places a row, else 0);
    None where they do not fit."""
    out = (ctypes.c_int * 9)()
    with torch.cuda.device(device_index):
        _FIT(d, w, kind, tq, ctypes.addressof(out))
    if out[3] == 0:
        return None
    return dict(bq=out[0], bc=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3], registers=out[4], local_bytes=out[5],
                resident=bool(out[6]), wide=bool(out[7]), cap=out[8])


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def plan(B: int, d: int, kc: int, w: int, kind: str, device) -> dict:
    """The launch plan of a coarse kernel (`kind` "topw", "vbase" or
    "vbase_v2") on a CUDA device: `choose` over the query tiles that fit
    (d, w) on this card, at its SM count. Fields: tq, bq (16 * tq query
    rows a block), bc (centroids a tile), splits and tiles_per_split of the
    table, grid, smem_bytes, blocks_per_sm, registers, local_bytes,
    `resident` (the query tile held whole), `wide` and `cap` (the large-w
    selection and its buffer), sms, `narrow` (16-query tiles)."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return dict(_plan(B, d, kc, w, kind, index))


@functools.lru_cache(maxsize=4096)
def _plan(B: int, d: int, kc: int, w: int, kind: str, index: int) -> dict:
    fits = {tq: _fit(d, w, _KINDS[kind], tq, index) for tq in TQS}
    return choose(B, d, kc, w, _sms(index),
                  {tq: f for tq, f in fits.items() if f is not None})


def _launch_args(B: int, d: int, kc: int, w: int, kind: str, dev):
    """(tq, splits, part, tickets) for a launch; with more than one
    split, the per-split lists (B, S, w) of (score, index) and one zeroed
    ticket a query tile."""
    p = plan(B, d, kc, w, kind, dev)
    if p["narrow"]:
        planned("probe_narrow_launches")
    if p["wide"]:
        planned("probe_wide_select_launches")
    if p["splits"] == 1:
        return p["tq"], 1, None, None
    part = torch.empty((B, p["splits"], w, 2), dtype=torch.int32,
                       device=dev)
    tickets = torch.zeros(-(-B // p["bq"]), dtype=torch.int32, device=dev)
    return p["tq"], p["splits"], part, tickets


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


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
    tq, splits, part, tickets = _launch_args(B, d, kc, w, "vbase", dev)
    KERNEL(*(t.data_ptr() for t in args), B, d, kc, w, int(apply_rot), tq,
           splits, _ptr(part), _ptr(tickets), vals.data_ptr(),
           cells.data_ptr(), v.data_ptr(), rn.data_ptr(),
           _build.stream_ptr(dev))
    return vals, cells, v, rn


def coarse_vbase_v2_plain(q32, c32, cn, rot, hi, lo, w: int,
                          apply_rot: bool):
    """Plain version of the v2 kernel -> (vals (B,w) f32 scores without
    ||q||^2, cells (B,w) i32, v (B,w,d) bf16): the v1 selection, then
    v = bf16(-2 (rotq - (f32(hi) + f32(lo)))) per winner."""
    B = q32.shape[0]
    scores = cn[None, :] - 2.0 * (q32 @ c32.T)
    rows = torch.arange(B, device=q32.device)
    rotq = q32 @ rot if apply_rot else q32
    hl = hi.to(torch.float32) + lo.to(torch.float32)
    vals, cells, vs = [], [], []
    for _ in range(w):
        a = torch.argmin(scores, dim=1)          # first index of the minimum
        vals.append(scores[rows, a])
        cells.append(a.to(torch.int32))
        vs.append((-2.0 * (rotq - hl[a])).to(torch.bfloat16))
        scores[rows, a] = float("inf")
    return torch.stack(vals, 1), torch.stack(cells, 1), torch.stack(vs, 1)


def coarse_vbase_v2(q32, c32, cn, rot, hi, lo, w: int, apply_rot: bool):
    """The v2 kernel's wrapper: CPU tensors run the plain version, CUDA
    tensors launch the kernel."""
    if q32.device.type == "cpu":
        return coarse_vbase_v2_plain(q32, c32, cn, rot, hi, lo, w, apply_rot)
    B, d = q32.shape
    kc = c32.shape[0]
    dev = q32.device
    args = [t.to(torch.float32).contiguous() for t in (q32, c32, cn, rot)]
    args += [t.to(torch.bfloat16).contiguous() for t in (hi, lo)]
    if any(t.device != dev for t in args):
        raise ValueError("coarse_vbase_v2 inputs must be on one device")
    vals = torch.empty((B, w), dtype=torch.float32, device=dev)
    cells = torch.empty((B, w), dtype=torch.int32, device=dev)
    v = torch.empty((B, w, d), dtype=torch.bfloat16, device=dev)
    tq, splits, part, tickets = _launch_args(B, d, kc, w, "vbase_v2", dev)
    V2_KERNEL(*(t.data_ptr() for t in args), B, d, kc, w, int(apply_rot),
              tq, splits, _ptr(part), _ptr(tickets), vals.data_ptr(),
              cells.data_ptr(), v.data_ptr(), _build.stream_ptr(dev))
    return vals, cells, v


def hi_lo_split(c32, rot, apply_rot: bool):
    """The v2 engine's pre-rotated table rotC = C R (C itself without a
    rotation) as bf16 hi = bf16(rotC) and lo = bf16(rotC - f32(hi)). The
    product runs in float64 and is rounded to f32 once, so no TF32 setting
    can reach it."""
    rot_c = (c32.to(torch.float64) @ rot.to(torch.float64)).to(torch.float32) \
        if apply_rot else c32
    hi = rot_c.to(torch.bfloat16)
    lo = (rot_c - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def coarse_probe_vbase(queries, centroids, w: int, rotation,
                       apply_rot: bool, include_base: bool, *,
                       engine: str | None = None,
                       rot_orthogonal: bool = False):
    """Fused coarse probe + scan-input construction (squared-euclidean).

    Returns (cells (B,w) i32, cdists (B,w) f32, v (B,w,d) bf16,
    base (B,w) f32), v = -2 * rot(q - c), base = |rot(q - c)|^2 (+ cdist
    when include_base). `engine` "v1" or "v2" (default: IVFADC_COARSE_ENGINE
    at import). v2 takes |rot(q - c)|^2 = cdist, true only for an isometry:
    a caller declares that with `rot_orthogonal=True` (the PQ identity and
    the OPQ Procrustes solution are), else a v2 request under a rotation
    runs v1, as in the JAX package.

    Unlike the JAX wrapper it never returns None: the kernels stream the
    centroid table in tiles and take every kc. The JAX wrapper returns
    None where its tables outgrow its VMEM budget (v2 at d = 128 from about
    kc = 7900 up, e.g. kc = 8192; v1 from twice that) and its callers then
    run the unfused probe, which picks the same exact top-w cells."""
    if engine is None:
        engine = _DEFAULT_ENGINE
    if engine not in ("v1", "v2"):
        raise ValueError(f"coarse engine must be 'v1' or 'v2', got "
                         f"{engine!r}")
    if engine == "v2" and apply_rot and not rot_orthogonal:
        engine = "v1"
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
    if engine == "v2":
        hi, lo = hi_lo_split(c32, rot, apply_rot)
        vals, cells, v = coarse_vbase_v2(q32, c32, cn, rot, hi, lo, w,
                                         apply_rot)
        cdists = torch.clamp_min(vals + qn, 0.0)
        # |rot(q - c)|^2 == |q - c|^2 == cdists for an orthogonal rotation
        return cells, cdists, v, cdists + cdists if include_base else cdists
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
    streams the centroid table in tiles and takes every kc. CPU tensors
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
        tq, splits, part, tickets = _launch_args(B, d, kc, w, "topw",
                                                 q32.device)
        TOPW_KERNEL(q32.data_ptr(), c32.data_ptr(), cn.data_ptr(), B, d, kc,
                    w, tq, splits, _ptr(part), _ptr(tickets),
                    vals.data_ptr(), cells.data_ptr(),
                    _build.stream_ptr(q32.device))
    qn = torch.sum(q32 * q32, dim=1, keepdim=True)
    return cells, torch.clamp_min(vals + qn, 0.0)
