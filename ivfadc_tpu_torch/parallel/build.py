"""Distributed end-to-end build: the flat posting arrays never exist on one
device (port of `ivfadc_tpu/parallel/build.py`).

The points are padded to n_pad = round_up(n, n_dev) and split data-major
over the mesh's n_dev = D * S positions; a row's global id is its flat
padded position. Then, as plain functions on tensors:

  A. coarse k-means over every position (`distributed_kmeans`, both axes);
  B1. PQ training on a residual sample of min(n, _PQ_TRAIN_AUTOCAP) rows,
      once, on position 0's rank, and broadcast;
  B2. per position: blocked assignment, encode, the cell histogram;
  C. the per-shard CSR layout on the host from the (kc,) histogram (cell
     c -> shard c % S; owner-only capacity with `cell_slack`; 128-row
     alignment up to kc = 16384, else 8; `scan_chunk + 128` guard rows);
  D. every row routed to its owner shard and scattered by its slot: the
     cell's offset in the shard + the rows of that cell on earlier
     positions (a prefix of the gathered histograms) + the row's stable
     rank among its cell's rows on its own position. The slot fixes where
     a row lands, so the scatter's order changes nothing;
  E. the decoded caches and norms, shard by shard, through the sharded
     view's own `_make_view` (a row's norm is then the single card's).

Wide ids: past `device_id_cap()` the shards' id arrays hold slot indices
and the host builds the slot -> id translation (the host holds the ids
whole, so the JAX package's int32 limbs are not needed). Under a process
group this raises, as in the JAX package.

`train_components` (A, B1) and `shard_payload` (B2-E) split the build so
each half can be driven alone; `build_distributed_parts` runs both.
"""

from __future__ import annotations

import numpy as np
import torch

from ivfadc_tpu_torch.config import device_id_cap
from ivfadc_tpu_torch.ops import pq as pq_ops
from ivfadc_tpu_torch.ops.kmeans import make_generator
from ivfadc_tpu_torch.ops.metrics import get_metric
from ivfadc_tpu_torch.parallel import distributed as dist_ops
from ivfadc_tpu_torch.parallel.collectives import Collectives
from ivfadc_tpu_torch.parallel.mesh import DATA_AXIS, SHARD_AXIS, canonical
from ivfadc_tpu_torch.parallel.sharded import WIDE_NO_ID
from ivfadc_tpu_torch.utils.profiling import BuildTimer

_LANE = 128
BOTH_AXES = (DATA_AXIS, SHARD_AXIS)
# rows a block of the sample's coarse assignment (B1)
_ASSIGN_BLOCK = 65536


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _layout(counts: np.ndarray, S: int, config):
    """Stage C: (offsets_per, sizes_per, caps_per (S, kc) i64, align,
    cap_shard, cap_pad) from the global histogram, as the JAX package's
    host layout (an owned cell of size 0 takes no rows)."""
    kc = config.kc
    align = 128 if kc <= 16384 else 8
    cells = np.arange(kc)
    owners = cells % S
    sizes_per = np.zeros((S, kc), np.int64)
    sizes_per[owners, cells] = counts
    slack_rows = np.ceil(sizes_per * (config.cell_slack - 1.0)).astype(
        np.int64)
    caps_per = np.where(
        sizes_per > 0,
        np.maximum(align, _round_up(sizes_per + slack_rows + 8, align)), 0)
    offsets_per = np.zeros((S, kc), np.int64)
    np.cumsum(caps_per[:, :-1], axis=1, out=offsets_per[:, 1:])
    cap_shard = _round_up(
        int((offsets_per[:, -1] + caps_per[:, -1]).max()), _LANE)
    guard = config.scan_chunk + _LANE
    cap_pad = _round_up(cap_shard + guard, _LANE)
    return offsets_per, sizes_per, caps_per, align, cap_shard, cap_pad


def global_layout(counts: np.ndarray, config, align: int) -> dict:
    """The single-store layout of the same histogram, for the payload-free
    base index (every cell at least `align` rows)."""
    g_slack = np.ceil(counts * (config.cell_slack - 1.0)).astype(np.int64)
    g_caps = np.maximum(align, _round_up(counts + g_slack + 8, align))
    g_offsets = np.zeros(config.kc, np.int64)
    np.cumsum(g_caps[:-1], out=g_offsets[1:])
    return dict(offsets=g_offsets, caps=g_caps, sizes=counts)


def train_components(data, mesh, config, timer=None) -> dict:
    """Stages A and B1: pad and split the points over the positions, run
    the distributed coarse k-means, then train the quantizer on a residual
    sample on position 0's rank and broadcast it. Returns the trained
    state `shard_payload` takes."""
    timer = timer or BuildTimer()
    cmetric = get_metric(config.coarse_metric)
    qmetric = get_metric(config.quantization_metric)
    col = Collectives(mesh, BOTH_AXES)
    if isinstance(data, torch.Tensor):
        data = data.to(torch.float32)
    else:
        data = np.ascontiguousarray(np.asarray(data, np.float32))
    n, d = data.shape
    config.validate_for_data(n, d, sharded=True)
    wide = n > device_id_cap()
    if wide and mesh.multi_process:
        raise NotImplementedError(
            "wide-id distributed builds are single-process: the host's "
            "slot -> id translation would need a per-process exchange "
            "under a process group")
    parts, masks, nl, _ = dist_ops._split(col, data, None)
    with timer.phase("coarse_kmeans"):
        centers, _ = dist_ops.distributed_kmeans(
            config.seed, parts, config.kc, mesh,
            maxiter=config.coarse_maxiter, metric=cmetric, mask=masks,
            n_valid=n, axes=BOTH_AXES)
        centers = torch.as_tensor(centers).to(col.home, torch.float32)
    with timer.phase("train_quantizer"):
        from ivfadc_tpu_torch.models.index import _PQ_TRAIN_AUTOCAP
        from ivfadc_tpu_torch.utils.datasets import sample_indices
        qs = config.quantization_sample or min(n, _PQ_TRAIN_AUTOCAP)
        qs = min(qs, n)
        sel = sample_indices(config.seed, n, qs)
        quant = None
        if 0 in col.local:
            dev0 = col.devices[0]
            sample = (data[torch.as_tensor(sel, device=data.device)]
                      if isinstance(data, torch.Tensor)
                      else torch.as_tensor(data[sel])).to(dev0)
            c0 = centers.to(dev0)
            s_cells = dist_ops._argmin_blocks(sample, c0, cmetric,
                                              _ASSIGN_BLOCK)
            s_resid = sample - c0[s_cells]
            del sample
            quant = pq_ops.train_quantizer(
                config.seed, s_resid, m=config.m, k=config.k,
                method=config.quantization_method,
                maxiter=config.quantization_maxiter, metric=qmetric,
                opq_iters=config.opq_iters, block=config.kmeans_block)
            del s_resid
        codebooks = col.broadcast(None if quant is None
                                  else quant.codebooks, 0)
        rotation = col.broadcast(None if quant is None
                                 else quant.rotation, 0)
        quantizer = pq_ops.ProductQuantizer(
            codebooks, rotation,
            quant.method if quant is not None else config.quantization_method)
    return dict(col=col, parts=parts, n=n, d=d, nl=nl, wide=wide,
                centers=centers, quantizer=quantizer, cmetric=cmetric,
                qmetric=qmetric)


def shard_payload(trained: dict, mesh, config, timer=None):
    """Stages B2-D: assign and encode every position's rows, lay out the
    shards from the summed histogram, route each row to its owner shard
    and scatter it by its slot. Returns (parts for the sharded view's
    `_wire`, the global layout for the payload-free base)."""
    timer = timer or BuildTimer()
    col: Collectives = trained["col"]
    parts, n, nl = trained["parts"], trained["n"], trained["nl"]
    cmetric, qmetric = trained["cmetric"], trained["qmetric"]
    kc, S = config.kc, mesh.shape[SHARD_AXIS]
    wide = trained["wide"]
    n_dev = len(col)
    block = min(8192, nl)
    cells, codes, hist = [None] * n_dev, [None] * n_dev, [None] * n_dev
    with timer.phase("assign_encode"):
        for i in col.local:
            dev = col.devices[i]
            nv = max(0, min(nl, n - i * nl))
            x = parts[i][:nv]
            c = trained["centers"].to(dev)
            q = pq_ops.ProductQuantizer(trained["quantizer"].codebooks.to(dev),
                                        trained["quantizer"].rotation.to(dev),
                                        trained["quantizer"].method)
            a = dist_ops._argmin_blocks(x, c, cmetric, block)
            codes[i] = pq_ops.encode(q, x - c[a], metric=qmetric)
            cells[i] = a
            hist[i] = torch.bincount(a, minlength=kc)
            parts[i] = None                     # the points are done with
    with timer.phase("layout"):
        per_pos = torch.stack(col.gather(hist)).cpu().numpy().astype(
            np.int64)                                    # (n_dev, kc)
        counts = per_pos.sum(axis=0)
        offsets_per, sizes_per, caps_per, align, cap_shard, cap_pad = \
            _layout(counts, S, config)
        prefix = np.cumsum(per_pos, axis=0) - per_pos    # exclusive
    with timer.phase("redistribute"):
        payloads, dests = [None] * n_dev, [None] * n_dev
        for i in col.local:
            dev = col.devices[i]
            a = cells[i]
            nv = a.shape[0]
            order = torch.argsort(a, stable=True)
            lc = torch.as_tensor(per_pos[i], device=dev)
            starts = torch.cumsum(lc, 0) - lc
            within = torch.arange(nv, device=dev) - starts[a[order]]
            rank = torch.empty_like(within)
            rank[order] = within
            owner = a % S
            slot = (torch.as_tensor(offsets_per, device=dev)[owner, a]
                    + torch.as_tensor(prefix[i], device=dev)[a] + rank)
            gid = i * nl + torch.arange(nv, device=dev, dtype=torch.int64)
            payloads[i] = torch.cat([
                codes[i].contiguous().view(torch.uint8).reshape(nv, -1),
                slot.contiguous().view(torch.uint8).reshape(nv, 8),
                gid.view(torch.uint8).reshape(nv, 8)], dim=1)
            dests[i] = owner
            cells[i] = codes[i] = None
        wanted = {r: sorted({s for g in range(mesh.shape[DATA_AXIS])
                             for s in range(S) if mesh.owners[g, s] == r})
                  for r in range(mesh.process_count)}
        rows = col.exchange(payloads, dests, wanted)
        del payloads, dests
        code_dt = pq_ops._torch_code_dtype(config.k)
        cw = config.m * torch.tensor([], dtype=code_dt).element_size()
        pq_codes, ids = [None] * S, [None] * S
        trans = np.full((S, cap_pad), WIDE_NO_ID, np.uint64) if wide \
            else None
        for s, r in rows.items():
            dev = next(canonical(mesh.devices[g, s])
                       for g in range(mesh.shape[DATA_AXIS])
                       if mesh.is_local(g, s))
            r = r.to(dev)
            c_rows = r[:, :cw].contiguous().view(code_dt).reshape(
                -1, config.m)
            slot = r[:, cw:cw + 8].contiguous().view(torch.int64).reshape(-1)
            gid = r[:, cw + 8:].contiguous().view(torch.int64).reshape(-1)
            blk = torch.zeros((cap_pad, config.m), dtype=code_dt, device=dev)
            blk[slot] = c_rows
            idb = torch.full((cap_pad,), -1, dtype=torch.int32, device=dev)
            if wide:
                idb[slot] = slot.to(torch.int32)
                trans[s, slot.cpu().numpy()] = \
                    gid.cpu().numpy().astype(np.uint64)
            else:
                idb[slot] = gid.to(torch.int32)
            pq_codes[s], ids[s] = blk, idb
    out = dict(offsets=offsets_per.astype(np.int32),
               sizes=sizes_per.astype(np.int32),
               pq_codes=pq_codes, ids=ids,
               window=_round_up(max(1, int(sizes_per.max())), _LANE),
               align=align, max_cap=int(caps_per.max(initial=0)),
               cap_shard=cap_shard, cap_pad=cap_pad)
    if trans is not None:
        out["trans"] = trans
    return out, global_layout(counts, config, align)


def make_coarse(config, centers: torch.Tensor, col: Collectives):
    """The coarse quantizer over the trained centres. A two-level one
    clusters them once, on position 0's rank (its generator's stream, on
    the device of position 0, every rank's first device there), and the
    grouping is broadcast."""
    from ivfadc_tpu_torch.models.coarse import (TwoLevelCoarseQuantizer,
                                                make_coarse_quantizer)
    from ivfadc_tpu_torch.models.index import _STREAM_COARSE_GROUPS
    cmetric = get_metric(config.coarse_metric)

    def build():
        return make_coarse_quantizer(
            config.coarse_quantizer, centers.to(col.home), cmetric,
            generator=make_generator(config.seed, _STREAM_COARSE_GROUPS,
                                     col.home),
            n_groups=config.coarse_n_groups,
            n_probe_groups=config.coarse_probe_groups)

    if not col.multi or config.coarse_quantizer == "naive":
        return build()
    cq = build() if 0 in col.local else None
    grouping = col.broadcast_object(
        None if cq is None else (cq.group_centers.cpu().numpy(),
                                 cq.members.cpu().numpy(),
                                 int(cq.n_probe_groups)), col.owners[0])
    if cq is not None:
        return cq
    return TwoLevelCoarseQuantizer.create(
        centers.cpu().numpy(), grouping[0], grouping[1], cmetric,
        grouping[2], device=col.home)


def build_distributed_parts(data, mesh, config, timer=None):
    """The whole pipeline -> (parts, coarse, quantizer, global layout)."""
    timer = timer or BuildTimer()
    trained = train_components(data, mesh, config, timer)
    parts, glayout = shard_payload(trained, mesh, config, timer)
    with timer.phase("coarse_quantizer"):
        coarse = make_coarse(config, trained["centers"], trained["col"])
    return parts, coarse, trained["quantizer"], glayout
