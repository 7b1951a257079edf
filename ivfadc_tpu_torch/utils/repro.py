"""Is a build reproducible from one process to the next?

    python -m ivfadc_tpu_torch.utils.repro --n 1000000 --d 128 --kc 1024 \
        --m 8 --runs 3

builds the same index (synthetic data from a seed, one build seed) in
`--runs` separate processes, each recording a digest after every stage of
the build (seeding, each Lloyd iteration, PQ training, encoding, the
finished index), and names the first stage whose digests differ. It prints
one JSON object and exits 0 when all processes agree, 1 when they differ.

`traced_build` is the one-process part: it wraps the build's stage
functions with digest recorders for the length of one `IVFADCIndex.build`,
so the stages are those of the real build and not a copy of it.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch


def digest(*parts) -> str:
    """12 hex digits of a SHA-1 over the bytes of tensors / arrays."""
    h = hashlib.sha1()
    for p in parts:
        if isinstance(p, torch.Tensor):
            p = p.detach().cpu().numpy()
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()[:12]


def index_digest(index) -> str:
    """Digest of a built index's parameters: two builds that print the same
    digest are the same index bit for bit."""
    return digest(index.coarse.centroids, index.quantizer.codebooks,
                  index.store.codes, index.store.ids)


@contextlib.contextmanager
def _recording(module, name: str, stages: list, pick=lambda out: out):
    """Record a digest of `pick(result)` after every call of module.name."""
    fn = getattr(module, name)
    count = [0]

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        stages.append((f"{name}[{count[0]}]", digest(pick(out))))
        count[0] += 1
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def traced_build(data, device=None, **kwargs):
    """`IVFADCIndex.build(data, device=device, **kwargs)` -> (index, stages):
    stages is the list of (stage name, digest) in build order."""
    from ivfadc_tpu_torch import IVFADCIndex
    from ivfadc_tpu_torch.ops import kmeans as km
    from ivfadc_tpu_torch.ops import pq

    stages: list = []
    with contextlib.ExitStack() as stack:
        for name in ("_kmeans_plus_plus", "_kmeans_parallel",
                     "_lloyd_update"):
            stack.enter_context(_recording(km, name, stages))
        stack.enter_context(_recording(km, "_lloyd", stages,
                                       pick=lambda out: out[1]))
        stack.enter_context(_recording(pq, "encode", stages))
        index = IVFADCIndex.build(data, device=device, **kwargs)
    stages.append(("index", index_digest(index)))
    return index, stages


def _child(args) -> int:
    from ivfadc_tpu_torch.utils.datasets import synthetic_clustered
    data = synthetic_clustered(args.n, args.d, seed=0)
    _, stages = traced_build(
        data, device=args.device, kc=args.kc, m=args.m, k=args.k, seed=0,
        kmeanspp_sample=args.kmeanspp_sample,
        coarse_quantizer=args.coarse_quantizer)
    print(json.dumps(stages))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--kc", type=int, default=1024)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--kmeanspp-sample", type=int, default=65536)
    ap.add_argument("--coarse-quantizer", default="naive")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args)
    argv = list(sys.argv[1:] if argv is None else argv)
    runs = []
    for _ in range(args.runs):
        out = subprocess.run(
            [sys.executable, "-m", "ivfadc_tpu_torch.utils.repro", "--child",
             *argv], capture_output=True, text=True, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    first = None
    for i, stage in enumerate(runs[0]):
        if any(len(r) <= i or r[i] != stage for r in runs[1:]):
            first = stage[0]
            break
    print(json.dumps({
        "runs": args.runs, "stages": len(runs[0]),
        "index_digests": [r[-1][1] for r in runs],
        "reproducible": first is None, "first_differing_stage": first,
        "digests_there": None if first is None else
        [dict(r).get(first) for r in runs]}))
    return 0 if first is None else 1


if __name__ == "__main__":
    sys.exit(main())
