"""Readings behind the limits of a cell's comparison: the program's
numbers and the control's, seed by seed, in one process.

    python3 annbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 2]

For each seed it builds the index as a run does, drives the cell's
traffic for a short window at the cell's own load, and prints the
comparison's numbers of the program's answers (`"who": "program"`). For
each control seed it then puts the reference in the program's place,
computed one step below the precision the configuration states
(bfloat16 for float32, int4 tables for int8: `reference/ivfadc.py`
CONTROL), answers the same sampled queries with it, and prints the same
numbers (`"who": "control"`; it trains nothing, so it has no training
numbers). Where the traffic mutates the index, the control holds every
point ever pushed and answers each sampled query over the points live at
that answer's version, with its ids as positions there
(`reference/replay.py`). The training numbers have their own controls,
the reference's training with the configuration's stated iteration
counts (25 Lloyd iterations of the coarse k-means and of each PQ
subspace's) broken, in the program's place (`"who": "fault:<name>"`, see
FAULTS), and the reference trained again from another generator stream,
a sound stand-in (`"who": "reference_again"`). A sound comparison reads the program within
every limit and the control, and each fault, beyond at least one. The
benchmark's own runs never run this.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from annbench import datagen, harness, specs  # noqa: E402
from annbench.reference import compare, train  # noqa: E402
from annbench.reference import ivfadc as ref  # noqa: E402
from annbench.reference.replay import Replay  # noqa: E402
from annbench.window import Window  # noqa: E402


# training faults: (coarse Lloyd iterations, PQ Lloyd iterations) in
# place of the configuration's 25 and 25
FAULTS = {"kmeans_one_lloyd": (1, None), "pq_one_lloyd": (None, 1),
          "seeds_only": (0, 0)}
STREAM_FAULTS = 100           # their generators: streams 100, 101, ...


def readings(cell_name: str, seed: int, seconds: float, control: bool, *,
             device=None, overrides=None) -> list:
    """[(who, numbers)] of one seed: the program's, and with `control`
    the control's on the same sampled queries, the training faults' and
    the reference's trained again."""
    dev = torch.device(device or "cuda")
    _, cfg, traffic, check = harness.load(cell_name, overrides)
    index, queries, qh, n, _, _ = harness.build(cfg, traffic, seed, dev)
    ctx = harness.Ctx(index, queries, qh, traffic, seed, cfg["data"])
    drv = specs.driver(traffic["driver"])
    drv.warm(ctx)
    win = drv.run(ctx, seconds)
    rng = np.random.default_rng(seed)
    keep = rng.choice(len(win.answers),
                      min(check["answers"], len(win.answers)), replace=False)
    win.answers = [win.answers[i] for i in sorted(keep)]
    trained = harness.trained_of(index)
    end = Replay(n, win.mutations).at_end()
    given, held = harness.stored_of(index, end.n_all, dev, end.table)
    del ctx, index
    harness.free_memory(dev)
    out = []
    numbers, _, _ = harness.judge(cfg, traffic, check, seed, dev, queries,
                                  trained, given, held, win, False)
    out.append(("program", numbers))
    if control:
        x = harness.points_of(cfg, seed, end, dev)
        cgiven = ref.build(x, trained, ref.CONTROL)
        del x
        lists = ref.Lists(cgiven, trained.centroids.shape[0])
        walk = Replay(n, win.mutations)
        answers = []
        for v in sorted({a[3] for a in win.answers}):
            walk.advance(v)
            pool = [a[0] for a in win.answers if a[3] == v]
            q = queries[torch.as_tensor(pool, device=dev)]
            cells, cd = ref.probe(q, trained, traffic["w"], ref.CONTROL)
            ids, dists = ref.search(
                q, cells, cd, cgiven, lists, trained, traffic["k"],
                ref.CONTROL, walk.live if win.mutations else None)
            ids = walk.positions(ids)
            answers += [(p, ids[i], dists[i].astype(np.float32), v)
                        for i, p in enumerate(pool)]
        cwin = Window(attempted=len(answers), failed=0,
                      completed=len(answers), elapsed_s=1.0,
                      answers=answers, mutations=win.mutations)
        numbers, _, _ = harness.judge(cfg, traffic, check, seed, dev,
                                      queries, trained, cgiven,
                                      np.arange(end.table.size), cwin,
                                      False)
        out.append(("control", {k: v for k, v in numbers.items()
                                if k not in compare.TRAINING}))
        base = datagen.clustered(cfg["data"]["n"], cfg["data"]["d"],
                                 cfg["data"]["n_clusters"],
                                 cfg["data"]["noise"], seed, dev)
        mine = train.train(base, cfg["index"],
                           harness.train_generator(seed, dev))
        who = [(f"fault:{f}", it) for f, it in FAULTS.items()]
        for i, (name, iters) in enumerate(who + [("reference_again",
                                                   (None, None))]):
            g = harness.train_generator(seed, dev, STREAM_FAULTS + i)
            tables = train.train(base, cfg["index"], g, *iters)
            out.append((name, compare.train_numbers(base, tables, mine)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 1
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    seeds = [int(s) for s in a.seeds.split(",")]
    seeds += sorted(ctl - set(seeds))
    for seed in seeds:
        t0 = time.perf_counter()
        for who, numbers in readings(a.workload, seed, a.seconds,
                                     seed in ctl):
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "who": who, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
