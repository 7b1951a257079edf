"""The port's distributed build, distributed Lloyd steps, native dynamic ops
and multi-process runtime against the JAX package, on the CPU.

Training is replaced in both packages by the same integer components
(integer centroids; half-integer codewords whose last entry, 63.5, makes
the int8 cache's scale exactly 1/2 and is never the nearest: the
`_integer_pair` recipe of tests/test_torch_dynamic.py), and the points and
queries are integer-valued. Every assignment, code and score is then
exact in both packages, so the per-shard arrays and the searches must
agree bit for bit.

The JAX side runs in a fresh child process (`_jax_child`: the JAX package
on 8 virtual CPU devices, as tests/conftest.py sets them up), which
returns the arrays and results to compare; each result is kept for the
rest of the worker. The JAX package's distributed programs are the ones
whose compilation aborts a long-lived process under load (ROADMAP C.2),
so they stay out of the suite's workers. The port's side runs here on
`["cpu"] * n` meshes. The multi-process cases spawn two ranks of a gloo
group on the CPU as subprocesses, which import no JAX, and hold them to a
single-process twin on the same global mesh.
"""

import fcntl
import hashlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from ivfadc_tpu_torch import IVFADCConfig, IVFADCIndex
from ivfadc_tpu_torch.ops import pq as pq_ops
from ivfadc_tpu_torch.ops.metrics import get_metric
from ivfadc_tpu_torch.parallel import (ShardedIVFADCIndex, bootstrap,
                                       make_mesh)
from ivfadc_tpu_torch.parallel import distributed as port_dist
from ivfadc_tpu_torch.parallel.build import shard_payload, train_components

# the suite runs several workers on a few cores, beside the JAX package's
# multi-device CPU tests: keep torch's intra-op pool small
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = [torch.device("cpu")] * 8
N, DIM, KC, M, K = 603, 8, 24, 2, 16
T = 120                      # seconds a spawned rank may take
T_JAX = 600                  # seconds a JAX child may take


def _components(kc=KC, n=N, seed=0):
    """(points, centroids, codebooks): integer points in [0, 16],
    centroids drawn from them, half-integer codewords plus 63.5."""
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 17, (n, DIM)).astype(np.float32)
    cents = data[rng.choice(n, kc, replace=False)]
    cb = rng.randint(-15, 16, (M, K, DIM // M)) / 2
    cb[:, -1, :] = 63.5
    return data, cents, cb.astype(np.float32)


def _queries(seed, n):
    return np.random.RandomState(seed).randint(0, 17, (n, DIM)) \
        .astype(np.float32)


def _patch_training(mp, cents, cb):
    """The port's coarse k-means and PQ training return the given
    components."""
    mp.setattr(port_dist, "distributed_kmeans",
               lambda *a, **kw: (torch.as_tensor(cents), None))
    mp.setattr(pq_ops, "train_quantizer", lambda *a, **kw: pq_ops.
               ProductQuantizer(torch.as_tensor(cb), torch.eye(DIM), "pq"))


# ------------------------------------------------------------ JAX children
_CHILD = {}


def shared_dir():
    """A directory all workers of this pytest-xdist run share (None when
    the run has no workers): JAX children's results are computed once a
    run, not once a worker."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not uid:
        return None
    path = os.path.join(tempfile.gettempdir(), f"ivfadc_jax_{uid}")
    os.makedirs(path, exist_ok=True)
    return path


def _run_child(module, task, kw, out):
    with tempfile.TemporaryDirectory() as tmp:
        arg = os.path.join(tmp, "arg.pkl")
        with open(arg, "wb") as f:
            pickle.dump((module, task, kw), f)
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                             "--xla_cpu_multi_thread_eigen=false")
        code = ("import sys; sys.path.insert(0, %r); "
                "from tests.test_torch_distributed import _child_main; "
                "_child_main()" % REPO)
        p = subprocess.run([sys.executable, "-c", code, arg, out + ".tmp"],
                           env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=T_JAX)
        assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
        os.replace(out + ".tmp", out)


def _jax_child(task: str, module: str = __name__, **kw):
    """`module._jax_<task>(**kw)` run in a fresh Python process on the JAX
    package (JAX_PLATFORMS=cpu, 8 virtual devices, the suite's compile
    cache); its pickled result, computed once a run (the workers share it
    through `shared_dir()`, one computing it under a file lock while the
    others wait) and kept in each worker. A child that fails or outlasts
    T_JAX fails the test."""
    # pytest may import a test file under its bare name
    module = "tests." + module.rsplit(".", 1)[-1]
    key = (module, task, repr(sorted(kw.items())))
    if key not in _CHILD:
        shared = shared_dir()
        with tempfile.TemporaryDirectory() as tmp:
            base = shared or tmp
            out = os.path.join(
                base, hashlib.sha1(repr(key).encode()).hexdigest() + ".pkl")
            with open(out + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(out):
                    _run_child(module, task, kw, out)
            with open(out, "rb") as f:
                _CHILD[key] = pickle.load(f)
    return _CHILD[key]


def _child_main():
    """Entry point of a JAX child: argv = (argument pickle, output). It
    runs at the lowest CPU priority: the suite's JAX sharded tests abort
    when their devices' threads starve (ROADMAP C.2), and a child must
    not be what starves them."""
    os.nice(19)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(REPO, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    import importlib
    with open(sys.argv[1], "rb") as f:
        module, task, kw = pickle.load(f)
    result = getattr(importlib.import_module(module), f"_jax_{task}")(**kw)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(result, f)


def _jax_patch_training(cents, cb):
    """In a child: the JAX package's coarse k-means and PQ training return
    the given components."""
    import jax.numpy as jnp
    import ivfadc_tpu.ops.pq as jax_pq
    import ivfadc_tpu.parallel.distributed as jax_dist
    jax_dist.distributed_kmeans = lambda *a, **kw: (jnp.asarray(cents), None)
    jax_pq.train_quantizer = lambda *a, **kw: jax_pq.ProductQuantizer(
        jnp.asarray(cb), jnp.eye(DIM), "pq")


def _state(view, queries, jax_side: bool) -> dict:
    """What the parity tests compare of a view: the stacked shard arrays,
    the host layout, its scalars, the base's global layout, the wide-id
    translation and a search per query batch (k=10, w=4)."""
    from tests.test_torch_sharded import _jax_arrays, _port_arrays
    # copies: the views mutate their host arrays in place, and a child
    # pickles its states only at the end
    arrays = _jax_arrays(view) if jax_side else _port_arrays(view)
    out = dict(arrays={k: None if v is None else np.array(v)
                       for k, v in arrays.items()})
    for name in ("_h_offsets", "_h_sizes", "_h_caps"):
        out[name] = np.array(getattr(view, name))
    out["scalars"] = (view.window, view.max_cap, view.align, view.pos8,
                      view.wide_ids, len(view.index))
    out["store"] = [np.array(getattr(view.index.store, key))
                    for key in ("offsets", "caps", "sizes")]
    out["trans"] = None if view._trans is None else np.array(view._trans)
    out["search"] = [view.search_padded(_queries(*q), 10, w=4)
                     for q in queries]
    return out


def _native_ops(data):
    """The native-op sequence both packages run: push_batch of 150 copies
    each of two points (their cells outgrow 128 rows: a regrow), a delete,
    push_front, pop, pop_front, reconstruct, push."""
    return [("push_batch", (np.repeat(_queries(10, 2), 150, axis=0),)),
            ("delete", (np.arange(0, N + 300, 7),)),
            ("push_front", (data[3] + 1,)), ("pop", ()), ("pop_front", ()),
            ("reconstruct", (11,)), ("push", (data[5],))]


def _error_cases(view):
    """Exception class names of the error cases, on a fork of `view`."""
    f = view.fork()
    f.delete([5])
    out = []
    for fn in (lambda: f.reconstruct(N - 1),          # ids shifted: gone
               lambda: f.delete([N + 10]),
               lambda: f.push_batch(np.zeros((2, DIM + 1), np.float32)),
               lambda: f.push(np.zeros(DIM + 1, np.float32))):
        try:
            fn()
            out.append(None)
        except (KeyError, IndexError, AssertionError) as e:
            out.append(type(e).__name__)
    return out


def _config_kw(kc, cfg):
    return dict(kc=kc, m=M, k=K, seed=0, **dict(cfg))


def _jax_build(S, D, kc, n, cfg, queries, ops=False, cap=0):
    """In a child: the JAX package's distributed build on the integer
    components; its state, then (ops) its state after each native op of
    `_native_ops` with the op's result, its error cases and its
    memory_stats."""
    from ivfadc_tpu.config import IVFADCConfig as JaxConfig
    from ivfadc_tpu.parallel.mesh import make_mesh as jax_mesh
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex as JaxSharded
    if cap:
        os.environ["IVFADC_DEVICE_ID_CAP"] = str(cap)
    data, cents, cb = _components(kc, n)
    _jax_patch_training(cents, cb)
    js = JaxSharded.build(data, jax_mesh(n_shards=S, n_data=D),
                          JaxConfig(**_config_kw(kc, cfg)))
    out = dict(states=[_state(js, queries, True)], rets=[None])
    if ops:
        out["memory_stats"] = js.memory_stats()
        out["errors"] = _error_cases(js)
        fork = js.fork()
        for name, args in _native_ops(data):
            out["rets"].append(getattr(fork, name)(*args))
            out["states"].append(_state(fork, queries, True))
        out["parent"] = _state(js, queries, True)["search"]
    return out


_PORT = {}


def _port_view(S, D, kc=KC, n=N, cfg=(), cap=0):
    """The port's distributed build on the integer components, made once
    per argument set; callers that mutate take forks."""
    key = (S, D, kc, n, cfg, cap)
    if key not in _PORT:
        data, cents, cb = _components(kc, n)
        with pytest.MonkeyPatch.context() as mp:
            _patch_training(mp, cents, cb)
            if cap:
                mp.setenv("IVFADC_DEVICE_ID_CAP", str(cap))
            _PORT[key] = ShardedIVFADCIndex.build(
                data, make_mesh(n_shards=S, n_data=D, devices=CPUS),
                IVFADCConfig(**_config_kw(kc, cfg)))
    return _PORT[key], _components(kc, n)[0]


def _assert_same_state(j: dict, t: dict, search=True):
    for key in ("offsets", "sizes", "ids", "codes", "decoded", "norms"):
        a, b = j["arrays"][key], t["arrays"][key]
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=key)
    for name in ("_h_offsets", "_h_sizes", "_h_caps"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)
    assert t["scalars"] == j["scalars"]
    for a, b in zip(j["store"], t["store"]):
        np.testing.assert_array_equal(b, a)
    assert (j["trans"] is None) == (t["trans"] is None)
    if j["trans"] is not None:
        np.testing.assert_array_equal(t["trans"], j["trans"])
    if search:
        for (ji, jd), (ti, td) in zip(j["search"], t["search"]):
            assert ti.dtype == ji.dtype
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(td, jd)


MODES = {"lut": (("scan_mode", "lut"),),
         "bf16": (("scan_cache", "bf16"), ("scan_mode", "dense")),
         "int8": (("scan_cache", "int8"), ("scan_mode", "dense"))}
# (S, D, mode) of the parity builds; the first two also run the native ops
BUILDS = [(8, 1, "lut"), (4, 2, "bf16"), (1, 1, "int8")]


def _queries_for(D):
    """Query batches of both scan routes: B*w < 4*kc per probe, >= 4*kc
    grouped (seed, rows)."""
    return ((D + 1, 8 * D), (D + 2, 32 * D))


def _jax_build_of(S, D, mode):
    return _jax_child("build", S=S, D=D, kc=KC, n=N, cfg=MODES[mode],
                      queries=_queries_for(D), ops=mode != "int8")


# --------------------------------------------------------- Lloyd steps
def _lloyd_inputs():
    data, cents, _ = _components(kc=40, n=512)
    cents[-1] = 1000.0                      # a cluster no point picks
    mask = np.ones(len(data), np.float32)
    mask[-5:] = 0.0                         # masked rows count nowhere
    return data, cents, mask


def _train_inputs():
    """Each cluster's points in +/- pairs around its integer centre, so
    the new centres, and with them the residuals, stay integers."""
    rng = np.random.RandomState(4)
    cents = rng.randint(0, 9, (40, DIM)).astype(np.float32) * 20
    off = rng.randint(-3, 4, (40, 4, DIM)).astype(np.float32)
    data = (cents[:, None] + np.concatenate([off, -off], 1)).reshape(-1, DIM)
    return data[rng.permutation(len(data))], cents, _components()[2]


LLOYD_MESHES = [(1, 8), (2, 4)]
LLOYD_AXES = [("data",), ("data", "shard")]


def _jax_lloyd():
    """In a child: the JAX package's Lloyd steps and train steps on every
    case of the two tests below."""
    import jax.numpy as jnp
    from ivfadc_tpu.ops.metrics import get_metric as jax_get_metric
    from ivfadc_tpu.parallel.distributed import (distributed_kmeans_step,
                                                 train_step)
    from ivfadc_tpu.parallel.mesh import make_mesh as jax_mesh
    metric = jax_get_metric("sqeuclidean")
    out = {}
    for S, D in LLOYD_MESHES:
        mesh = jax_mesh(n_shards=S, n_data=D)
        data, cents, mask = _lloyd_inputs()
        for axes in LLOYD_AXES:
            c, a = distributed_kmeans_step(
                jnp.asarray(cents), jnp.asarray(data), jnp.asarray(mask),
                mesh=mesh, metric=metric, axes=axes)
            out["step", S, D, axes] = (np.asarray(c), np.asarray(a))
        data, cents, cb = _train_inputs()
        out["train", S, D] = tuple(np.asarray(x) for x in train_step(
            jnp.asarray(cents), jnp.asarray(cb), jnp.asarray(data),
            jnp.ones(len(data), jnp.float32), mesh=mesh, metric=metric, m=M))
    return out


@pytest.mark.parametrize("axes", LLOYD_AXES)
@pytest.mark.parametrize("S,D", LLOYD_MESHES)
def test_kmeans_step_equals_jax(S, D, axes):
    """One summed Lloyd step on integer points and centres: the new
    centres (an empty cluster keeps its old one) and the assignments
    bit-equal to the JAX package's, over the data axis and over both."""
    data, cents, mask = _lloyd_inputs()
    tc, ta = port_dist.distributed_kmeans_step(
        cents, data, mask, mesh=make_mesh(n_shards=S, n_data=D,
                                          devices=CPUS),
        metric=get_metric("sqeuclidean"), axes=axes)
    jc, ja = _jax_child("lloyd")["step", S, D, axes]
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ta.numpy(), ja)
    assert tc[-1, 0] == 1000.0


@pytest.mark.parametrize("S,D", LLOYD_MESHES)
def test_train_step_equals_jax(S, D):
    """The dry-run train step (Lloyd step, residuals, PQ codes): all three
    outputs bit-equal to the JAX package's; the centres stay the integer
    ones (+/- pairs)."""
    data, cents, cb = _train_inputs()
    out = port_dist.train_step(
        cents, cb, data, np.ones(len(data), np.float32),
        mesh=make_mesh(n_shards=S, n_data=D, devices=CPUS),
        metric=get_metric("sqeuclidean"), m=M)
    np.testing.assert_array_equal(out[0].numpy(), cents)
    for t, j in zip(out, _jax_child("lloyd")["train", S, D]):
        np.testing.assert_array_equal(t.numpy(), j)


def test_distributed_kmeans_seeds_whatever_the_layout():
    """Seeded once on position 0's device, the port's k-means starts from
    the same centres on every mesh shape; its Lloyd steps then differ only
    by the rounding of the per-position partial sums."""
    data, _, _ = _components(n=800)
    data = data + np.random.RandomState(1).rand(*data.shape).astype(
        np.float32)
    for maxiter, tol in ((0, 0.0), (4, 1e-5)):
        out = [port_dist.distributed_kmeans(
            5, data, 16, make_mesh(n_shards=S, n_data=D, devices=CPUS),
            maxiter=maxiter, metric=get_metric("sqeuclidean"),
            axes=("data", "shard"))[0] for S, D in ((1, 1), (4, 2), (8, 1))]
        for c in out[1:]:
            np.testing.assert_allclose(c.numpy(), out[0].numpy(), rtol=tol,
                                       atol=tol)


# ------------------------------------------------------------------ build
@pytest.mark.parametrize("S,D,mode", BUILDS)
def test_build_equals_jax(S, D, mode):
    """The whole distributed build on the same integer components: the
    per-shard offsets, sizes, PQ codes, ids, decoded rows and norms, the
    host layout with `_h_caps` recovered from the offsets, the payload-free
    base's global layout, and the searches on both scan routes, bit-equal
    to the JAX package's view."""
    ts, _ = _port_view(S, D, cfg=MODES[mode])
    assert not ts.index.store.has_payload and ts._distributed_build
    assert len(ts.index) == N
    _assert_same_state(_jax_build_of(S, D, mode)["states"][0],
                       _state(ts, _queries_for(D), False))


def test_build_halves_drive_alone():
    """`train_components` then `shard_payload` are the build: their parts
    equal the view's shards, every id once, cell c only on shard c % S."""
    ts, data = _port_view(4, 2, cfg=MODES["bf16"])
    cfg = ts.index.config
    mesh = make_mesh(n_shards=4, n_data=2, devices=CPUS)
    _, cents, cb = _components()
    with pytest.MonkeyPatch.context() as mp:
        _patch_training(mp, cents, cb)
        trained = train_components(data, mesh, cfg)
    np.testing.assert_array_equal(trained["centers"].numpy(), cents)
    parts, glayout = shard_payload(trained, mesh, cfg)
    np.testing.assert_array_equal(glayout["sizes"], ts.index.store.sizes)
    ids = torch.stack(parts["ids"]).numpy()
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]), np.arange(N))
    for s in range(4):
        assert torch.equal(parts["ids"][s], ts.views[s]["ids"])
        assert torch.equal(parts["pq_codes"][s], ts.views[s]["codes"])
        assert (parts["sizes"][s][np.arange(KC) % 4 != s] == 0).all()


def test_payload_free_base():
    """The distributed view's base store is metadata-only, as the JAX
    package's: codes / ids raise, its length comes from the sizes, and
    fork, memory_stats (the JAX keys and counts) and repr work without a
    payload."""
    ts, _ = _port_view(4, 2, cfg=MODES["bf16"])
    st = ts.index.store
    assert not st.has_payload and "[metadata-only]" in repr(st)
    for name in ("codes", "ids"):
        with pytest.raises(RuntimeError):
            getattr(st, name)
    assert len(ts.index) == int(st.sizes.sum()) == N
    fork = ts.index.fork()
    assert not fork.store.has_payload and len(fork) == N
    a, b = _jax_build_of(4, 2, "bf16")["memory_stats"], ts.memory_stats()
    assert a.keys() == b.keys()
    for key in ("n", "capacity_slots", "cells", "n_shards"):
        assert a[key] == b[key], key


def test_wide_id_build_equals_jax():
    """Past a lowered device id cap (512 < N) the shards hold slot indices
    and the host translation equals the JAX package's `trans`; searches
    return the same uint64 ids."""
    cfg = (("index_dtype", "uint64"),) + MODES["bf16"]
    ts, _ = _port_view(4, 2, cfg=cfg, cap=512)
    assert ts.wide_ids
    j = _jax_child("build", S=4, D=2, kc=KC, n=N, cfg=cfg,
                   queries=((3, 16),), cap=512)
    _assert_same_state(j["states"][0], _state(ts, ((3, 16),), False))


def test_native_push_upgrades_to_wide_ids(monkeypatch):
    """A value-mode distributed view crossing a lowered device id cap on a
    native push_batch switches to wide ids: its uint64 ids and distances
    equal an uncapped twin's, and native deletes keep them so."""
    t0, _ = _port_view(4, 2, cfg=MODES["bf16"])
    twin, capped = t0.fork(), t0.fork()
    push = _queries(14, 64)
    twin.push_batch(push)
    twin.delete([3, N + 5])
    monkeypatch.setenv("IVFADC_DEVICE_ID_CAP", str(N + 10))
    assert not capped.wide_ids
    capped.push_batch(push)
    assert capped.wide_ids and len(capped.index) == N + 64
    capped.delete([3, N + 5])
    q = _queries(15, 32)
    ci, cd = capped.search_padded(q, 10, w=4)
    ti, td = twin.search_padded(q, 10, w=4)
    assert ci.dtype == np.uint64
    np.testing.assert_array_equal(ci, ti.astype(np.uint64))
    np.testing.assert_array_equal(cd, td)
    np.testing.assert_allclose(capped.reconstruct(N + 20),
                               twin.reconstruct(N + 20))


def test_large_kc_zero_extent_cells_equal_jax():
    """kc = 4096 over 8 shards: the cells a shard does not own (and empty
    ones) take no rows, so a shard's width stays within its live cells'
    128-row blocks plus the guard; the arrays equal the JAX package's (no
    search: the JAX package's at this kc takes ~50 s in interpret mode)."""
    ts, _ = _port_view(8, 1, kc=4096, n=8192, cfg=MODES["lut"])
    sizes = np.stack([v["sizes"].numpy() for v in ts.views])
    width = ts.views[0]["ids"].shape[0]
    assert width <= int((sizes > 0).sum(axis=1).max()) * 128 + 4096
    assert width < 4096 * 128 // 4
    j = _jax_child("build", S=8, D=1, kc=4096, n=8192, cfg=MODES["lut"],
                   queries=())
    _assert_same_state(j["states"][0], _state(ts, (), False))


def test_two_level_build_equals_its_consolidation(tmp_path):
    """A small two-level ("hnsw") distributed build: its searches equal
    those of the plain index consolidated from its own directory, bit for
    bit, and a push lands at rank 0 of its own query."""
    from ivfadc_tpu_torch.parallel import (consolidate_sharded_index,
                                           save_sharded_index)
    data, _, _ = _components(n=2048)
    ts = ShardedIVFADCIndex.build(
        data, make_mesh(n_shards=4, devices=CPUS), kc=64, m=M, k=K,
        coarse_quantizer="hnsw", coarse_n_groups=8, scan_mode="dense",
        scan_cache="bf16", seed=0)
    assert ts.index.coarse.kind == "two_level"
    save_sharded_index(str(tmp_path / "d"), ts)
    plain = consolidate_sharded_index(str(tmp_path / "d"), device="cpu")
    q = _queries(4, 64)
    for B in (8, 64):
        a, b = ts.search_padded(q[:B], 10, w=8), plain.search_padded(
            q[:B], 10, w=8)
        np.testing.assert_array_equal(a[1], b[1])
    ts.push(q[0] + 0.25)
    assert ts.search_padded(q[:1] + 0.25, 1, w=8)[0][0, 0] == len(data)


def test_recall_parity_with_single_build():
    """The port's distributed training reaches its single build's recall
    on clustered data (the JAX package's parity test)."""
    rng = np.random.RandomState(7)
    centers = rng.randn(12, 16).astype(np.float32) * 5
    data = np.concatenate([c + rng.randn(250, 16).astype(np.float32)
                           for c in centers])
    rng = np.random.RandomState(2)
    queries = data[rng.choice(len(data), 32, replace=False)] \
        + 0.05 * rng.randn(32, 16).astype(np.float32)
    gt = np.argsort(((queries[:, None] - data[None]) ** 2).sum(-1),
                    axis=1)[:, :10]

    def recall(ids):
        return np.mean([len(set(a[a >= 0]) & set(g)) / 10
                        for a, g in zip(ids, gt)])

    sidx = ShardedIVFADCIndex.build(
        data, make_mesh(n_shards=4, n_data=2, devices=CPUS), kc=24, k=32,
        m=4, seed=0)
    single = IVFADCIndex.build(data, kc=24, k=32, m=4, seed=0, device="cpu")
    r_s = recall(sidx.search_padded(queries, 10, w=8)[0])
    r_1 = recall(single.search_padded(queries, 10, w=8)[0])
    assert r_s >= r_1 - 0.05, (r_s, r_1)


# ------------------------------------------------------------- native ops
@pytest.mark.parametrize("S,D,mode", BUILDS[:2])
def test_native_ops_equal_jax(S, D, mode):
    """Native dynamic ops of payload-free views, op by op against the JAX
    package's: push_batch with a regrow, a delete, push_front, pop,
    pop_front, reconstruct, push. After each, every shard array, the host
    layout and the searches are bit-equal, and what the op returns agrees;
    the parents are untouched."""
    j = _jax_build_of(S, D, mode)
    t0, data = _port_view(S, D, cfg=MODES[mode])
    ts = t0.fork()
    queries = _queries_for(D)
    before = _state(t0, queries, False)["search"]
    caps = ts._h_caps.copy()
    for step, (name, args) in enumerate(_native_ops(data), start=1):
        ret = getattr(ts, name)(*args)
        if j["rets"][step] is not None:
            np.testing.assert_allclose(ret, j["rets"][step], rtol=1e-6,
                                       atol=1e-6)
        if name == "push_batch":
            assert (ts._h_caps != caps).any(), "no regrow"
        assert ts._last_refresh == "native"
        _assert_same_state(j["states"][step], _state(ts, queries, False))
    ts.refresh()
    assert ts._last_refresh == "native"
    after = _state(t0, queries, False)["search"]
    for (bi, bd), (ai, ad), (ji, jd) in zip(before, after, j["parent"]):
        for x in (ai, ji):
            np.testing.assert_array_equal(x, bi)
        for x in (ad, jd):
            np.testing.assert_array_equal(x, bd)
    assert len(t0.index) == N and not t0.index.store.has_payload
    with pytest.raises(RuntimeError):
        _ = ts.index.store.codes


def test_native_op_errors_match_jax():
    """Error cases raise what the JAX package raises: a missing id
    (KeyError), an out-of-range delete (IndexError), a wrong-width push
    (AssertionError)."""
    ts, _ = _port_view(8, 1, cfg=MODES["lut"])
    got = _error_cases(ts)
    assert got == _jax_build_of(8, 1, "lut")["errors"]
    assert got == ["KeyError", "IndexError", "AssertionError",
                   "AssertionError"]


def test_int8_native_ops_equal_a_rebuild(tmp_path):
    """An int8 dense distributed view (whose JAX native append reads the
    scale as its sorted cells, C.1, so it is held to a rebuild instead):
    after each native op its searches equal those of a fresh host-based
    view over its own consolidated directory, bit for bit."""
    from ivfadc_tpu_torch.parallel import (consolidate_sharded_index,
                                           save_sharded_index)
    t0, data = _port_view(4, 1, cfg=MODES["int8"])
    ts = t0.fork()
    q = _queries(12, 64)
    for i, (name, args) in enumerate((
            ("push_batch", (_queries(13, 300),)),
            ("delete", (np.arange(3, 700, 5),)),
            ("push_front", (data[1] + 1,)), ("pop", ()),
            ("pop_front", ()))):
        getattr(ts, name)(*args)
        path = str(tmp_path / f"s{i}")
        save_sharded_index(path, ts)
        fresh = ShardedIVFADCIndex(
            consolidate_sharded_index(path, device="cpu"), ts.mesh)
        for B in (8, 64):
            a = ts.search_padded(q[:B], 10, w=4)
            b = fresh.search_padded(q[:B], 10, w=4)
            np.testing.assert_array_equal(a[0], b[0], err_msg=name)
            np.testing.assert_array_equal(a[1], b[1], err_msg=name)


# --------------------------------------------------------------- bootstrap
def test_bootstrap_noop_single_process(monkeypatch):
    """No cluster settings -> no-op returning False; process_info says one
    process."""
    for v in ("IVFADC_COORDINATOR", "IVFADC_NUM_PROCESSES",
              "IVFADC_PROCESS_ID", "IVFADC_LOCAL_DEVICE_IDS", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(bootstrap, "_INITIALIZED", False)
    assert bootstrap.initialize_cluster() is False
    info = bootstrap.process_info()
    assert info["process_count"] == 1 and info["initialized"] is False


@pytest.mark.parametrize("source", ["ivfadc", "torchrun"])
def test_bootstrap_env_resolution(monkeypatch, source):
    """The IVFADC_* variables (or torchrun's) reach
    torch.distributed.init_process_group (intercepted: no real cluster
    here), gloo without a card; repeat calls are no-ops."""
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(bootstrap, "_INITIALIZED", False)
    monkeypatch.setattr(bootstrap, "_STATE", {})
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(bootstrap, "_gather_devices",
                        lambda local: [["h|cpu"]] * 4)
    if source == "ivfadc":
        monkeypatch.setenv("IVFADC_COORDINATOR", "10.0.0.1:1234")
        monkeypatch.setenv("IVFADC_NUM_PROCESSES", "4")
        monkeypatch.setenv("IVFADC_PROCESS_ID", "2")
        monkeypatch.setenv("IVFADC_LOCAL_DEVICE_IDS", "0,1")
    else:
        for v in ("IVFADC_COORDINATOR", "IVFADC_NUM_PROCESSES",
                  "IVFADC_PROCESS_ID", "IVFADC_LOCAL_DEVICE_IDS"):
            monkeypatch.delenv(v, raising=False)
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1234")
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("RANK", "2")
    assert bootstrap.initialize_cluster() is True
    assert len(calls) == 1
    kw = calls[0]
    assert (kw["backend"], kw["init_method"], kw["world_size"],
            kw["rank"]) == ("gloo", "tcp://10.0.0.1:1234", 4, 2)
    info = bootstrap.process_info()
    assert info["process_index"] == 2 and info["process_count"] == 4
    assert info["local_device_count"] == (2 if source == "ivfadc" else 1)
    assert info["backend"] == "gloo"
    assert bootstrap.initialize_cluster() is True and len(calls) == 1
    monkeypatch.setattr(bootstrap, "_INITIALIZED", False)


def test_backend_choice():
    """NCCL only when every rank drives cards of its own."""
    assert bootstrap._choose_backend([["a|cuda:0"], ["a|cuda:1"]]) == "nccl"
    assert bootstrap._choose_backend([["a|cuda:0"], ["b|cuda:0"]]) == "nccl"
    assert bootstrap._choose_backend([["a|cuda:0"], ["a|cuda:0"]]) == "gloo"
    assert bootstrap._choose_backend([["a|cpu"], ["a|cpu"]]) == "gloo"


# ------------------------------------------------------- two real ranks
_WORKER = r'''
import os, sys
os.nice(19)                  # the lowest CPU priority, as a JAX child
sys.path.insert(0, os.environ["IVFADC_ROOT"])
import numpy as np
import torch
torch.set_num_threads(1)
from ivfadc_tpu_torch.parallel import (initialize_cluster, load_sharded_index,
                                       make_mesh, process_info,
                                       save_sharded_index, shutdown_cluster,
                                       ShardedIVFADCIndex)
pid = int(os.environ["RANK_X"])
assert initialize_cluster(os.environ["COORD"], 2, pid, [0, 0])
info = process_info()
assert info["process_count"] == 2 and info["global_device_count"] == 4
exec(os.environ["DATA_CODE"])
mesh = make_mesh(n_shards=4)
out = os.environ["OUT_DIR"]
phase = os.environ["PHASE"]
if phase == "build":
    sv = ShardedIVFADCIndex.build(data, mesh, **cfg)
    assert sum(v is not None for v in sv.views) == 2
    ids, dists = sv.search_padded(q, 10, w=4)
    save_sharded_index(out + "/dir", sv)
    np.savez(out + f"/build{pid}.npz", ids=ids, dists=dists)
elif phase == "load":
    sv = load_sharded_index(out + "/dir", mesh)
    ids, dists = sv.search_padded(q, 10, w=4)
    np.savez(out + f"/load{pid}.npz", ids=ids, dists=dists)
else:
    sv = ShardedIVFADCIndex.build(data, mesh, **cfg)
    res = {}
    exec(os.environ["OPS_CODE"])
    np.savez(out + f"/ops{pid}.npz", **res)
print("rank", pid, info["backend"], flush=True)
shutdown_cluster()
'''

_DATA = '''
rng = np.random.RandomState(3)
cent = rng.randn(12, 16).astype(np.float32) * 5
data = np.concatenate([c + rng.randn(200, 16).astype(np.float32)
                       for c in cent])
q = data[::41][:48]
cfg = dict(kc=24, m=4, k=32, seed=0, scan_mode="dense", scan_cache="bf16",
           coarse_maxiter=4, quantization_maxiter=4)
'''

_OPS = '''
sv.push_batch(np.random.RandomState(4).randn(400, 16).astype(np.float32) * 5)
res["a"] = np.concatenate(sv.search_padded(q, 10, w=4))
sv.delete(np.arange(0, 2000, 9))
sv.push_front(data[2] + 0.5)
res["pop"] = sv.pop()
res["pop_front"] = sv.pop_front()
res["rec"] = sv.reconstruct(17)
res["b"] = np.concatenate(sv.search_padded(q, 10, w=4))
res["n"] = np.asarray(len(sv.index))
from ivfadc_tpu_torch import IVFADCIndex
hv = ShardedIVFADCIndex(IVFADCIndex.build(data, device="cpu", **cfg), mesh)
hv.push_batch(data[:16] + 0.5)
hv.delete([0, 1, 2])
assert hv._last_refresh == "incremental"
res["host"] = np.concatenate(hv.search_padded(q, 10, w=4))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, phase):
    """Two ranks of one gloo group as subprocesses; a rank that fails or
    outlasts T fails the test (and both are killed)."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env.update(IVFADC_ROOT=REPO, COORD=coord, OUT_DIR=str(tmp_path),
               PHASE=phase, DATA_CODE=_DATA, OPS_CODE=_OPS,
               PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env=dict(env, RANK_X=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=T)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
        assert "gloo" in o
    return outs


def _twin():
    ns = {"np": np}
    exec(_DATA, ns)
    sv = ShardedIVFADCIndex.build(
        ns["data"], make_mesh(n_shards=4, devices=CPUS[:4]), **ns["cfg"])
    return sv, ns


def test_two_ranks_build_save_load_equal_twin(tmp_path):
    """A 2-rank gloo group (2 shards a rank on a global 1 x 4 mesh) builds,
    searches, saves (each rank its own shard files), and a fresh group
    loads and searches again: every rank's ids and distances bit-equal to
    the single-process twin's."""
    _run_ranks(tmp_path, "build")
    assert sorted(f for f in os.listdir(tmp_path / "dir")
                  if f.startswith("shard_")) == \
        [f"shard_{s:05d}.npz" for s in range(4)]
    _run_ranks(tmp_path, "load")
    sv, ns = _twin()
    ids, dists = sv.search_padded(ns["q"], 10, w=4)
    for phase in ("build", "load"):
        for r in range(2):
            z = np.load(tmp_path / f"{phase}{r}.npz")
            np.testing.assert_array_equal(z["ids"], ids)
            np.testing.assert_array_equal(z["dists"], dists)


def test_two_ranks_native_ops_equal_twin(tmp_path):
    """Native ops under a 2-rank gloo group (push_batch with a regrow, a
    delete, push_front, pop, pop_front, reconstruct), then a host-based
    view (each rank builds the same index, holds its own shards, mutates
    the base and refreshes incrementally): every rank's results bit-equal
    to the single-process twin's."""
    _run_ranks(tmp_path, "ops")
    sv, ns = _twin()
    res = {}
    exec(_OPS, dict(ns, sv=sv, res=res, mesh=sv.mesh,
                    ShardedIVFADCIndex=ShardedIVFADCIndex))
    for r in range(2):
        z = np.load(tmp_path / f"ops{r}.npz")
        for key, val in res.items():
            np.testing.assert_array_equal(z[key], val, err_msg=key)

