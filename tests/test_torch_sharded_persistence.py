"""The shard-dir format (`ivfadc_tpu_torch.parallel.persistence`) against
the JAX package's, on the CPU.

A directory written by either package loads in the other, onto the same
shard count and onto another one (a reshard); both consolidations (to an
in-memory index, and out of core to a format-v1 file) agree across the
packages. The JAX side is a host-based view (`ShardedIVFADCIndex(idx,
mesh)`) over the integer index of tests/test_torch_dynamic.py, the port's
side a distributed build on the integer components of
tests/test_torch_distributed.py: every score is exact, so searches compare
bit for bit. As there, the JAX side runs in fresh child processes
(`_jax_child`), which keeps its programs out of the suite's workers.
"""

import json
import os

import numpy as np
import pytest
import torch

from ivfadc_tpu_torch import IVFADCConfig, IVFADCIndex, make_mesh
from ivfadc_tpu_torch.parallel import (ShardedIVFADCIndex,
                                       consolidate_sharded_index,
                                       consolidate_sharded_to_file,
                                       load_sharded_index, save_sharded_index)
from ivfadc_tpu_torch.parallel import persistence as port_pers
from tests.test_torch_distributed import (DIM, KC, K, M, _components,
                                          _jax_child, _patch_training,
                                          _state, shared_dir)
from tests.test_torch_sharded import _assert_equal_but_ties

torch.set_num_threads(2)

CPUS = [torch.device("cpu")] * 8
STORE_KEYS = ("offsets", "caps", "sizes", "codes", "ids")
JDIM = 10          # the integer index's dimension (the conftest fixture's)
# the loads of the JAX directory (S, D); the JAX view saved is S=4, D=2
JAX_DIR_MESHES = ((4, 2), (3, 1), (8, 1))
JAX_DIR_QUERIES = ((4, 8), (4, 128))


def _cpu_mesh(S, D=1):
    return make_mesh(n_shards=S, n_data=D, devices=CPUS)


def _int_queries(seed, n, d):
    return np.random.RandomState(seed).randint(0, 17, (n, d)) \
        .astype(np.float32)


def _same(a, b, ties=False):
    """Two (ids, dists) results: distances bit-equal; ids too, or with
    `ties` (another shard count, so another merge order among equal
    distances) equal but at exact ties."""
    (ai, ad), (bi, bd) = a, b
    np.testing.assert_array_equal(ad, bd)
    if ties:
        _assert_equal_but_ties(ai, bi, ad)
    else:
        assert ai.dtype == bi.dtype
        np.testing.assert_array_equal(ai, bi)


def _store(index) -> dict:
    return {key: np.array(getattr(index.store, key)) for key in STORE_KEYS}


def _assert_same_store(a: dict, b: dict):
    for key in STORE_KEYS:
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    assert b["codes"].dtype == a["codes"].dtype


# ---------------------------------------------------------- JAX children
def _jax_integer_dir(path, queries):
    """In a child: the integer index of tests/test_torch_dynamic.py saved
    as one file (`j.npz`), its host-based 4 x 2 view saved as a directory
    (`j`), that view's searches, and the JAX package's loads of the
    directory onto each of JAX_DIR_MESHES (their `_state`)."""
    from ivfadc_tpu.parallel.mesh import make_mesh as jax_mesh
    from ivfadc_tpu.parallel.persistence import (load_sharded_index,
                                                 save_sharded_index)
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex as JaxSharded
    from tests.test_torch_dynamic import _integer_pair
    j, _ = _integer_pair(np.random.RandomState(42).rand(243, 10))
    j.save(os.path.join(path, "j.npz"))
    js = JaxSharded(j, jax_mesh(n_shards=4, n_data=2))
    save_sharded_index(os.path.join(path, "j"), js)
    out = dict(search=[js.search_padded(_int_queries(s, n, JDIM), 10, w=4)
                       for s, n in queries])
    for S, D in JAX_DIR_MESHES:
        jl = load_sharded_index(os.path.join(path, "j"),
                                jax_mesh(n_shards=S, n_data=D))
        out[S, D] = _state(jl, (), True)
    return out


def _jax_load_dir(path, S, D, queries):
    """In a child: the JAX package's load of a directory onto S x D: its
    searches (at the dimension of the port's integer components), its
    size, shard count and id mode."""
    from ivfadc_tpu.parallel.mesh import make_mesh as jax_mesh
    from ivfadc_tpu.parallel.persistence import load_sharded_index
    js = load_sharded_index(path, jax_mesh(n_shards=S, n_data=D))
    return dict(search=[js.search_padded(_int_queries(s, n, DIM), 10, w=4)
                        for s, n in queries],
                n=len(js.index), n_shards=js.n_shards, wide=js.wide_ids)


def _jax_consolidate(dirs, files, out_dir):
    """In a child: the JAX package's in-memory consolidation of each
    directory (its store, a search of 16 integer queries), its out-of-core
    file of each (into `out_dir`, named after the directory), and its load
    of each of `files`."""
    from ivfadc_tpu import load_ivfadc_index
    from ivfadc_tpu.parallel.persistence import (consolidate_sharded_index,
                                                 consolidate_sharded_to_file)
    out = {}
    for d in dirs:
        jc = consolidate_sharded_index(d)
        out[d] = dict(store=_store(jc), search=jc.search_padded(
            _int_queries(3, 16, jc.dim), 10, w=4))
        consolidate_sharded_to_file(
            d, os.path.join(out_dir, os.path.basename(d) + "_jax.npz"))
    for f in files:
        out[f] = _store(load_ivfadc_index(f))
    return out


def _jax(task, **kw):
    return _jax_child(task, module=__name__, **kw)


# ------------------------------------------------------------- fixtures
_PORT = {}


def _port_view(wide=False):
    """A port distributed build (4 x 2 mesh) on the integer components,
    made once."""
    if wide not in _PORT:
        data, cents, cb = _components()
        cfg = IVFADCConfig(kc=KC, m=M, k=K, seed=0, scan_mode="dense",
                           scan_cache="bf16",
                           index_dtype="uint64" if wide else "uint32")
        with pytest.MonkeyPatch.context() as mp:
            _patch_training(mp, cents, cb)
            if wide:
                mp.setenv("IVFADC_DEVICE_ID_CAP", "512")
            _PORT[wide] = ShardedIVFADCIndex.build(data, _cpu_mesh(4, 2),
                                                   cfg)
    return _PORT[wide]


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """(path, the child's results) of `_jax_integer_dir`, made once a run
    where the workers share a directory (`shared_dir`), else once a
    module."""
    shared = shared_dir()
    path = os.path.join(shared, "jax_dir") if shared else \
        str(tmp_path_factory.mktemp("jax_dir"))
    os.makedirs(path, exist_ok=True)
    return path, _jax("integer_dir", path=path, queries=JAX_DIR_QUERIES)


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("S,D", JAX_DIR_MESHES)
def test_jax_dir_loads_in_port(jax_dir, S, D):
    """A JAX directory (S = 4) onto the port's S x D mesh: per-shard arrays
    and host layout equal the JAX package's load of it, and searches
    bit-equal to the saved JAX view (at another S the distances, and the
    ids but at exact ties)."""
    path, j = jax_dir
    ts = load_sharded_index(os.path.join(path, "j"), _cpu_mesh(S, D))
    assert ts.n_shards == S and ts._distributed_build
    t, ref = _state(ts, (), False), j[S, D]
    for key in ("offsets", "sizes", "ids", "codes", "decoded", "norms"):
        np.testing.assert_array_equal(t["arrays"][key], ref["arrays"][key],
                                      err_msg=key)
    for name in ("_h_offsets", "_h_sizes", "_h_caps"):
        np.testing.assert_array_equal(t[name], ref[name], err_msg=name)
    assert t["scalars"] == ref["scalars"]
    for (s, n), res in zip(JAX_DIR_QUERIES, j["search"]):
        _same(ts.search_padded(_int_queries(s, n, JDIM), 10, w=4), res,
              ties=S != 4)


@pytest.mark.parametrize("S,D", [(4, 2), (2, 4)])
def test_port_dir_loads_in_jax(tmp_path, S, D):
    """A port directory (a distributed build, S = 4) onto the JAX
    package's S x D mesh: searches bit-equal to the port's view (at
    another S the ids but at exact ties)."""
    ts = _port_view()
    path = str(tmp_path / "t")
    save_sharded_index(path, ts)
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["format_version"] == 2
    j = _jax("load_dir", path=path, S=S, D=D, queries=((7, 8 * D),))
    assert (j["n"], j["n_shards"], j["wide"]) == (len(ts.index), S, False)
    _same(ts.search_padded(_int_queries(7, 8 * D, DIM), 10, w=4),
          j["search"][0], ties=S != 4)


def test_consolidations_agree_across_packages(jax_dir, tmp_path):
    """Both consolidations, both ways: a JAX directory consolidated by the
    port equals the JAX consolidation (store arrays and search), and a
    port directory consolidated by JAX equals the port's; the out-of-core
    files of both packages load equal in both."""
    jdir, tdir = os.path.join(jax_dir[0], "j"), str(tmp_path / "t")
    ts = _port_view()
    save_sharded_index(tdir, ts)
    files = [str(tmp_path / (os.path.basename(d) + "_port.npz"))
             for d in (jdir, tdir)]
    for d, f in zip((jdir, tdir), files):
        consolidate_sharded_to_file(d, f)
    j = _jax("consolidate", dirs=(jdir, tdir), files=tuple(files),
             out_dir=str(tmp_path))
    for d, f in zip((jdir, tdir), files):
        tc = consolidate_sharded_index(d, device="cpu")
        assert tc.store.has_payload
        _assert_same_store(j[d]["store"], _store(tc))
        _same(tc.search_padded(_int_queries(3, 16, tc.dim), 10, w=4),
              j[d]["search"])
        jax_file = str(tmp_path / (os.path.basename(d) + "_jax.npz"))
        for file in (f, jax_file):
            _assert_same_store(j[d]["store"],
                               _store(IVFADCIndex.load(file, device="cpu")))
        _assert_same_store(j[d]["store"], j[f])
    # the port's consolidation of its own directory searches as its view
    q = _int_queries(4, 16, DIM)
    _same(ts.search_padded(q, 10, w=4),
          consolidate_sharded_index(tdir, device="cpu").search_padded(
              q, 10, w=4))


def test_out_of_core_consolidation_one_shard_at_a_time(tmp_path):
    """consolidate_sharded_to_file equals the in-memory consolidation
    field for field, and never holds two shard payloads open at once."""
    ts = _port_view()
    d = str(tmp_path / "dir")
    save_sharded_index(d, ts)
    mem = consolidate_sharded_index(d, device="cpu")
    state = {"now": 0, "peak": 0}
    real_load = np.load

    class _Tracking:
        def __init__(self, z, shard):
            self._z, self._shard = z, shard

        def __enter__(self):
            if self._shard:
                state["now"] += 1
                state["peak"] = max(state["peak"], state["now"])
            return self._z.__enter__()

        def __exit__(self, *exc):
            if self._shard:
                state["now"] -= 1
            return self._z.__exit__(*exc)

    out = str(tmp_path / "flat.npz")
    port_pers.np.load = lambda fp, *a, **kw: _Tracking(
        real_load(fp, *a, **kw), "shard_" in str(fp))
    try:
        consolidate_sharded_to_file(d, out, chunk_rows=64)
    finally:
        port_pers.np.load = real_load
    assert state["peak"] == 1, state
    _assert_same_store(_store(mem),
                       _store(IVFADCIndex.load(out, device="cpu")))


def test_wide_dir_across_packages(tmp_path):
    """A wide-id port directory (uint64 translation in the shard files):
    the JAX package loads it with the same uint64 ids, both consolidate it
    to the same store, and it reshards in the port."""
    ts = _port_view(wide=True)
    assert ts.wide_ids
    d = str(tmp_path / "w")
    save_sharded_index(d, ts)
    q = _int_queries(5, 16, DIM)
    j = _jax("load_dir", path=d, S=4, D=2, queries=((5, 16),))
    assert j["wide"]
    _same(ts.search_padded(q, 10, w=4), j["search"][0])
    jc = _jax("consolidate", dirs=(d,), files=(), out_dir=str(tmp_path))
    _assert_same_store(jc[d]["store"],
                       _store(consolidate_sharded_index(d, device="cpu")))
    _same(ts.search_padded(q, 10, w=4),
          load_sharded_index(d, _cpu_mesh(2)).search_padded(q, 10, w=4),
          ties=True)


def test_reshard_roundtrips_back(tmp_path):
    """S = 4 -> save -> load S' = 2 -> save -> load S'' = 4: the same
    searches; every id placed once."""
    ts = _port_view()
    p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
    save_sharded_index(p1, ts)
    via2 = load_sharded_index(p1, _cpu_mesh(2, 4))
    ids = np.concatenate([v["ids"].numpy() for v in via2.views])
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]),
                                  np.arange(len(ts.index)))
    save_sharded_index(p2, via2)
    back = load_sharded_index(p2, _cpu_mesh(4, 2))
    q = _int_queries(6, 16, DIM)
    ref = ts.search_padded(q, 10, w=4)
    _same(back.search_padded(q, 10, w=4), ref)
    _same(via2.search_padded(q, 10, w=4), ref, ties=True)


def test_v1_dir_and_newer_format(tmp_path):
    """A format-v1 directory (per-shard layout in common.npz) loads; a
    newer format raises."""
    ts = _port_view()
    d = str(tmp_path / "v1")
    save_sharded_index(d, ts)
    offs, sizs = [], []
    for s in range(4):
        fp = os.path.join(d, f"shard_{s:05d}.npz")
        with np.load(fp) as z:
            block = {k: z[k] for k in z.files}
        offs.append(block.pop("offsets"))
        sizs.append(block.pop("sizes"))
        np.savez(fp, **block)
    cp = os.path.join(d, "common.npz")
    with np.load(cp) as z:
        common = {k: z[k] for k in z.files}
    np.savez(cp, shard_offsets=np.stack(offs), shard_sizes=np.stack(sizs),
             **common)
    mf = os.path.join(d, "manifest.json")
    with open(mf) as f:
        meta = json.load(f)
    meta["format_version"] = 1
    with open(mf, "w") as f:
        json.dump(meta, f)
    q = _int_queries(8, 16, DIM)
    ref = ts.search_padded(q, 10, w=4)
    _same(load_sharded_index(d, _cpu_mesh(4)).search_padded(q, 10, w=4),
          ref)
    _same(consolidate_sharded_index(d, device="cpu").search_padded(
        q, 10, w=4), ref)
    meta["format_version"] = 999
    with open(mf, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="newer"):
        load_sharded_index(d, _cpu_mesh(4))


def test_missing_shard_files(tmp_path):
    """A per-rank restore tolerates the files of shards it does not hold;
    a needed file, or any file for a consolidation, must exist."""
    ts = _port_view()
    d = str(tmp_path / "m")
    save_sharded_index(d, ts)
    os.remove(os.path.join(d, "shard_00003.npz"))
    codes, _, _, _ = port_pers._read_shard_files(d, 4, {0, 1}, None)
    assert codes[3] is None and codes[0] is not None
    with pytest.raises(FileNotFoundError):
        port_pers._read_shard_files(d, 4, {3}, None)
    with pytest.raises(FileNotFoundError):
        load_sharded_index(d, _cpu_mesh(4))
    with pytest.raises(FileNotFoundError):
        consolidate_sharded_to_file(d, str(tmp_path / "x.npz"))


def test_host_based_view_roundtrip(jax_dir, tmp_path):
    """The port's host-based view saves too: its directory loads (as a
    payload-free view) with the same searches, and consolidates back to
    the original index cell for cell."""
    t = IVFADCIndex.load(os.path.join(jax_dir[0], "j.npz"), device="cpu")
    ts = ShardedIVFADCIndex(t, _cpu_mesh(4, 2))
    d = str(tmp_path / "h")
    save_sharded_index(d, ts)
    q = _int_queries(9, 64, t.dim)
    _same(load_sharded_index(d, _cpu_mesh(4, 2)).search_padded(q, 10, w=4),
          ts.search_padded(q, 10, w=4))
    back = consolidate_sharded_index(d, device="cpu")
    for c in range(t.config.kc):
        for a, b in zip(t.store.cell_entries(c), back.store.cell_entries(c)):
            np.testing.assert_array_equal(a, b)
