"""Every file the harness finds by name loads, and BENCHMARK.json keeps to
the benchmark contract's shapes, names and limits."""

import json
import os
import re

import pytest

from annbench_tiny import ROOT

from annbench import specs
from annbench.reference import compare

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return specs.benchmark()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert any(w.startswith(tuple(bench["paths"])) for w in bench["command"])


def test_run_seconds_fits_a_full_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(bench):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e and section != "end_to_end":
                    assert _line(e[key]), (e["name"], key)
    for section in ("configs", "workloads"):
        got = [n for s, n in names if s == section]
        assert len(got) == len(set(got))
    metrics = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_configs_load_by_name(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"annbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        cfg = specs.config(c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(cfg["data"]) >= {"n", "d", "n_clusters", "noise"}
        assert specs.layer_map(cfg["layers"])["rules"]


def test_cells_load_by_name(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = specs.cell(w["name"])
        assert set(cell["check"]["limits"]) <= set(compare.NAMES)
        assert cell["check"]["limits"]["lost_rows"] == 0
        assert cell["check"]["limits"]["bad_answers"] == 0
        traffic = specs.traffic(w["traffic"])
        drv = specs.driver(traffic["driver"])
        assert callable(drv.warm) and callable(drv.run)
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)


def test_metrics_match_their_readers(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") or "_roofline." in m["name"]
    # BENCHMARK.json is the only registry: each metric has a reader,
    # which repeats none of its entry
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = specs.metric(m["name"])
        assert callable(reader.read) and not hasattr(reader, "META")
    # every cell reports setup_s, another end-to-end and a per-layer metric
    for c in cells:
        assert len(specs.cell_metrics(c, "end_to_end")) >= 2
        assert specs.cell_metrics(c, "per_layer")
    # one layer name a layer, letter for letter
    by_layer = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_files_are_named_from_names():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "annbench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel


def test_traffic_files_are_data(bench):
    for w in bench["workloads"]:
        path = os.path.join(ROOT, "annbench", "traffic",
                            w["traffic"] + ".json")
        with open(path) as f:
            json.load(f)
