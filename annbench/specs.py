"""Everything a run reads, found by name.

- `BENCHMARK.json` at the checkout's root: cells and metrics;
- `configs/<config>.json`: the deployment (data, index settings, source,
  what was cut and assumed);
- `traffic/<traffic>.json`: a traffic mix, read by `drivers/<driver>.py`;
- `workloads/<cell>.json`: a cell's config, traffic and the limits of
  its comparison;
- `metrics/<metric>.py`: one reader a metric of BENCHMARK.json (`read`);
- `layers/<map>.json`: kernel names to layers, one map a configuration.

A later cell, traffic mix, metric or layer map is a new file here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(folder: str, name: str) -> dict:
    path = os.path.join(HERE, folder, _check_name(name) + ".json")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell's entry in BENCHMARK.json merged with its workload file;
    the two have to agree on config and traffic."""
    entry = next((w for w in benchmark()["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    own = _json("workloads", name)
    for key in ("config", "traffic"):
        if own[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{own[key]!r}, BENCHMARK.json {entry[key]!r}")
    return {**own, "chips": entry["chips"]}


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def layer_map(name: str) -> dict:
    return _json("layers", name)


def _load(folder: str, name: str) -> ModuleType:
    path = os.path.join(HERE, folder, _check_name(name) + ".py")
    mod_name = f"annbench.{folder}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str) -> ModuleType:
    return _load("drivers", kind)


def metric(name: str) -> ModuleType:
    return _load("metrics", name)


def cell_metrics(cell_name: str, section: str) -> list:
    """The metrics of BENCHMARK.json's `section` that this cell reports."""
    return [m for m in benchmark()[section]
            if cell_name in m.get("workloads", [cell_name])]
