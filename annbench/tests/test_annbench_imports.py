"""No module a run loads is JAX's or the JAX package's, by whole
top-level name (`ivfadc_tpu_torch` is the port; `ivfadc_tpu` is not)."""

import os
import subprocess
import sys

from annbench_tiny import ROOT

CHILD = r"""
import glob, importlib, os, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, os.path.join({root!r}, "annbench", "tests"))
from annbench import harness, run, specs
from annbench_tiny import CELLS, tiny
for f in sorted(glob.glob(os.path.join({root!r}, "annbench", "**", "*.py"),
                          recursive=True)):
    rel = os.path.relpath(f, {root!r})[:-3]
    if "/tests/" in f or rel.endswith("__init__"):
        continue
    if rel.startswith(("annbench/metrics/", "annbench/drivers/")):
        kind, name = rel.split("/")[1:]
        (specs.metric if kind == "metrics" else specs.driver)(name)
    else:
        importlib.import_module(rel.replace("/", "."))
for i, cell in enumerate(CELLS):
    harness.run(cell, 5, 0.3, i % 2 == 1,
                t_start=time.perf_counter(), device="cpu",
                overrides=tiny(cell))
print("FORBIDDEN", run.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=ROOT)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("FORBIDDEN")]
    assert line == ["FORBIDDEN []"], out.stdout[-2000:]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from annbench import run
    for name in ("ivfadc_tpu_torch", "ivfadc_tpu_torch.ops", "jaxtyping",
                 "flaxen", "ivfadc_tpu_other"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax.linen", "ivfadc_tpu",
                 "ivfadc_tpu.models.index"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == sorted(
        ["jax", "jaxlib.xla_client", "flax.linen", "ivfadc_tpu",
         "ivfadc_tpu.models.index"])
