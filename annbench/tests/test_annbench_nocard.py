"""The measuring path refuses to run without a card, and runs on one."""

import json
import os
import subprocess
import sys
import time

import pytest

from annbench_tiny import ROOT, tiny


def test_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "annbench", "run.py"),
         "--workload", "sift1m.batch", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no result" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from annbench import harness
    result, _ = harness.run("sift1m.batch", 11, 1.0, True,
                            t_start=time.perf_counter(),
                            overrides=tiny("sift1m.batch"))
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
