"""On a machine with an NVIDIA GPU: one short run of each cell through the
benchmark's command, correct, with the result line's keys."""

import json
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", name,
         "--seed", "2147483653", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) >= {"rtf", "segment_p95_ms", "setup_s"}
