"""A run loads neither JAX nor the JAX package, after set-up and after the
window (checked in a fresh process, top-level names compared whole)."""

import subprocess
import sys

from conftest import BENCH

SCRIPT = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
import torch
torch.set_num_threads(2)
from conftest import tiny_cell
from gnssbench import harness
cell = tiny_cell("galileo_e1b_4ch.stream")
ctx = harness.Ctx(cell, 5, torch.device("cpu"))
harness.build_program(ctx)
harness.make_inputs(ctx)
ctx.init_state = harness.program_state(ctx)
print("after set-up", harness.forbidden_modules())
r = harness.run(cell, 5, 0.3, False, "cpu", time.perf_counter())
print("after the window", harness.forbidden_modules(), r["correct"])
"""


def test_no_jax_after_setup_and_window():
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=600,
                         cwd=str(BENCH / "tests"))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert "after set-up []" in lines
    assert "after the window [] True" in lines
