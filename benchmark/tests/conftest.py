"""CPU tests of the benchmark: the harness's discovery by name, the
roofline count, the reference against the port's plain path, the check's
control and faults, and the absence of JAX; and one card test (`gpu`).

Run from the repository root: `python -m pytest benchmark/tests -q`.
"""

import copy
import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from gnssbench import harness  # noqa: E402

CELLS = ("gps_l1ca_8ch.symbols", "galileo_e1b_4ch.stream")


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(name: str, n_ch: int = 2) -> harness.Cell:
    """A cell cut to a size a CPU test run holds: `n_ch` channels, 80 ms
    segments, a 0.4 s capture, three compared segments."""
    cell = copy.deepcopy(harness.load_cell(name))
    cfg = cell.config
    cfg["prns"] = cfg["prns"][:n_ch]
    cfg["track"]["n_channels"] = n_ch
    cfg["reacq_interval_blocks"] = 2
    cell.mix.update(capture_s=0.4, compare_segments=3, keep_passes=2,
                    warmup_segments=1)
    return cell
