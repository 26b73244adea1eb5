"""The harness finds every file of a cell by name, and its readers stay
silent where a run gives them nothing to read."""

import json
import types

import pytest
from conftest import BENCH, CELLS

from gnssbench import check, harness

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = harness.load_cell(name)
    entry = harness.load_module("entries", cell.mix["entry"])
    for fn in ("prepare", "warm_up", "window", "compare"):
        assert callable(getattr(entry, fn))
    assert cell.per_layer and cell.end_to_end
    numbers = check.Numbers().values()
    assert set(cell.limits["limits"]) <= set(numbers)
    assert {m["name"] for m in cell.end_to_end} >= {"rtf", "setup_s"}


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_readers_are_silent_without_data(metric):
    reader = harness.load_module("metrics", metric)
    empty = types.SimpleNamespace(segments=[], launches={}, signal_s=0.0,
                                  profile=None, traced=[])
    assert reader.read(empty) is None


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")


def test_result_line_puts_correct_first_and_checks_last():
    line = harness.result_line({"checks": {"a": 1}, "metrics": {},
                                "correct": True, "attempted": 1,
                                "failed": 0, "device": {}})
    keys = list(json.loads(line))
    assert keys[0] == "correct" and keys[-1] == "checks"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "gnss_sdr_1_tpu_torch_x", types)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types)
    assert harness.forbidden_modules() == ["jaxlib"]
