"""The `source_stream` entry and the front end's readers (`condition_ms`,
`condition_roofline`, `condition_launches_per_s`): the cells' files found
by name, the readers on spans and work laid out as a segment makes them
and silent without them, the roofline count, the source's time shift, a
run of each cell cut to a CPU test's size (correct, and its control not;
the GPS ishort source too, whose cell is not in BENCHMARK.json), and
(`gpu`) a traced run of the cell on the card."""

import copy
import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from conftest import BENCH

from gnss_sdr_1_tpu_torch.utils import spans
from gnss_sdr_1_tpu_torch.utils.spans import Span
from gnssbench import check, harness
from gnssbench import signal as sig
from gnssbench.roofline_front_end import least_time

CELLS = ("gps_l1ca_nsr_8ch.source_stream",)
# the entry's Direct_Resampler case: the GPS ishort source at 4 Msps, whose
# configuration, mix and limits are in benchmark/ but whose cell is not in
# BENCHMARK.json (its spread: PERF.md section 7); built from its files
ISHORT = "gps_l1ca_8ch.source_stream"
READERS = ("condition_ms", "condition_roofline", "condition_launches_per_s")


def _cell(name: str) -> harness.Cell:
    if name != ISHORT:
        return harness.load_cell(name)
    nsr = harness.load_cell(CELLS[0])
    return harness.Cell(
        name=name, chips=1, mix=nsr.mix,
        config=json.loads((BENCH / "configs" / "gps_l1ca_8ch.json")
                          .read_text()),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        end_to_end=nsr.end_to_end, per_layer=nsr.per_layer)


def _entry():
    return harness.load_module("entries", "source_stream")


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def tiny_cell(name: str, n_ch: int = 2) -> harness.Cell:
    """A cell cut to a CPU test's size: `n_ch` channels, 80 ms segments, a
    0.4 s capture, three compared segments."""
    cell = copy.deepcopy(_cell(name))
    cfg = cell.config
    cfg["prns"] = cfg["prns"][:n_ch]
    cfg["track"]["n_channels"] = n_ch
    cfg["reacq_interval_blocks"] = 2
    cell.mix.update(capture_s=0.4, compare_segments=3, keep_passes=2,
                    warmup_segments=1)
    return cell


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


@pytest.mark.parametrize("name", CELLS + (ISHORT,))
def test_cell_files_are_found_by_name(name):
    cell = _cell(name)
    assert cell.mix["entry"] == "source_stream"
    entry = _entry()
    for fn in ("prepare", "warm_up", "window", "compare"):
        assert callable(getattr(entry, fn))
    assert set(cell.limits["limits"]) <= set(entry.Numbers().values())
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    assert {m["name"] for m in cell.end_to_end} == {"rtf", "segment_p95_ms",
                                                   "setup_s"}


def _fake(name, start_ms, dur_ms, **counts):
    s = Span(name, None, False)
    s.id = next(spans._ids)
    s.parent, s.segment = None, s.id
    s.start_ns, s.end_ns = int(start_ms * 1e6), int((start_ms + dur_ms) * 1e6)
    s.clock_ns, s.tid = 0, 1
    s.counts = dict(counts)
    spans._ring.append(s)
    return s


def test_readers_on_segments_as_the_entry_lays_them_out():
    """Four segments' condition spans, one before the window; the work
    and kernel time of two traced segments; the window's launches."""
    for k, dur in enumerate((9.0, 0.05, 0.04, 0.06)):
        _fake("stream.upload", 10.0 * k, 2.0)
        _fake("stream.condition", 10.0 * k + 2.0, dur, samples_in=8,
              samples_out=1, taps=65)
    work = {"outputs": 2_562_562, "taps": 65, "complex_input": False,
            "input_bytes": 5_125_124, "out_bytes": 2_562_562 * 8,
            "tap_bytes": 520}
    t = least_time(work)[0]
    run = types.SimpleNamespace(t0=9.99e-3, wall_s=30e-3, signal_s=30.0,
                                cond_launches=30, cond_traced=[work, work],
                                cond_device_s=4 * t)
    assert _read("condition_ms", run) == pytest.approx(0.05)
    assert _read("condition_launches_per_s", run) == 1.0
    assert _read("condition_roofline", run) == pytest.approx(50.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_are_silent_without_data(name):
    empty = types.SimpleNamespace(segments=[], launches={}, signal_s=0.0,
                                  profile=None, traced=[])
    assert _read(name, empty) is None
    no_spans = types.SimpleNamespace(t0=0.0, wall_s=1.0, signal_s=1.0,
                                     cond_launches=0, cond_traced=[],
                                     cond_device_s=0.0)
    assert _read(name, no_spans) is None


def test_least_time_of_the_cells_segments():
    """NSR: 2,562,562 outputs of 65 real taps, 284 operations each (0.73
    GFLOP, 10.9 us at 67 TFLOP/s) against 25.6 MB (7.6 us): operations.
    GPS ishort: one complex tap, 32 operations an output, against 32 MB
    (9.6 us): bytes."""
    n = 2_562_562
    t, by = least_time({"outputs": n, "taps": 65, "complex_input": False,
                        "input_bytes": n * 2, "out_bytes": n * 8,
                        "tap_bytes": 520})
    assert by == "operations"
    assert t == pytest.approx(n * 284 / 67e12)
    n = 2_002_002
    t, by = least_time({"outputs": n, "taps": 1, "complex_input": True,
                        "input_bytes": n * 8, "out_bytes": n * 8,
                        "tap_bytes": 8})
    assert by == "bytes"
    assert t == pytest.approx((n * 16 + 8) / 3.35e12)


def test_advanced_satellite_is_the_satellite_later():
    """The generator's code phase and carrier phase of `advanced(sat, t0)`
    at t are the satellite's at t + t0."""
    entry = _entry()
    sat = sig.Sat(prn=1, doppler_hz=-3712.25, doppler_rate_hz_s=0.61,
                  delay_chips=12345.678, cn0_dbhz=45.0,
                  nav_bits=np.ones(8), phase_rad=2.5)
    fc, rate = 1575.42e6, 1.023e6

    def model(s, t):
        dil = s.doppler_hz * t + 0.5 * s.doppler_rate_hz_s * t * t
        return (rate * (t + dil / fc) - s.delay_chips,
                np.mod(2 * np.pi * dil + s.phase_rad, 2 * np.pi))

    for t0 in (1.5625e-6, 17.0 + 1.5625e-6):
        later = entry.advanced(sat, t0, fc, rate)
        for t in (0.0, 0.3, 0.999):
            (c1, p1), (c2, p2) = model(later, t), model(sat, t + t0)
            assert abs(c1 - c2) < 1e-6
            assert abs(np.mod(p1 - p2 + np.pi, 2 * np.pi) - np.pi) < 1e-6


@pytest.mark.parametrize("name", CELLS + (ISHORT,))
def test_a_tiny_cpu_run_is_correct_and_its_control_is_not(name):
    cell = tiny_cell(name)
    with spans.recording():
        r = harness.run(cell, 2**31 + 29, 0.5, False, "cpu",
                        time.perf_counter(), control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    low = r["control_numbers"]
    lim = cell.limits["limits"]
    assert any(low[k] > lim[k] for k in lim), low
    assert low["cond_gap"] > lim["cond_gap"]


@pytest.mark.parametrize("name", CELLS + (ISHORT,))
def test_readers_on_a_tiny_cpu_run(name):
    cell = tiny_cell(name)
    dev = torch.device("cpu")
    with spans.recording():
        ctx, entry, tracer = harness.set_up(cell, 2**31 + 31, False, dev,
                                            time.perf_counter())
        harness.measure(ctx, entry, tracer, 0.5)
    conds = [s for s in spans.records() if s.name == "stream.condition"]
    assert len(conds) > len(ctx.segments) >= 1
    assert conds[-1].counts["taps"] == ctx.plan.n_taps
    assert conds[-1].counts["samples_out"] == ctx.n_out
    assert conds[-1].counts["samples_in"] == ctx.n_out * ctx.plan.decim
    assert _read("condition_ms", ctx) > 0
    # the plain version on the CPU launches nothing; nothing is traced
    assert ctx.cond_launches == 0
    assert _read("condition_launches_per_s", ctx) is None
    assert _read("condition_roofline", ctx) is None


# ------------------------------------------------------------------ the card


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_front_end_metrics(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", name,
         "--seed", "2147483659", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=1200, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert set(READERS) <= set(m)
    assert m["condition_launches_per_s"]["value"] == 1.0
    assert 0.0 < m["condition_roofline"]["value"] <= 100.0
    assert m["condition_ms"]["value"] > 0.0
    assert set(check.Numbers().values()) | {"cond_gap"} >= set(res["checks"])
