"""The readers of the program's spans and counts (`enqueue_ms`,
`launch_self_ms`, `device_wait_ms`, `stage_copy_ms`, `host_syncs_per_s`,
`pinned_allocs_per_s`): on spans laid out as a segment of each cell makes
them, on a run of each cell cut to a CPU test's size under
`spans.recording()`, and (`gpu`) in a traced run on the card, where the
program's spans leave the device trace's metrics as they are."""

import json
import subprocess
import sys
import time
import types

import pytest
import torch
from conftest import BENCH, CELLS, tiny_cell

from gnss_sdr_1_tpu_torch.utils import spans
from gnss_sdr_1_tpu_torch.utils.spans import Span
from gnssbench import harness

NEW = ("enqueue_ms", "launch_self_ms", "device_wait_ms", "stage_copy_ms",
       "host_syncs_per_s", "pinned_allocs_per_s")


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _fake(name, start_ms, dur_ms, parent=None, segment=None, wait=False,
          **counts):
    """A finished span as the program records it, at `start_ms` after 0."""
    s = Span(name, segment, wait)
    s.id = next(spans._ids)
    s.parent = None if parent is None else parent.id
    s.segment = s.id if segment is None and parent is None else (
        segment if segment is not None else parent.segment)
    s.start_ns = int(start_ms * 1e6)
    s.end_ns = int((start_ms + dur_ms) * 1e6)
    s.clock_ns, s.tid = 0, 1
    s.counts = dict(counts)
    spans._ring.append(s)
    return s


def _window(t0_ms, wall_ms):
    return types.SimpleNamespace(t0=t0_ms * 1e-3, wall_s=wall_ms * 1e-3,
                                 span=2_000_000, fs=2e6)


def test_readers_on_stream_segments_as_the_program_lays_them_out():
    """Three E1B-like segments (upload, unpack, launch; the harvest of k
    after the launch of k+1, joined to k's segment), one before the
    window: each reader takes only the window's spans."""
    t, launches = 0.0, []
    for k in range(4):
        up = _fake("stream.upload", t, 3.0, pinned_allocs=int(k == 0))
        _fake("stream.upload.wait", t, 0.5, up, wait=True)
        _fake("stream.upload.stage", t + 0.5, 2.0, up, bytes=16)
        _fake("stream.unpack", t + 3.0, 0.2)
        lc = _fake("engine.launch_capture", t + 3.2, 1.0)
        _fake("engine.pack_rows", t + 3.2, 0.1, lc)
        _fake("engine.enqueue", t + 3.3, 0.3, lc)
        _fake("engine.read_back", t + 3.6, 0.4, lc, pinned_allocs=3)
        launches.append(lc)
        if k:
            hv = _fake("engine.harvest_capture", t + 4.2, 0.8,
                       segment=launches[k - 1].segment)
            _fake("engine.harvest.wait", t + 4.2, 0.6, hv, wait=True)
        t += 10.0
    run = _window(10.0 - 0.01, 30.0)       # segments 1-3, the harvest of 0
    got = {m: _read(m, run) for m in NEW}
    assert got["enqueue_ms"] == pytest.approx(0.3)
    assert got["stage_copy_ms"] == pytest.approx(2.0)
    assert got["launch_self_ms"] == pytest.approx(0.7)
    # segments 1 and 2 harvested (0.6 ms), 3 not yet (0): the median
    assert got["device_wait_ms"] == pytest.approx(0.6)
    # an upload wait and a harvest wait a segment of 1 s
    assert got["host_syncs_per_s"] == 2.0
    # the readback's three; the staging buffer's first fill is outside
    assert got["pinned_allocs_per_s"] == 3.0


def test_readers_on_a_symbol_segment():
    for k in range(3):
        t = 10.0 * k
        root = _fake("engine.track_capture_symbols", t, 5.0)
        _fake("engine.pack_rows", t, 0.2, root)
        _fake("engine.enqueue", t + 0.2, 0.8, root)
        red = _fake("engine.symbols.reduce", t + 1.0, 0.5, root)
        _fake("engine.symbols.offsets", t + 1.1, 0.2, red, wait=True)
        for j in range(11):
            _fake("engine.symbols.read", t + 1.5 + 0.3 * j, 0.3, root,
                  wait=True)
    got = {m: _read(m, _window(0.0, 30.0)) for m in NEW}
    assert got["enqueue_ms"] == pytest.approx(0.8)
    assert got["launch_self_ms"] == pytest.approx(5.0 - 0.8 - 0.5 - 3.3)
    assert got["device_wait_ms"] == pytest.approx(3.5)
    assert got["host_syncs_per_s"] == 12.0
    assert got["pinned_allocs_per_s"] == 0.0
    assert got["stage_copy_ms"] is None


def test_readers_are_silent_without_a_window_or_spans():
    for m in NEW:
        assert _read(m, _window(0.0, 10.0)) is None
        assert _read(m, types.SimpleNamespace(segments=[], traced=[])) is None


@pytest.mark.parametrize("name", CELLS)
def test_readers_on_a_tiny_cpu_run(name):
    cell = tiny_cell(name)
    dev = torch.device("cpu")
    with spans.recording():
        ctx, entry, tracer = harness.set_up(cell, 2**31 + 29, False, dev,
                                            time.perf_counter())
        harness.measure(ctx, entry, tracer, 0.5)
    got = {m: _read(m, ctx) for m in NEW}
    n = len(ctx.segments)
    enq = [s for s in spans.records() if s.name == "engine.enqueue"]
    # the warm-up's spans were recorded too, and are left out
    assert len(enq) > n >= 1
    assert got["enqueue_ms"] > 0 and got["launch_self_ms"] > 0
    # nothing blocks on a device on the CPU, nothing is pinned or staged
    assert got["device_wait_ms"] == 0.0
    assert got["host_syncs_per_s"] == 0.0
    assert got["pinned_allocs_per_s"] == 0.0
    assert got["stage_copy_ms"] is None


# ------------------------------------------------------------------ the card


def _traced(name, seed, off, monkeypatch):
    """One traced run of a cell in this process, the program's spans on,
    or off (`off`: the program's recording switch reads false), and the
    names of every event of its profile."""
    from gnssbench import trace

    names = set()
    summarize = trace.summarize

    def keep_names(prof):
        names.update(e.name() for e in prof.profiler.kineto_results.events())
        return summarize(prof)

    monkeypatch.setattr(trace, "summarize", keep_names)
    if off:
        monkeypatch.setattr(spans, "_profiler",
                            types.SimpleNamespace(_is_profiler_enabled=False))
    try:
        return harness.run(harness.load_cell(name), seed, 3.0, True, "cuda",
                           time.perf_counter()), names
    finally:
        monkeypatch.undo()


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_new_metrics(name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", name,
         "--seed", "2147483659", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=1200, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    mine = {m["name"] for m in harness.load_cell(name).per_layer}
    assert set(NEW) & mine <= set(res["metrics"])
    syncs = res["metrics"]["host_syncs_per_s"]["value"]
    if name.endswith(".symbols"):
        assert syncs == 12.0
    else:
        assert syncs == 2.0
        assert res["metrics"]["pinned_allocs_per_s"]["value"] == 3.0
    # the spans never reach the profiler's trace: no event of the profile
    # bears a span's name, and with the spans and without them the device
    # trace's metrics read alike (the idle share spreads widely from run
    # to run on a shared host; the roofline share, device time, does not)
    (on, on_names), (off, _) = (_traced(name, 2147483663, False, monkeypatch),
                                _traced(name, 2147483663, True, monkeypatch))
    assert "enqueue_ms" in on["metrics"]
    assert "enqueue_ms" not in off["metrics"]
    assert "aten::copy_" in on_names
    assert not any(n.startswith(("engine.", "stream.", "receiver."))
                   for n in on_names)
    idle = [r["metrics"]["device_idle_pct"]["value"] for r in (on, off)]
    assert abs(idle[0] - idle[1]) < 20.0, idle
    roof = [r["metrics"]["walk_roofline"]["value"] for r in (on, off)]
    assert abs(roof[0] - roof[1]) < 0.05 * roof[1], roof
