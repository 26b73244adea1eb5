"""The port's host spans (`gnss_sdr_1_tpu_torch/utils/spans.py`): the span
tree, its parent and segment ids and self time; nothing recorded and
nothing allocated while off; recording under torch.profiler and inside
`spans.recording()`; the ring's bound; `dump`'s Chrome-trace JSON; the
names that the engine, the stream ingest and the receiver emit on the CPU
path, in order.  On the card (`gpu`): a span around a kernel maps onto the
profiler's clock within 50 µs, a GPS symbol segment makes one wait span
(the symbol grid's one read) and no pinned allocation once the engine's
buffer exists, an E1B stream segment 2 waits and 3 pinned allocations."""

import collections
import json
import time
import tracemalloc

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.codes import (galileo_e1_sinboc11,
                                        galileo_e1b_code, gps_l1ca_code)
from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.runtime.stream import PinnedStaging, unpack_raw
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.utils import spans
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
SATS = [SatParams(prn=3, doppler_hz=1200.0, delay_chips=300.5,
                  cn0_dbhz=48.0),
        SatParams(prn=8, doppler_hz=-2500.0, delay_chips=700.25,
                  cn0_dbhz=48.0)]


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def _names(recs):
    return [s.name for s in recs]


def _capture(duration):
    return generate_baseband(GPS_L1_CA, SATS, {s.prn: gps_l1ca_code(s.prn)
                                               for s in SATS}, FS, duration)


def _gps_engine(device, n_ch=2, fs=FS):
    codes = np.stack([gps_l1ca_code(s.prn) for s in SATS[:n_ch]])
    eng = TrackingEngine(TrackConfig(
        fs_hz=fs, code_length_chips=1023, chip_rate_chips_s=1.023e6,
        carrier_freq_hz=GPS_L1_CA.carrier_freq_hz, n_channels=n_ch,
        chunk_epochs=16), codes, device=device)
    st = eng.init_state()
    for ch, s in enumerate(SATS[:n_ch]):
        st = eng.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * fs,
                                  s.doppler_hz, 0, 0)
    return eng, st


# --------------------------------------------------------------- the module


def test_span_tree_segments_and_self_time():
    with spans.recording():
        with spans.span("a") as a:
            with spans.span("a.b") as b:
                b.count("bytes", 5)
                b.count("bytes", 2)
                with spans.wait("a.b.w"):
                    time.sleep(0.002)
            with spans.span("a.c", segment=77) as c:
                with spans.span("a.c.d") as d:
                    pass
        with spans.span("e") as e:
            pass
    assert _names(spans.records()) == ["a", "a.b", "a.b.w", "a.c", "a.c.d",
                                       "e"]
    w = spans.records()[2]
    assert (a.parent, b.parent, w.parent, c.parent, d.parent, e.parent) == (
        None, a.id, b.id, a.id, c.id, None)
    # the segment is the root's id; a handed-over segment is adopted and
    # inherited
    assert a.segment == b.segment == w.segment == a.id
    assert c.segment == d.segment == 77 and e.segment == e.id != a.id
    assert b.counts == {"bytes": 7} and w.wait and not b.wait
    assert a.start_ns <= b.start_ns <= w.start_ns <= w.end_ns <= b.end_ns \
        <= c.start_ns <= d.end_ns <= c.end_ns <= a.end_ns <= e.start_ns
    assert w.dur_ns >= 2_000_000
    self_ns = a.dur_ns - b.dur_ns - c.dur_ns
    assert 0 <= self_ns < a.dur_ns - w.dur_ns
    # a tree shares one clock offset, measured at its root
    assert a.clock_ns == b.clock_ns == d.clock_ns
    assert abs(a.start_ns + a.clock_ns - time.time_ns()) < 10**9


def test_nothing_recorded_or_allocated_when_off():
    assert spans.span("x") is spans.OFF and spans.wait("x") is spans.OFF
    assert not spans.OFF and spans.OFF.segment is None

    def sites():
        with spans.span("x") as s:
            s.count("n", 3)
            with spans.wait("y") as w:
                if w:
                    raise AssertionError("a wait span while off")

    sites()
    tracemalloc.start()
    try:
        for _ in range(2000):
            sites()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = snap.filter_traces([tracemalloc.Filter(True, spans.__file__)])
    assert sum(st.size for st in mine.statistics("filename")) == 0
    assert spans.records() == []


def test_recording_switches_on_under_the_profiler_and_recording():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("under.profile") as s:
            torch.ones(8).sum()
    assert s and spans.span("x") is spans.OFF
    p = profile(activities=[ProfilerActivity.CPU])
    p.start()
    with spans.span("under.start"):
        pass
    p.stop()
    with spans.span("off"):
        pass
    with spans.recording():
        with spans.recording():
            with spans.span("nested.recording"):
                pass
        with spans.span("under.recording"):
            pass
    with spans.span("off.again"):
        pass
    assert _names(spans.records()) == ["under.profile", "under.start",
                                       "nested.recording", "under.recording"]
    # the spans are never profiler ranges
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::sum" in names and "under.profile" not in names


def test_ring_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=5))
    with spans.recording():
        for k in range(12):
            with spans.span(f"s{k}"):
                pass
    assert _names(spans.records()) == [f"s{k}" for k in range(7, 12)]
    assert spans.CAPACITY >= 1 << 14


def test_dump_writes_chrome_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("root") as r:
            with spans.wait("root.wait") as w:
                w.count("ready", 1)
            torch.ones(8).sum()
    assert spans.dump(tmp_path / "s.json") == 2
    doc = json.loads((tmp_path / "s.json").read_text())
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert set(ev) == {"root", "root.wait"}
    e = ev["root.wait"]
    assert e["ph"] == "X" and e["cat"] == "wait"
    assert e["ts"] == pytest.approx((w.start_ns + w.clock_ns) / 1e3)
    assert e["dur"] == pytest.approx(w.dur_ns / 1e3)
    assert e["args"] == {"id": w.id, "parent": r.id, "segment": r.id,
                         "wait": 1, "ready": 1}
    assert ev["root"]["cat"] == "host" and ev["root"]["tid"] == e["tid"]
    # merged into the profiler's own export, on its time base
    prof.export_chrome_trace(str(tmp_path / "p.json"))
    assert spans.dump(tmp_path / "m.json", tmp_path / "p.json") == 2
    merged = json.loads((tmp_path / "m.json").read_text())
    base = merged["baseTimeNanoseconds"]
    names = [x.get("name") for x in merged["traceEvents"]]
    assert "aten::sum" in names and "root" in names
    root = next(x for x in merged["traceEvents"] if x.get("name") == "root")
    assert root["ts"] == pytest.approx((r.start_ns + r.clock_ns - base)
                                       / 1e3)


# ------------------------------------------------------ the program's spans


def test_engine_and_stream_names_on_the_cpu():
    x = torch.from_numpy(_capture(0.12))
    eng, st = _gps_engine("cpu")
    span = int(FS * 0.04)
    with spans.recording():
        st1, rb0 = eng.launch_capture(x, st, span)
        _, rb1 = eng.launch_capture(x[span:], st1, span)
        eng.harvest_capture(rb0)
        eng.harvest_capture(rb1)
        eng.track_capture_symbols(x, st, span, np.array([5, 9]), 20)
        raw = np.arange(64, dtype=np.int16)
        unpack_raw(PinnedStaging(torch.device("cpu")).upload(raw), "ishort",
                   0.5)
    recs = spans.records()
    launch = ["engine.launch_capture", "engine.pack_rows", "engine.enqueue",
              "engine.read_back"]
    assert _names(recs) == launch + launch + [
        "engine.harvest_capture", "engine.harvest_capture",
        "engine.track_capture_symbols", "engine.pack_rows", "engine.enqueue",
        "engine.symbols.reduce", "stream.upload", "stream.unpack"]
    # each harvest joins its own launch's segment, with k+1 launched
    # between the launch and the harvest of k
    roots = [s for s in recs if s.parent is None]
    assert [s.segment for s in roots[2:4]] == [roots[0].id, roots[1].id]
    assert rb0.segment == roots[0].id and rb1.segment == roots[1].id
    # no wait on the CPU: nothing blocks on a device
    assert not any(s.wait for s in recs)
    assert all(s.counts == {} for s in recs)


def test_receiver_names_on_the_cpu():
    x = _capture(0.25)
    rx = Receiver(ReceiverConfig(fs_hz=FS, n_channels=2, prn_search=(3, 8),
                                 reacq_interval_blocks=2), device="cpu")
    with spans.recording():
        rx.process(x)
    recs = spans.records()
    segment = ["receiver.segment", "receiver.acquire",
               "engine.launch_capture", "engine.pack_rows", "engine.enqueue",
               "engine.read_back", "engine.harvest_capture",
               "receiver.harvest", "receiver.observables_pvt"]
    assert rx.channel_prn == [3, 8]
    assert _names(recs) == segment * 3
    roots = [s for s in recs if s.parent is None]
    assert all(s.segment == r.id for r in roots for s in recs
               if r.start_ns <= s.start_ns <= r.end_ns)


def test_receiver_stream_names_on_the_cpu():
    x = _capture(0.3)
    iq = np.empty(2 * len(x), np.int16)
    iq[0::2] = np.round(x.real * 500)
    iq[1::2] = np.round(x.imag * 500)
    rx = Receiver(ReceiverConfig(fs_hz=FS, n_channels=2, prn_search=(3, 8)),
                  device="cpu")
    blocks = ((k, iq[k:k + 40_000]) for k in range(0, len(iq), 40_000))
    with spans.recording():
        rx.process_stream(blocks, segment_s=0.08, raw_format="ishort")
    recs = spans.records()
    roots = [s for s in recs if s.parent is None]
    assert [s.name for s in roots] == ["receiver.segment"] * 6

    def children(r):
        return _names(s for s in recs if s.parent == r.id)

    launch = ["stream.upload", "stream.unpack", "engine.launch_capture"]
    harvest = ["engine.harvest_capture", "receiver.harvest",
               "receiver.observables_pvt"]
    # launch 0, launch 1, harvest 0, launch 2, harvest 1, harvest 2: each
    # harvest half under the segment id of its launch half
    assert [children(r) for r in roots] == [
        ["receiver.acquire"] + launch, launch, harvest, launch, harvest,
        harvest]
    assert [r.segment for r in roots] == [roots[i].id
                                          for i in (0, 1, 0, 3, 1, 3)]


# ------------------------------------------------------------------ the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
def test_span_maps_onto_the_device_trace():
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    x = torch.randn(1 << 24, device=dev)

    def step():
        with spans.span("test.kernel"):
            torch.cuda._sleep(2_000_000)
            x.mul_(1.0001)
            torch.cuda.synchronize()

    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
            time.sleep(0.01)
    events = prof.profiler.kineto_results.events()
    kern = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events if "CUDA" in str(e.device_type())
                  and not e.name().startswith(("Memcpy", "Memset")))
    syncs = sorted(e.start_ns() + e.duration_ns() for e in events
                   if e.name() == "cudaDeviceSynchronize")
    recs = [r for r in spans.records() if r.name == "test.kernel"][-3:]
    assert len(kern) == 6 and len(recs) == 3, (kern, recs)
    for k, r in enumerate(recs):
        lo, hi = r.start_ns + r.clock_ns, r.end_ns + r.clock_ns
        (k0, _), (_, k1) = kern[2 * k], kern[2 * k + 1]
        sync = max(t for t in syncs if t <= hi + 1_000_000)
        got = dict(launch=k0 - lo, end=hi - k1, sync=hi - sync, span=hi - lo)
        # the span brackets both kernels' device interval, and the end of
        # the synchronize that closes it, a host event of the profiler's
        # own, falls on the span's end
        assert k0 - lo >= -50_000 and hi - k1 >= -50_000, got
        assert -50_000 <= hi - sync <= 50_000, got


def _per_segment(recs):
    out = collections.defaultdict(list)
    for s in recs:
        out[s.segment].append(s)
    return list(out.values())


@pytest.mark.gpu
def test_gps_symbol_segment_makes_one_wait():
    dev = _card()
    fs = 2.0e6
    x = torch.from_numpy(generate_baseband(
        GPS_L1_CA, SATS, {s.prn: gps_l1ca_code(s.prn) for s in SATS}, fs,
        1.1)).to(dev)
    eng, st = _gps_engine(dev, fs=fs)
    span = int(fs * 0.5)
    eng.track_capture_symbols(x, st, span, np.array([5, 9]), 20)   # build
    spans.clear()
    with spans.recording():
        for k in range(2):
            st, _ = eng.track_capture_symbols(x[k * span:], st, span,
                                              np.array([5, 9]), 20)
    for seg in _per_segment(spans.records()):
        waits = [s.name for s in seg if s.wait]
        assert waits == ["engine.symbols.read"]
        assert sum(s.counts.get("pinned_allocs", 0) for s in seg) == 0


@pytest.mark.gpu
def test_e1b_stream_segment_makes_two_waits_and_three_pinned_allocs():
    dev = _card()
    fs, prns = 4.0e6, (1, 2)
    codes = np.stack([galileo_e1_sinboc11(galileo_e1b_code(p))
                      for p in prns])
    eng = TrackingEngine(TrackConfig(
        fs_hz=fs, code_length_chips=4092, chip_rate_chips_s=1.023e6,
        carrier_freq_hz=GPS_L1_CA.carrier_freq_hz, n_channels=len(prns),
        code_samples_per_chip=2, veml=True,
        correlator="gather"), codes, device=dev)
    st0 = eng.init_state()
    for ch in range(len(prns)):
        st0 = eng.activate_channel(st0, ch, ch, 100.0 + 900 * ch, 500.0, 0,
                                   0)
    span = int(fs * 0.2)
    n = span + eng.cfg.epoch_samples_max
    rng = np.random.default_rng(3)
    raw = rng.integers(-300, 300, size=2 * (6 * span + n), dtype=np.int16)
    staging = PinnedStaging(dev)
    pending, st = [], st0
    for k in range(6):
        if k == 3:      # both staging buffers and the build are warm
            torch.cuda.synchronize()
            spans.clear()
            rec = spans.recording()
            rec.__enter__()
        seg = unpack_raw(staging.upload(raw[2 * k * span:2 * (k * span + n)]),
                         "ishort", 0.01)
        st, rb = eng.launch_capture(seg, st, span)
        pending.append(rb)
        if len(pending) > 1:
            eng.harvest_capture(pending.pop(0))
    eng.harvest_capture(pending.pop(0))
    rec.__exit__(None, None, None)
    recs = spans.records()
    uploads = [s for s in recs if s.name == "stream.upload"]
    assert len(uploads) == 3
    for u in uploads:
        seg = [s for s in recs if s.segment == u.segment]
        assert [s.name for s in seg if s.wait] == ["stream.upload.wait"]
        assert u.counts.get("pinned_allocs", 0) == 0
    launches = [s for s in recs if s.name == "engine.launch_capture"]
    assert len(launches) == 3
    for lc in launches:
        seg = [s for s in recs if s.segment == lc.segment]
        assert [s.name for s in seg if s.wait] == ["engine.harvest.wait"]
        assert sum(s.counts.get("pinned_allocs", 0) for s in seg) == 3
