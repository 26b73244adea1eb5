"""The port's streaming receiver (Receiver.process_stream, device='cpu')
against the JAX package's process_stream (correlator='mxu', its chunked
path) on the same blocks: complex64, raw int16 I/Q ('ishort') and
nibble-packed 2-bit I/Q ('2bits_cpx'), 0.1 s blocks, 1 s segments.  Held
as ROADMAP.md "What held against the reference means" holds a receiver:
the same assignments, acquisition, bit sync, symbol counts and extended
channels, and every segment's tracking outputs with valid, start and
cur_len exact, Doppler, code delta and rem code at 2e-2, the fields the
JAX package ships as f16 at f16 resolution.  Also: the port's raw unpack
against convert_to_complex64 * scale, its stream against its own batch
process(), the refusals, and (slow) tests/test_streaming.py's three
24 s cases at their bars."""

import socket

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu.codes import gps_l1ca_code
from gnss_sdr_1_tpu.constants import GPS_L1_CA
from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
from gnss_sdr_1_tpu.runtime import ReceiverConfig as JReceiverConfig
from gnss_sdr_1_tpu.siggen.generator import SatParams, generate_baseband
from gnss_sdr_1_tpu.siggen.scenario import build_scenario
from gnss_sdr_1_tpu_torch.io.formats import FORMATS, convert_to_complex64
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.runtime.stream import (STREAM_FORMATS,
                                                 PinnedStaging, unpack_raw)
from test_torch_capture_cache import cached_capture
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
PRNS = (3, 8, 14, 22)
F16_RTOL = 2.0 ** -10        # one f16 ulp, relative


def _capture(prns, duration, t0_tow, fs=FS):
    scen = build_scenario(RX, list(prns), t0_tow=t0_tow, duration_s=duration,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(GPS_L1_CA, scen.sats,
                          {p: gps_l1ca_code(p) for p in prns}, fs, duration,
                          noise=True, seed=1234)
    return scen, x


def _ishort(x, scale=1000.0):
    iq = np.empty(2 * len(x), dtype=np.int16)
    iq[0::2] = np.clip(np.round(x.real * scale), -32767, 32767)
    iq[1::2] = np.clip(np.round(x.imag * scale), -32767, 32767)
    return iq


def _two_bit(x):
    """tests/test_streaming.py's 2-bit packing: nibble Q1 Q0 I1 I0, the
    most significant nibble first."""
    sigma = np.std(x.real)
    qi = np.clip(np.round(x.real * 0.7 / sigma), -2, 1).astype(np.int64)
    qq = np.clip(np.round(x.imag * 0.7 / sigma), -2, 1).astype(np.int64)
    nibs = (qi & 3) | ((qq & 3) << 2)
    n2 = len(nibs) // 2 * 2
    return ((nibs[0:n2:2] << 4) | nibs[1:n2:2]).astype(np.uint8)


def _blocks(raw, items_per_block):
    for pos in range(0, len(raw), items_per_block):
        yield pos, raw[pos:pos + items_per_block]


def _items_per_block(fmt, fs=FS):
    """Raw items in 0.1 s of signal."""
    n = int(0.1 * fs)
    if fmt is None:
        return n
    f = FORMATS[fmt]
    return n * f.items_per_sample // f.samples_per_item


def _recording(rx):
    """Record every TrackOutputs a receiver harvests (with its offset)."""
    seen = []
    harvest = rx._harvest

    def rec(outs, offset, decim=1, **kw):
        seen.append((outs, offset, decim))
        return harvest(outs, offset, decim=decim, **kw)

    rx._harvest = rec
    return seen


def _stream_both(raw, fmt):
    kw = dict(fs_hz=FS, n_channels=len(PRNS), prn_search=PRNS)
    rj = JReceiver(JReceiverConfig(correlator="mxu", **kw))
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    out = {}
    for name, rx in (("jax", rj), ("port", rt)):
        seen = _recording(rx)
        rx.process_stream(_blocks(raw, _items_per_block(fmt)),
                          segment_s=1.0, raw_format=fmt)
        out[name] = (rx, seen)
    return out


@pytest.fixture(scope="module")
def capture(one_torch_thread):  # noqa: F811
    # the receiver file's capture: four equal 1 s segments from a subframe
    # head, every channel bit-synced and extended by the end
    return _capture(PRNS, 4.0 + 2e-3, 345606.1)


@pytest.fixture(scope="module")
def runs(capture):
    _, x = capture
    return {"complex": _stream_both(x, None),
            "ishort": _stream_both(_ishort(x), "ishort"),
            "2bits_cpx": _stream_both(_two_bit(x), "2bits_cpx")}


def _close_f16(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("kind", ["complex", "ishort", "2bits_cpx"])
def test_stream_matches_jax(runs, kind):
    (rj, sj), (rt, st) = runs[kind]["jax"], runs[kind]["port"]
    # the same channel FSM: assignments, acquisition, bit sync, symbols
    assert rt.channel_prn == rj.channel_prn
    assert None not in rt.channel_prn
    assert set(rt._acq_info) == set(rj._acq_info)
    for prn, (dj, fj, sj_) in rj._acq_info.items():
        dt, ft, st_ = rt._acq_info[prn]
        assert ft == fj and st_ == sj_ and abs(dt - dj) <= 1.0, prn
    assert rt.sym_count == rj.sym_count
    assert list(rt._mode_host) == list(rj._mode_host)
    for prn, dj in rj.decoders.items():
        assert rt.decoders[prn].bit_offset == dj.bit_offset, prn
    assert rt._abs_base == rj._abs_base == 4 * int(FS) and rt._pos == 0
    assert rt._ingest_scale == pytest.approx(rj._ingest_scale, rel=1e-6)
    # every segment's tracking outputs, harvested one segment behind
    assert [(o, d) for _, o, d in st] == [(o, d) for _, o, d in sj]
    assert len(st) == 4
    for (ot, _, _), (oj, off, _) in zip(st, sj):
        np.testing.assert_array_equal(ot.valid, oj.valid)
        v = oj.valid
        assert v.sum() > 0.9 * 1000 * len(PRNS), off
        np.testing.assert_array_equal(ot.start[v], oj.start[v])
        np.testing.assert_array_equal(ot.cur_len[v], oj.cur_len[v])
        np.testing.assert_array_equal(ot.active, oj.active)
        for name in ("carrier_doppler_hz", "rem_code_phase_samples"):
            np.testing.assert_allclose(getattr(ot, name)[v],
                                       getattr(oj, name)[v], rtol=0,
                                       atol=2e-2, err_msg=name)
        _close_f16(ot.code_freq_delta[v], oj.code_freq_delta[v], 2e-2,
                   "delta")
        # the prompt's sign in every epoch of a channel in lock
        pj = oj.correlators[..., 1, 0]
        pt = ot.correlators[..., 1].real
        big = v & (np.abs(pj) > 0.1 * np.abs(pj[v]).max())
        np.testing.assert_array_equal(np.sign(pt[big]), np.sign(pj[big]))


def test_stream_matches_batch_process(capture, runs):
    """The port's stream and its batch process() on the same capture: the
    same assignments, bit sync and symbol counts (this capture has every
    epoch of its last segment; nothing is lost or reacquired)."""
    _, x = capture
    rb = Receiver(ReceiverConfig(fs_hz=FS, n_channels=len(PRNS),
                                 prn_search=PRNS), device="cpu")
    rb.process(x)
    rs = runs["complex"]["port"][0]
    assert rs.channel_prn == rb.channel_prn
    assert rs.sym_count == rb.sym_count
    assert list(rs._mode_host) == list(rb._mode_host) == [1] * len(PRNS)
    for prn, d in rb.decoders.items():
        assert rs.decoders[prn].bit_offset == d.bit_offset is not None
    assert rs._abs_base == rb._abs_base


@pytest.mark.parametrize("fmt", STREAM_FORMATS)
def test_unpack_matches_host_conversion(fmt):
    """unpack_raw on the CPU against io.formats' host conversion times the
    scale, element by element, for every format the stream accepts."""
    f = FORMATS[fmt]
    rng = np.random.default_rng(3)
    if f.dtype == np.uint8:
        raw = rng.integers(0, 256, size=4096).astype(np.uint8)
    else:
        info = np.iinfo(f.dtype)
        raw = rng.integers(info.min, info.max, size=4096, endpoint=True,
                           dtype=np.int64).astype(f.dtype)
    scale = 1.0 / 1234.5
    got = unpack_raw(torch.from_numpy(raw), fmt, scale).numpy()
    want = convert_to_complex64(raw, f) * np.float32(scale)
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # staging on the CPU hands the items over as they are
    staged = PinnedStaging(torch.device("cpu")).upload(raw)
    np.testing.assert_array_equal(staged.numpy(), raw)


def test_stream_refusals():
    kw = dict(fs_hz=FS, n_channels=1, prn_search=(3,))
    kf = Receiver(ReceiverConfig(track_engine="kf", **kw), device="cpu")
    with pytest.raises(ValueError, match="DLL/PLL engine"):
        kf.process_stream(iter(()))
    rx = Receiver(ReceiverConfig(**kw), device="cpu")
    for fmt in ("gr_complex", "4bits_cpx", "short", "ubyte_iq"):
        with pytest.raises(ValueError, match="ishort/ibyte/cshort/cbyte"):
            rx.process_stream(iter(()), raw_format=fmt)
    # 2bits_cpx carries two samples a byte: an odd span is refused
    odd = Receiver(ReceiverConfig(fs_hz=2.047e6, block_ms=1, n_channels=1,
                                  prn_search=(3,)), device="cpu")
    with pytest.raises(ValueError, match="whole raw items"):
        odd.process_stream(iter(()), segment_s=1e-3, raw_format="2bits_cpx")
    # nothing was consumed or stamped
    assert rx._abs_base == odd._abs_base == 0


def test_stream_reassigned_channel_keeps_its_own_epochs():
    """A satellite that fades (1.2-2.5 s) loses lock and is acquired again
    on its channel.  The acquisition for segment k+1 runs before segment
    k is harvested, so when k is harvested the channel already holds the
    new assignment while k's rows are the lost one's: the harvest skips
    the channel (the JAX package's stream takes k's empty rows for a lost
    lock and releases the new assignment, and a later reassignment then
    hands one decoder the epochs of two activations)."""
    sats = [SatParams(prn=3, doppler_hz=1200.0, delay_chips=300.25,
                      cn0_dbhz=48.0)]
    x = generate_baseband(GPS_L1_CA, sats, {3: gps_l1ca_code(3)}, FS, 6.0,
                          noise=True, seed=5)
    fade = generate_baseband(
        GPS_L1_CA, [SatParams(prn=8, doppler_hz=-600.0, delay_chips=512.75)],
        {8: gps_l1ca_code(8)}, FS, 6.0, noise=False)
    fade *= np.float32(np.sqrt(10.0 ** 4.8 / FS))
    fade[int(1.2 * FS):int(2.5 * FS)] = 0
    x = (x + fade).astype(np.complex64)
    rx = Receiver(ReceiverConfig(fs_hz=FS, n_channels=2, prn_search=(3, 8)),
                  device="cpu")
    assigned, released = [], []
    acquire, release = rx._acquire_and_assign, rx._release

    def rec_acquire(offset, samples):
        before = list(rx.channel_prn)
        acquire(offset, samples)
        assigned.extend((ch, p, offset) for ch, p in enumerate(rx.channel_prn)
                        if p is not None and before[ch] is None)

    rx._acquire_and_assign = rec_acquire
    rx._release = lambda ch, prn, why: (released.append((ch, prn, why)),
                                        release(ch, prn, why))
    rx.process_stream(_blocks(x, _items_per_block(None)))
    # PRN 8: lost once (the fade), acquired again once, never released
    # again; PRN 3 held throughout
    assert [p for _, p, _ in assigned].count(8) == 2, assigned
    assert [(p, why) for _, p, why in released] == [(8, "lost lock")]
    assert None not in rx.channel_prn
    for prn, d in rx.decoders.items():
        st = np.asarray(d._sym.start_samples)
        # one activation's epochs: every step one code period
        assert np.all(np.abs(np.diff(st) - FS * 1e-3) <= 1.5), prn
    back = next(off for _, p, off in assigned[1:] if p == 8)
    assert rx.decoders[8]._sym.start_samples[0] >= back
    assert rx.sym_count[8] >= 1000


def test_stream_standby_consumes_nothing(capture):
    _, x = capture
    rx = Receiver(ReceiverConfig(fs_hz=FS, n_channels=len(PRNS),
                                 prn_search=PRNS), device="cpu")
    rx.standby()
    rx.process_stream(_blocks(x, _items_per_block(None)))
    assert rx._abs_base == 0 and not rx.sym_count


# ---------------------------------------------------------------------------
# tests/test_streaming.py's three cases, at full size (slow)
# ---------------------------------------------------------------------------

FS_FULL = 4.0e6
FULL_S = 24.0
FULL_PRNS = (1, 2, 3, 4, 5, 6)


@pytest.fixture(scope="module")
def full_capture(one_torch_thread):  # noqa: F811
    scen = build_scenario(RX, list(FULL_PRNS), t0_tow=345601.25,
                          duration_s=FULL_S, cn0_dbhz=47.0,
                          subframe_cycle=(1, 2, 3))
    x = cached_capture(
        f"syspos_{FS_FULL:.0f}_{FULL_S:.0f}",
        lambda: generate_baseband(GPS_L1_CA, scen.sats,
                                  {p: gps_l1ca_code(p) for p in FULL_PRNS},
                                  FS_FULL, FULL_S, noise=True))
    return scen, x


def _full_stream(raw, fmt, **cfg_kw):
    rx = Receiver(ReceiverConfig(fs_hz=FS_FULL, n_channels=6,
                                 prn_search=FULL_PRNS, **cfg_kw),
                  device="cpu")
    sols = rx.process_stream(_blocks(raw, _items_per_block(fmt, FS_FULL)),
                             segment_s=1.0, raw_format=fmt)
    return rx, sols


def _median_3d(scen, sols):
    e = np.stack([s.rx_ecef_m - scen.rx_ecef for s in sols])
    return float(np.median(np.linalg.norm(e, axis=1)))


@pytest.mark.slow
def test_full_stream_complex_blocks_with_pvt_monitor(full_capture):
    """Complex blocks at tests/test_streaming.py's bar (>= 20 fixes, median
    3D < 5 m), the PVT monitor on: one datagram a fix."""
    scen, x = full_capture
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    _, sols = _full_stream(x, None, enable_pvt_monitor=True,
                           pvt_monitor_port=sock.getsockname()[1])
    assert len(sols) >= 20 and _median_3d(scen, sols) < 5.0
    sock.setblocking(False)
    n = 0
    while True:
        try:
            sock.recv(65536)
        except BlockingIOError:
            break
        n += 1
    sock.close()
    assert n == len(sols)


@pytest.mark.slow
def test_full_stream_raw_ishort_blocks(full_capture):
    scen, x = full_capture
    _, sols = _full_stream(_ishort(x), "ishort")
    assert len(sols) >= 20 and _median_3d(scen, sols) < 5.0


@pytest.mark.slow
def test_full_stream_2bit_packed_blocks(full_capture):
    scen, x = full_capture
    _, sols = _full_stream(_two_bit(x), "2bits_cpx")
    assert len(sols) >= 20 and _median_3d(scen, sols) < 8.0
