"""The stream path's front end (runtime.stream.StreamFrontEnd and
ops/xlate_fir.py) on the CPU: the plain version against the tests' own
plain reference (tests/plain_front_end.py), a stream cut into segments of
uneven length against one pass over it bit for bit, the batch
FrontEnd.process beside it, the conf's plans, and a conditioned
process_stream against FrontEnd.process + process on the same NSR-like
capture.  (`gpu`, on the card: the kernel against the plain version at the
NSR cell's widths and at the GPS ishort shape.)

Tolerances and why:
- plain version against the plain reference, 1e-5 of the output's RMS:
  both sum 65 float32 products of the same operands (|x| <= 2 for 2-bit
  samples, sum |h| ~ 1.2), in other orders, and the reference rounds each
  mixed sample to float32 where the front end rotates the sum once: a
  few float32 ulps of the largest partial sum (~1e-6 measured);
- against the batch FrontEnd.process with an IF, 3e-2 of the RMS: the
  batch Conditioner's mixer phase is float32, phase0 + step * n over
  2^17-sample blocks, whose rounding at 2^17 |step| rad (|step| ~ 1.6 rad
  at the NSR conf's IF) and whose float32 step reach ~1e-2 rad by a
  block's end (2.2e-2 of the RMS measured), where the stream's phase is
  exact; without an IF 1e-5, as above; Direct_Resampler alone bit for
  bit (one tap of 1.0 and no rotation take the samples as they are).
"""

import pathlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_1_tpu_torch.constants import SIGNALS
from gnss_sdr_1_tpu_torch.io.formats import FORMATS, convert_to_complex64
from gnss_sdr_1_tpu_torch.ops import xlate_fir as xf
from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.runtime.config import (FileConfiguration,
                                                 FrontEnd, build_frontend,
                                                 to_receiver_config)
from gnss_sdr_1_tpu_torch.runtime.stream import StreamFrontEnd
from gnss_sdr_1_tpu_torch.siggen.generator import generate_baseband
from gnss_sdr_1_tpu_torch.siggen.scenario import build_scenario
import plain_front_end as pfe
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONF = pathlib.Path(__file__).resolve().parent.parent / "conf"
NSR_FS, NSR_IF = 20.48e6, 5499998.47412109
REF_RTOL = 1e-5
BATCH_IF_RTOL = 3e-2


def _raw(fmt, n_samples, seed):
    rng = np.random.default_rng(seed)
    if fmt == "nsr":
        return rng.integers(0, 256, n_samples // 4, dtype=np.uint8)
    return rng.integers(-3000, 3000, 2 * n_samples).astype(np.int16)


def _front_end(fmt, if_hz, decim):
    """A conditioner of the NSR conf's shape (65 taps) at decimation
    `decim`, for a real 2-bit (nsr) or an ishort source."""
    return FrontEnd(source_fs_hz=NSR_FS, internal_fs_hz=NSR_FS / decim,
                    if_freq_hz=if_hz, filter_impl="Freq_Xlating_Fir_Filter")


def _rms(y):
    return float(np.sqrt(np.mean(np.abs(y) ** 2)))


def _segmented(fe, fmt, raw, spans, nmax, scale):
    """The stream's outputs, segment by segment as process_stream cuts
    them: each segment stages its (span + nmax) D source samples from its
    first output's and hands `span` outputs on."""
    sfe = StreamFrontEnd(fe, fmt, "cpu")
    pos, outs = 0, []
    for span in spans:
        n_out = span + nmax
        a, b = sfe.items(pos * sfe.decim), sfe.items((pos + n_out) *
                                                     sfe.decim)
        outs.append((pos, sfe.condition(torch.from_numpy(raw[a:b]), n_out,
                                        span, scale).numpy()))
        pos += span
    return outs


@pytest.mark.parametrize("fmt", ["nsr", "ishort"])
@pytest.mark.parametrize("if_hz", [NSR_IF, 0.0])
@pytest.mark.parametrize("decim", [8, 2])
def test_front_end_seams_and_plain_reference(fmt, if_hz, decim):
    """Segments of uneven length give the bits of one pass, and one pass
    agrees with the plain reference to REF_RTOL of its RMS."""
    fe = _front_end(fmt, if_hz, decim)
    n_out = 6000
    raw = _raw(fmt, n_out * decim, seed=decim)
    scale = 0.37
    whole = StreamFrontEnd(fe, fmt, "cpu").condition(
        torch.from_numpy(raw), n_out, n_out, scale).numpy()
    taps, D, _ = fe.stream_plan()
    assert D == decim and len(taps) == 65
    want = pfe.front_end(raw, pfe.Plan(fmt, NSR_FS, if_hz, D, taps), 0,
                         n_out, scale).numpy()
    assert np.abs(whole - want).max() <= REF_RTOL * _rms(want)
    # even spans and overlaps: whole bytes of nsr at D = 2
    nmax = 174
    for pos, y in _segmented(fe, fmt, raw, [1500, 998, 2000, 1202], nmax,
                             scale):
        np.testing.assert_array_equal(y.view(np.uint32),
                                      whole[pos:pos + len(y)].view(np.uint32))


def test_front_end_from_any_output_matches_the_reference():
    """A front end that starts mid-stream (its history from the items
    before it) at a large absolute output: the mixer's phase is exact
    there, where a float32 product of a step and an index would have lost
    whole radians."""
    fe = _front_end("nsr", NSR_IF, 8)
    raw = _raw("nsr", 8 * 4000, seed=5)
    sfe = StreamFrontEnd(fe, "nsr", "cpu")
    m0 = 123_456_789_012                  # ~13.4 h at 2.56 Msps
    sfe.next_out = m0 + 1000
    h = sfe.items(sfe.n_hist)
    sfe._hist = torch.from_numpy(raw[sfe.items(8000) - h:sfe.items(8000)])
    got = sfe.condition(torch.from_numpy(raw[sfe.items(8000):]), 3000,
                        3000, 1.0).numpy()
    taps, D, _ = fe.stream_plan()
    # the reference's mixer at absolute sample n: the capture shifted by
    # m0 outputs, the shift's phase reduced exactly
    f = -Fraction(NSR_IF) * D * m0 / Fraction(NSR_FS)
    turns = float(f - (f.numerator // f.denominator))
    want = pfe.front_end(raw, pfe.Plan("nsr", NSR_FS, NSR_IF, D, taps),
                         1000, 3000).numpy() \
        * np.complex64(np.exp(2j * np.pi * turns))
    assert np.abs(got - want).max() <= 1e-4 * _rms(want)


@pytest.mark.parametrize("if_hz", [NSR_IF, 0.0])
def test_front_end_against_the_batch_front_end(if_hz):
    fe = _front_end("nsr", if_hz, 8)
    raw = _raw("nsr", 8 * 20_000, seed=11)
    batch = fe.process(convert_to_complex64(raw, FORMATS["nsr"]),
                       device="cpu")
    got = StreamFrontEnd(fe, "nsr", "cpu").condition(
        torch.from_numpy(raw), len(batch), len(batch), 1.0).numpy()
    rtol = BATCH_IF_RTOL if if_hz else REF_RTOL
    assert np.abs(got - batch).max() <= rtol * _rms(batch)


def test_direct_resampler_is_the_batch_one_bit_for_bit():
    fe = build_frontend(FileConfiguration(str(CONF / "gps_l1_ishort.conf")))
    raw = _raw("ishort", 30_000, seed=3)
    batch = fe.process(convert_to_complex64(raw, FORMATS["ishort"]))
    sfe = StreamFrontEnd(fe, "ishort", "cpu")
    assert (sfe.decim, sfe.n_taps, sfe.n_hist) == (2, 1, 0)
    got = sfe.condition(torch.from_numpy(raw), len(batch), len(batch),
                        1.0).numpy()
    np.testing.assert_array_equal(got, batch)


def test_stream_plans_of_the_confs():
    nsr = build_frontend(FileConfiguration(str(CONF / "gps_l1_nsr.conf")))
    taps, D, if_hz = nsr.stream_plan()
    assert (len(taps), D, if_hz) == (65, 8, NSR_IF)
    np.testing.assert_array_equal(taps, nsr.filter_design()[0])
    rc = to_receiver_config(FileConfiguration(str(CONF / "gps_l1_nsr.conf")))
    assert rc.front_end == nsr and rc.fs_hz == 2_560_000
    ishort = build_frontend(FileConfiguration(
        str(CONF / "gps_l1_ishort.conf")))
    taps, D, if_hz = ishort.stream_plan()
    assert (list(taps), D, if_hz) == ([1.0], 2, 0.0)
    assert FrontEnd(4e6, 4e6).stream_plan() is None
    for bad in (FrontEnd(4e6, 1.5e6, resampler_impl="Direct_Resampler"),
                FrontEnd(4e6, 2e6, resampler_impl="Fractional_Resampler"),
                FrontEnd(2e6, 4e6, resampler_impl="Direct_Resampler")):
        with pytest.raises(ValueError, match="whole-number rate ratios"):
            bad.stream_plan()
    with pytest.raises(ValueError, match="decodes"):
        StreamFrontEnd(nsr, "2bits_cpx", "cpu")


def test_phase_step_is_exact():
    F = xf.phase_step(NSR_IF, NSR_FS, 8)
    f = -NSR_IF * 8 / NSR_FS
    assert abs(F / 2.0 ** 64 - (f - np.floor(f))) < 1e-15
    assert xf.fixed_phase(2 ** 40 + 3, F) == ((2 ** 40 + 3) * F) % 2 ** 64
    assert xf.phase_step(0.0, NSR_FS, 8) == 0


# ----------------------------------------------- the receiver, stream/batch

FS_INT, DECIM, IF_HZ = 1.5e6, 8, 3.1234567e6
PRNS = (3, 8)
SPAN = 720_000                    # 12 blocks of 40 ms at 1.5 Msps


@pytest.fixture(scope="module")
def nsr_capture(one_torch_thread):  # noqa: F811
    """Three 0.48 s segments of GPS L1 C/A (two satellites, 50 dB-Hz at
    1.5 Msps), held eight times to 12 Msps, mixed up to a 3.12 MHz IF,
    its real part quantised to NSR's 2-bit code and packed four a byte:
    the NSR conf's structure (D = 8, a real 2-bit IF) at a reduced rate."""
    rx = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    n_int = 3 * SPAN + 1502
    scen = build_scenario(rx, list(PRNS), t0_tow=345606.1,
                          duration_s=n_int / FS_INT, cn0_dbhz=50.0,
                          subframe_cycle=(1, 2, 3))
    x = generate_baseband(SIGNALS["1C"], scen.sats,
                          {p: gps_l1ca_code(p) for p in PRNS}, FS_INT,
                          n_int / FS_INT, noise=True, seed=7)
    up = torch.from_numpy(np.repeat(x, DECIM))
    n = torch.arange(up.shape[0], dtype=torch.float64)
    turns = torch.remainder(n * (IF_HZ / (FS_INT * DECIM)), 1.0)
    real = up.real.double() * torch.cos(2 * np.pi * turns) \
        - up.imag.double() * torch.sin(2 * np.pi * turns)
    q = torch.clamp(torch.floor(real / real.std()), -2, 1).long() & 3
    q = q.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
            | (q[:, 3] << 6)).to(torch.uint8).numpy()


def _recorder(rx, seen=None):
    seen = [] if seen is None else seen
    harvest = rx._harvest

    def rec(outs, offset, decim=1, **kw):
        seen.append((outs, offset))
        return harvest(outs, offset, decim=decim, **kw)

    rx._harvest = rec
    return seen


def _cond_recorder(rx, segs):
    """Keep each segment's conditioned samples in `segs`."""
    cond = rx._conditioned_segment

    def rec(*a):
        y = cond(*a)
        segs.append(y.clone())
        return y

    rx._conditioned_segment = rec


def _nsr_receiver(**kw):
    fe = FrontEnd(source_fs_hz=FS_INT * DECIM, internal_fs_hz=FS_INT,
                  if_freq_hz=IF_HZ, filter_impl="Freq_Xlating_Fir_Filter")
    return Receiver(ReceiverConfig(front_end=fe, fs_hz=FS_INT,
                                   n_channels=len(PRNS), prn_search=PRNS,
                                   reacq_interval_blocks=12, **kw),
                    device="cpu")


def _stream(rx, items):
    """process_stream over NSR items in 0.1 s blocks, 0.48 s segments."""
    blk = int(0.1 * FS_INT * DECIM) // 4
    rx.process_stream(((p, items[p:p + blk])
                       for p in range(0, len(items), blk)),
                      segment_s=0.48, raw_format="nsr")


@pytest.fixture(scope="module")
def one_call(nsr_capture):
    """The conditioned stream over the whole capture in one call: the
    receiver and its harvested segments."""
    rs = _nsr_receiver()
    seen = _recorder(rs)
    rs.cond_segments = []
    _cond_recorder(rs, rs.cond_segments)
    _stream(rs, nsr_capture)
    return rs, seen


def test_conditioned_stream_matches_batch_process(nsr_capture, one_call):
    """process_stream(raw_format='nsr') through the front end against
    FrontEnd.process + process (per-epoch readback, 0.48 s segments in
    both) on the same capture: the same assignments, acquisition, bit
    sync and symbol counts, each segment's valid, start and cur_len exact
    up to the first extension, and the loops within the bounds the batch
    Conditioner's
    float32 mixer leaves (module docstring: up to ~1e-2 rad of carrier
    phase; measured 1.6e-3 rad, 0.02 Hz, 1.2e-5 samples of code,
    0.015 dB-Hz, 0.22 % of the prompt)."""
    rs, seen_s = one_call
    fe = rs.cfg.front_end
    kw = dict(fs_hz=FS_INT, n_channels=len(PRNS), prn_search=PRNS,
              reacq_interval_blocks=12)
    rb = Receiver(ReceiverConfig(symbol_readback="off", **kw), device="cpu")
    seen_b = _recorder(rb)
    rb.process(fe.process(convert_to_complex64(nsr_capture, FORMATS["nsr"]),
                          device="cpu"))
    assert rs.channel_prn == rb.channel_prn and None not in rs.channel_prn
    assert rs._acq_info == rb._acq_info
    assert rs.sym_count == rb.sym_count
    assert list(rs._mode_host) == list(rb._mode_host)
    for prn, d in rb.decoders.items():
        assert rs.decoders[prn].bit_offset == d.bit_offset, prn
    assert any(d.bit_offset is not None for d in rb.decoders.values())
    assert rs._ingest_scale == pytest.approx(rb._ingest_scale, rel=1e-5)
    assert rs._abs_base == rb._abs_base == 3 * SPAN
    assert [o for _, o in seen_s] == [o for _, o in seen_b] == \
        [0, SPAN, 2 * SPAN]
    # segments 0 and 1: the stream launches segment 2 before it harvests
    # segment 1, whose bit sync switches the extension on, so it extends
    # one segment after process() does (process_stream's documented lag),
    # and the loops part from there by design
    for (s, off), (b, _) in list(zip(seen_s, seen_b))[:2]:
        np.testing.assert_array_equal(s.valid, b.valid)
        v = b.valid
        assert v.sum() > 0.9 * 480 * len(PRNS), off
        np.testing.assert_array_equal(s.start[v], b.start[v])
        np.testing.assert_array_equal(s.cur_len[v], b.cur_len[v])
        for name, atol in (("carrier_doppler_hz", 0.2),
                           ("rem_code_phase_samples", 1e-3),
                           ("code_freq_delta", 2e-2), ("cn0_dbhz", 0.1)):
            np.testing.assert_allclose(getattr(s, name)[v],
                                       getattr(b, name)[v], rtol=0,
                                       atol=atol, err_msg=name)
        dp = np.mod(s.rem_carr_phase_rad[v] - b.rem_carr_phase_rad[v]
                    + np.pi, 2 * np.pi) - np.pi
        assert np.abs(dp).max() <= 2e-2
        ps, pb = s.correlators[..., 1][v], b.correlators[..., 1][v]
        assert np.abs(ps - pb).max() <= 2e-2 * np.median(np.abs(pb))


@pytest.mark.parametrize("resumed", [False, True],
                         ids=["same receiver", "resumed"])
def test_two_stream_calls_are_one(nsr_capture, one_call, resumed,
                                  tmp_path):
    """A stream fed to process_stream in two calls, the second starting
    where the first's last segment ended (the first's tail of nmax
    samples dropped, as a live stream's call drops it), gives the one
    call's segments bit for bit: the second call's front end mixes at the
    absolute sample and filters across the seam with the first call's
    history, carried by the receiver (and by its checkpoint), so each
    segment's conditioned samples are the one call's too.  Cut after
    the first segment, whose harvest switches nothing on (the one call
    launches segment 1 before it harvests segment 0)."""
    rs, seen_s = one_call
    nmax = rs.trk.cfg.epoch_samples_max
    rx = _nsr_receiver()
    seen, segs = _recorder(rx), []
    _cond_recorder(rx, segs)
    _stream(rx, nsr_capture[:(SPAN + nmax) * DECIM // 4])
    assert rx._abs_base == SPAN and rx._front_hist[:2] == ("nsr", SPAN)
    if resumed:
        rx.checkpoint(str(tmp_path / "rx.ckpt"))
        rx = Receiver.resume_from(str(tmp_path / "rx.ckpt"), device="cpu")
        _recorder(rx, seen)
        _cond_recorder(rx, segs)
    _stream(rx, nsr_capture[SPAN * DECIM // 4:])
    assert rx._abs_base == rs._abs_base == 3 * SPAN
    assert len(segs) == len(rs.cond_segments) == 3
    for a, b in zip(segs, rs.cond_segments):
        np.testing.assert_array_equal(torch.view_as_real(a).numpy(),
                                      torch.view_as_real(b).numpy())
    assert [o for _, o in seen] == [o for _, o in seen_s]
    for (a, off), (b, _) in zip(seen, seen_s):
        for name in ("valid", "start", "cur_len", "carrier_doppler_hz",
                     "rem_code_phase_samples", "rem_carr_phase_rad",
                     "code_freq_delta", "cn0_dbhz", "correlators"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=f"{name} at {off}")
    assert rx.channel_prn == rs.channel_prn and rx.sym_count == rs.sym_count
    for prn, d in rs.decoders.items():
        assert rx.decoders[prn].bit_offset == d.bit_offset, prn


def test_the_receivers_stream_front_end():
    """The receiver builds its StreamFrontEnd from its config: the ishort
    conf's resampler; none for a Pass_Through front end (the stream runs
    as before); a front end at another internal rate is refused."""
    rc = to_receiver_config(FileConfiguration(
        str(CONF / "gps_l1_ishort.conf")))
    rx = Receiver(rc, device="cpu")
    assert rx._stream_front_end("ishort").decim == 2
    rx_pt = Receiver(ReceiverConfig(front_end=FrontEnd(2e6, 2e6),
                                    fs_hz=2e6, n_channels=1,
                                    prn_search=(3,)), device="cpu")
    assert rx_pt._stream_front_end("ishort") is None
    wrong = Receiver(ReceiverConfig(front_end=FrontEnd(8e6, 2e6, 1e6),
                                    fs_hz=4e6, n_channels=1,
                                    prn_search=(3,)), device="cpu")
    with pytest.raises(ValueError, match="tracks at"):
        wrong._stream_front_end("ishort")


# ------------------------------------------------------------------ the card


GPU_CASES = (
    # what, fmt, IF, decimation, outputs (the NSR cell's segment: 1 s at
    # 2.56 Msps and the 2,562-sample epoch tail; the GPS cell's at 2 Msps)
    ("NSR cell", "nsr", NSR_IF, 8, 2_562_562),
    ("GPS ishort", "ishort", 0.0, 2, 2_002_002),
)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=[c[0] for c in GPU_CASES])
def test_kernel_matches_plain_on_the_card(case):
    """The kernel against the plain version on the card at the cells'
    widths, as a stream of two segments (the second from the first's
    history, at an absolute output of ~10 h): every output within 2
    float32 ulps of its magnitude plus 1e-7 of the RMS (the cosine and
    sine: the kernel's float64 sincospi and numpy's cos(pi a) round to
    the other float32 now and then; the sums are the same operations),
    and the seam bit for bit against one launch over both."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    what, fmt, if_hz, decim, n_out = case
    dev = torch.device("cuda")
    fe = FrontEnd(NSR_FS, NSR_FS / decim, if_hz,
                  "Freq_Xlating_Fir_Filter" if if_hz else "Pass_Through",
                  "Direct_Resampler")
    raw = _raw(fmt, 2 * n_out * decim, seed=17)
    span = n_out - 2562
    got, want = [], []
    for where in (dev, torch.device("cpu")):
        sfe = StreamFrontEnd(fe, fmt, where)
        sfe.next_out = 92_160_000_000
        outs = []
        for k in range(2):
            a = sfe.items(k * span * decim)
            b = sfe.items((k * span + n_out) * decim)
            outs.append(sfe.condition(torch.from_numpy(raw[a:b]).to(where),
                                      n_out, span, 0.61).cpu().numpy())
        (got if where == dev else want).append(outs)
    before = xf.launches
    one = StreamFrontEnd(fe, fmt, dev)
    one.next_out = 92_160_000_000
    whole = one.condition(torch.from_numpy(
        raw[:one.items((span + n_out) * decim)]).to(dev), span + n_out,
        span + n_out, 0.61).cpu().numpy()
    assert xf.launches == before + 1
    for g, w in zip(got[0], want[0]):
        tol = 2 * np.spacing(np.abs(w).astype(np.float32)) \
            + 1e-7 * _rms(w)
        assert np.all(np.abs(g - w) <= tol), what
    np.testing.assert_array_equal(got[0][1].view(np.uint32),
                                  whole[span:].view(np.uint32))
