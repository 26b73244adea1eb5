"""The port's BeiDou B1I/B3I slice against the JAX package's, on the CPU.

- The constants, NH20 (the code module's and the adapter's `_NH_AMP`), the
  B1I and B3I codes and `tracking_replica('B1' | 'B3')`, element for
  element, for every PRN the JAX tables define.
- D1 NAV (BCH(15,11), the word interleave, subframes, the stream decoder)
  and D2 NAV (GEO pages, the split-field ephemeris, the 2 ms-symbol
  adapter path): tests/test_beidou_dnav.py's and tests/test_beidou_d2.py's
  cases, each run through both packages, with the same outputs.
- `BeidouChannelDecoder` on the same prompts: NH20 sync, `sec_sync_offset`
  (None on GEO), `tow_at_symbol` and the ephemeris, D1 and D2.
- The `B1` scenario and the generator (B1I, and B3I at its chip rate and
  carrier), bit for bit; CGCS2000 positions and clocks.
- PCPS at the B1I shape with the two-period window: the same detections,
  Doppler bins, delays within 1 sample, statistics at rtol 1e-4.
- The chunked engine at B1I (4 Msps, 0.2-chip spacing) and B3I
  (12.5 Msps) with the NH20 wipe on, against the JAX engine with
  `correlator='mxu'` (the one-capture engine bars), and the chain at the
  B1I shape (5 Msps, C=8) over three chunks against the Pallas kernel in
  interpret mode (int rows exact, float rows at 1e-4 of scale).
- The receiver: the same NH20 sync and switch to the wiped mode as the JAX
  receiver on a short B1I capture; a GEO channel stays in wide tracking.
- Slow: tests/test_system_beidou.py's scenario through the port on the CPU
  and the JAX package's chunked path, at that test's ephemeris and fix
  bars, with the same fixes as the JAX package.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnss_sdr_1_tpu.codes as jcodes
import gnss_sdr_1_tpu.constants as jconst
import gnss_sdr_1_tpu.pvt.ephemeris as jeph
import gnss_sdr_1_tpu.siggen.scenario as jscen
import gnss_sdr_1_tpu.telemetry.beidou_dnav as jdnav
import gnss_sdr_1_tpu.telemetry.channel_adapters as jadapt
from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
from gnss_sdr_1_tpu.runtime import ReceiverConfig as JReceiverConfig
from gnss_sdr_1_tpu.siggen.generator import generate_baseband as jgen
import gnss_sdr_1_tpu_torch.codes as tcodes
import gnss_sdr_1_tpu_torch.constants as tconst
import gnss_sdr_1_tpu_torch.pvt.ephemeris as teph
import gnss_sdr_1_tpu_torch.siggen.scenario as tscen
import gnss_sdr_1_tpu_torch.telemetry.beidou_dnav as tdnav
import gnss_sdr_1_tpu_torch.telemetry.channel_adapters as tadapt
from gnss_sdr_1_tpu_torch.ops import track_chain as tc
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.siggen import SatParams
from gnss_sdr_1_tpu_torch.siggen.generator import generate_baseband as tgen
from gnss_sdr_1_tpu_torch.track.engine import state_to_numpy
from test_torch_chain import _compare, _complex_pairs
from test_torch_l5_e5a_engine import engine_secondary_wipe_parity
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
# tests/test_system_beidou.py's rate: 1.955 samples per B1I chip
FS = 4.0e6
# signal -> (code generator, chip rate, code length, carrier)
SHAPES = {"B1": ("beidou_b1i_code", 2.046e6, 2046, "FREQ_B1I"),
          "B3": ("beidou_b3i_code", 10.23e6, 10230, "FREQ_B3I")}


def _spec(mod, signal):
    """Generation spec: each 50 bps D1 bit repeated 20 times under NH20, as
    one 1 kbps stream (tests/test_system_beidou.py)."""
    return dataclasses.replace(mod.SIGNALS[signal], bit_rate_bps=1000.0)


def _plain(obj):
    """Nested containers with numpy arrays and scalars as Python lists and
    numbers, for == comparison of two packages' results."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _nh_expand(sats, nh):
    for s in sats:
        s.nav_bits = np.repeat(s.nav_bits, 20) * np.tile(nh, len(s.nav_bits))


def _scenarios(prns, duration, signal="B1", t0_tow=345601.25):
    """The B1 scenario of both packages (B3I: the B1 scenario at B3I's chip
    rate and carrier, as the D1 stream and CGCS2000 orbits are shared),
    with the NH20-expanded bit streams."""
    _, rate, _, freq = SHAPES[signal]
    out = []
    for scen, codes in ((jscen, jcodes), (tscen, tcodes)):
        s = scen.build_scenario(
            RX, list(prns), t0_tow=t0_tow, duration_s=duration,
            cn0_dbhz=48.0, chip_rate=rate,
            carrier_freq=getattr(jconst, freq), signal="B1")
        _nh_expand(s.sats, codes.BEIDOU_NH20)
        out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------
# constants and codes
# ---------------------------------------------------------------------------


def test_beidou_constants_and_nh20_identical():
    for name in ("BDS_GM", "BDS_OMEGA_EARTH_DOT", "BDS_GPS_TIME_OFFSET_S",
                 "FREQ_B1I", "FREQ_B3I"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    for sid in ("B1", "B3"):
        assert dataclasses.asdict(tconst.SIGNALS[sid]) == \
            dataclasses.asdict(jconst.SIGNALS[sid])
        assert tconst.SIGNALS[sid].secondary_code_length == 20
    assert tcodes.BEIDOU_NH20.dtype == jcodes.BEIDOU_NH20.dtype
    np.testing.assert_array_equal(tcodes.BEIDOU_NH20, jcodes.BEIDOU_NH20)
    np.testing.assert_array_equal(tadapt.BeidouChannelDecoder._NH_AMP,
                                  jadapt.BeidouChannelDecoder._NH_AMP)
    # the adapter's amplitudes are the code module's NH20
    np.testing.assert_array_equal(tadapt.BeidouChannelDecoder._NH_AMP,
                                  tcodes.BEIDOU_NH20)


@pytest.mark.parametrize("prn", range(1, 38))
def test_b1i_codes_and_replica_identical(prn):
    a, b = jcodes.beidou_b1i_code(prn), tcodes.beidou_b1i_code(prn)
    assert a.dtype == b.dtype and a.shape == b.shape == (2046,)
    np.testing.assert_array_equal(a, b)
    ra, rb = jcodes.tracking_replica("B1", prn), tcodes.tracking_replica(
        "B1", prn)
    np.testing.assert_array_equal(ra[0], rb[0])
    assert ra[1:] == rb[1:] == (2.046e6, 1)


@pytest.mark.parametrize("prn", range(1, 64))
def test_b3i_codes_and_replica_identical(prn):
    a, b = jcodes.beidou_b3i_code(prn), tcodes.beidou_b3i_code(prn)
    assert a.dtype == b.dtype and a.shape == b.shape == (10230,)
    np.testing.assert_array_equal(a, b)
    ra, rb = jcodes.tracking_replica("B3", prn), tcodes.tracking_replica(
        "B3", prn)
    np.testing.assert_array_equal(ra[0], rb[0])
    assert ra[1:] == rb[1:] == (10.23e6, 1)


# ---------------------------------------------------------------------------
# D1 NAV: tests/test_beidou_dnav.py's cases through both packages
# ---------------------------------------------------------------------------


def _d1_bch(m):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(20):
        data = rng.integers(0, 2, 11)
        cw = m.bch1511_encode(data)
        dec, ok = m.bch1511_decode(cw)
        assert ok and np.array_equal(dec, data)
        pos = int(rng.integers(0, 15))
        cw2 = cw.copy()
        cw2[pos] ^= 1
        dec2, ok2 = m.bch1511_decode(cw2)
        assert ok2 and np.array_equal(dec2, data)
        out.append((cw.tolist(), dec2.tolist()))
    return out


def _d1_word(m):
    data = np.random.default_rng(1).integers(0, 2, 22)
    w = m.encode_word(data)
    dec, ok = m.decode_word(w)
    assert ok and np.array_equal(dec[:22], data)
    return w.tolist(), dec.tolist()


def _d1_subframe(m):
    sf = m.encode_subframe_bits(3, 234567.0)
    assert sf.shape == (300,)
    r = m.decode_subframe(sf)
    assert r is not None and r["fra_id"] == 3 and r["sow_s"] == 234567.0
    return sf.tolist(), r


def _d1_ephemeris(m):
    truth = m.BeidouEphemeris(
        prn=8, week=810, toc=345600.0, toe=345600.0,
        af0=-3.2e-5, af1=1.1e-11, af2=0.0, tgd=4.7e-9,
        sqrt_a=np.sqrt(27_906_100.0), e=0.0031,
        m0=0.41, delta_n=1.1e-9, omega0=-0.73, i0=0.31,
        omega=0.22, omega_dot=-2.1e-9, idot=8.0e-11,
        cuc=1.2e-6, cus=-2.3e-6, crc=180.5, crs=-41.25,
        cic=4.0e-8, cis=-6.0e-8)
    sow0 = 345600.0
    sfs = [m.encode_subframe_bits(1, sow0, {
        "wn": truth.week, "toc": truth.toc, "tgd1": truth.tgd,
        "a0": truth.af0, "a1": truth.af1, "a2": truth.af2,
        "alpha0": 1.1e-8, "beta0": 90112.0}),
        m.encode_subframe_bits(2, sow0 + 6.0, {
            "delta_n": truth.delta_n, "cuc": truth.cuc, "m0": truth.m0,
            "e": truth.e, "cus": truth.cus, "crc": truth.crc,
            "crs": truth.crs, "sqrt_a": truth.sqrt_a,
            "toe_msb": int(truth.toe / 8.0) >> 15}),
        m.encode_subframe_bits(3, sow0 + 12.0, {
            "toe_lsb": int(truth.toe / 8.0) & 0x7FFF, "i0": truth.i0,
            "cic": truth.cic, "omega_dot": truth.omega_dot,
            "cis": truth.cis, "idot": truth.idot,
            "omega0": truth.omega0, "omega": truth.omega})]
    dec = m.DnavDecoder(prn=8)
    dec.push(1.0 - 2.0 * np.concatenate(sfs).astype(np.float64))
    assert dec.ephemeris_complete
    e = dec.ephemeris
    assert (e.week, e.toe, e.toc) == (truth.week, truth.toe, truth.toc)
    assert e.sqrt_a == pytest.approx(truth.sqrt_a, abs=2e-6)
    assert e.m0 == pytest.approx(truth.m0, abs=1e-9)
    assert e.af1 == pytest.approx(truth.af1, abs=1e-15)
    assert dec.iono.valid
    assert dec.iono.alpha[0] == pytest.approx(1.1e-8, abs=1e-9)
    return dataclasses.asdict(e), dataclasses.asdict(dec.iono)


def _d1_stream(m):
    sfs = [m.encode_subframe_bits(k, 345600.0 + 6.0 * k) for k in (1, 2, 3)]
    bits = np.concatenate([np.zeros(17, dtype=np.int64)] + sfs)
    amp = (1.0 - 2.0 * bits) * 300.0
    amp += np.random.default_rng(3).standard_normal(len(amp)) * 40.0
    dec = m.DnavDecoder(prn=6)
    for i in range(0, len(amp), 111):
        dec.push(amp[i: i + 111])
    assert dec.frame_sync and set(dec.subframes) >= {1, 2}
    assert dec.subframes[2]["sow_s"] == 345612.0
    t1, t2 = dec.sow_at_symbol(100), dec.sow_at_symbol(150)
    assert t2 - t1 == pytest.approx(1.0, abs=1e-12)
    return dec.subframes, t1, t2


D1_CASES = {"bch": _d1_bch, "word_interleave": _d1_word,
            "subframe": _d1_subframe, "ephemeris_fields": _d1_ephemeris,
            "stream_with_noise": _d1_stream}


@pytest.mark.parametrize("case", sorted(D1_CASES))
def test_d1_matches_jax(case):
    """Each of tests/test_beidou_dnav.py's five cases, run through both
    packages' D1 modules on the same seeded inputs: both meet the case's
    checks and give the same codewords, fields and ephemerides."""
    assert _plain(D1_CASES[case](tdnav)) == _plain(D1_CASES[case](jdnav))


# ---------------------------------------------------------------------------
# D2 NAV (GEO PRN 1-5): tests/test_beidou_d2.py's cases through both
# ---------------------------------------------------------------------------


def _d2_eph(m):
    return m.BeidouEphemeris(
        prn=3, week=810, toc=345600.0, toe=345600.0,
        af0=-2.354671e-4, af1=3.1832314e-12, af2=0.0, tgd=8.0e-9,
        iodc=11, iode=7,
        sqrt_a=6493.41, e=0.002913, m0=0.30123, delta_n=1.2e-9 / np.pi,
        omega0=-0.61223, i0=0.0316 / np.pi, omega=0.8811,
        omega_dot=-6.8e-10 / np.pi, idot=2.1e-11 / np.pi,
        cuc=-6.2e-6, cus=7.3e-6, crc=201.3, crs=-55.1,
        cic=-7.5e-8, cis=1.1e-7, sat_h1=0)


def _d2_iono(m):
    return m.BeidouIono(alpha=(1.1176e-8, 2.98e-8, -1.789e-7, 1.19e-7),
                        beta=(92160.0, 49152.0, -131072.0, -196608.0),
                        valid=True)


def _d2_stream(m, frames=False, seed=0, sow0=345600.0):
    """Subframe-1 pages 1..10: back to back, or (frames) in 3 s frames
    with four random filler subframes after each page."""
    eph, iono = _d2_eph(m), _d2_iono(m)
    rng = np.random.default_rng(seed)
    bits = []
    for k, page in enumerate(range(1, 11)):
        sow = sow0 + (3.0 * k if frames else 1.0 * k)
        bits.append(m.encode_d2_page_bits(page, sow,
                                          m.d2_fields_for(eph, page, iono)))
        if frames:
            bits.append(rng.integers(0, 2, size=4 * 300).astype(np.int64))
    return np.concatenate(bits)


def _d2_roundtrip(m, adapt):
    eph, iono = _d2_eph(m), _d2_iono(m)
    out = []
    for page in range(1, 11):
        tx = m.encode_d2_page_bits(page, 345600.0 + page,
                                   m.d2_fields_for(eph, page, iono))
        r = m.decode_subframe(tx)
        assert r is not None and r["fra_id"] == 1
        assert r["sow_s"] == 345600.0 + page
        out.append((tx.tolist(), r))
    return out


def _d2_assembly(m, adapt):
    eph, iono = _d2_eph(m), _d2_iono(m)
    dec = m.D2Decoder(prn=3)
    dec.push(1.0 - 2.0 * _d2_stream(m))
    assert dec.ephemeris_complete
    got = dec.ephemeris
    for name in ("week", "iodc", "iode", "sat_h1"):
        assert getattr(got, name) == getattr(eph, name), name
    assert abs(got.sqrt_a - eph.sqrt_a) <= 2.0 ** -19
    assert abs(got.toe - eph.toe) <= 8.0
    np.testing.assert_allclose(dec.iono.alpha, iono.alpha, atol=2.0 ** -24)
    return dataclasses.asdict(got), dataclasses.asdict(dec.iono)


def _d2_adapter(m, adapt):
    """1 ms prompts -> 2 ms symbols through BeidouChannelDecoder, both
    2-epoch phases and both polarities, with noise."""
    sym = 1.0 - 2.0 * _d2_stream(m, frames=True)
    rng = np.random.default_rng(4)
    out = []
    for phase in (0, 1):
        for pol in (1.0, -1.0):
            prompts = np.repeat(pol * sym, 2)
            prompts = np.concatenate([rng.normal(size=phase), prompts])
            prompts = prompts + 0.25 * rng.normal(size=len(prompts))
            dec = adapt.BeidouChannelDecoder(prn=2)
            assert dec.is_geo
            for i in range(0, len(prompts), 500):
                dec.push(prompts[i: i + 500])
            assert dec.ephemeris_complete, (phase, pol)
            assert dec.ephemeris.week == 810
            assert dec.sec_sync_offset is None
            sow = dec.tow_at_symbol(phase + 40)
            assert abs(sow - (345600.0 + 0.002 * 20)) < 1e-9, (phase, pol)
            out.append((dec._d2_phase, dataclasses.asdict(dec.ephemeris),
                        [dec.tow_at_symbol(s) for s in (phase, 999, 30001)]))
    return out


def _d2_meo(m, adapt):
    dec = adapt.BeidouChannelDecoder(prn=8)
    assert not dec.is_geo
    assert dec.sec_sync_offset is None
    return type(dec.raw).__name__


D2_CASES = {"page_roundtrip": _d2_roundtrip, "ephemeris_assembly":
            _d2_assembly, "adapter_both_phases_and_polarity": _d2_adapter,
            "d1_unchanged_for_meo": _d2_meo}


@pytest.mark.parametrize("case", sorted(D2_CASES))
def test_d2_matches_jax(case):
    """Each of tests/test_beidou_d2.py's four cases through both packages:
    the same pages, ephemerides, symbol phases and TOWs."""
    assert _plain(D2_CASES[case](tdnav, tadapt)) == \
        _plain(D2_CASES[case](jdnav, jadapt))


# ---------------------------------------------------------------------------
# the channel adapter on a scenario's D1 stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skip", [1287, 3000])
def test_d1_channel_decoder_identical(skip):
    """Both adapters fed the same soft 1 ms prompts (the scenario's NH20
    stream with noise, starting `skip` epochs in): the same NH20 sync, the
    same TOW at every symbol asked, the same ephemeris (system 'C', close
    to the truth)."""
    sj, _ = _scenarios((9,), 25.0)
    bits = np.asarray(sj.sats[0].nav_bits)
    rng = np.random.default_rng(skip)
    prompts = (bits * 80.0 + rng.normal(size=len(bits)) * 20.0)[skip:]
    prompts = prompts[: 25000 - skip]
    dj, dt = jadapt.BeidouChannelDecoder(9), tadapt.BeidouChannelDecoder(9)
    for k in range(0, len(prompts), 997):
        dj.push(prompts[k:k + 997])
        dt.push(prompts[k:k + 997])
    assert dt.sec_sync_offset == dj.sec_sync_offset == (-skip) % 20
    assert dj.ephemeris_complete and dt.ephemeris_complete
    for s in (0, 777, 5000, len(prompts) - 1):
        assert dt.tow_at_symbol(s) == dj.tow_at_symbol(s) is not None
    assert dataclasses.asdict(dt.ephemeris) == \
        dataclasses.asdict(dj.ephemeris)
    assert dt.ephemeris.system == "C"
    assert dt.ephemeris.sqrt_a == pytest.approx(sj.ephemerides[9].sqrt_a,
                                                abs=2e-5)
    assert _plain(dt.raw.subframes) == _plain(dj.raw.subframes)


# ---------------------------------------------------------------------------
# scenario, generator and CGCS2000 orbits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signal,fs", [("B1", FS), ("B3", 12.5e6)])
def test_scenario_and_generator_identical(signal, fs):
    prns = (6, 9, 14)
    sj, st = _scenarios(prns, 12.0, signal)
    assert sj.bits_tow0 == st.bits_tow0 == 345600.0
    for p in prns:
        assert dataclasses.asdict(sj.ephemerides[p]) == \
            dataclasses.asdict(st.ephemerides[p])
        assert st.ephemerides[p].system == "C"
    for a, b in zip(sj.sats, st.sats):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        np.testing.assert_array_equal(da.pop("nav_bits"), db.pop("nav_bits"))
        assert da == db
    gen, rate, n_chips, _ = SHAPES[signal]
    codes = {p: getattr(jcodes, gen)(p) for p in prns}
    np.testing.assert_array_equal(
        tgen(_spec(tconst, signal), st.sats, codes, fs, 0.005, noise=True),
        jgen(_spec(jconst, signal), sj.sats, codes, fs, 0.005, noise=True))


def test_cgcs2000_positions_and_clocks():
    """The B1 scenario's CGCS2000 ephemerides: satellite positions,
    velocities and clocks of both packages within 1e-6 m (and s), and the
    truth delays of the scenario alike."""
    prns = (6, 7, 8, 9, 10)
    sj, st = _scenarios(prns, 24.0)
    for p in prns:
        for t in (345601.25, 345613.0, 345625.25):
            pj, vj = jeph.satellite_position_velocity(sj.ephemerides[p], t)
            pt, vt = teph.satellite_position_velocity(st.ephemerides[p], t)
            np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
            np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
            assert abs(teph.satellite_clock_correction(st.ephemerides[p], t)
                       - jeph.satellite_clock_correction(sj.ephemerides[p],
                                                         t)) < 1e-15
            assert tscen.observed_delay_s(st.ephemerides[p], RX, t) == \
                jscen.observed_delay_s(sj.ephemerides[p], RX, t)
        assert st.truth[p] == sj.truth[p]


# ---------------------------------------------------------------------------
# acquisition and the receiver
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capture():
    """0.8 s of B1I at 4 Msps, 3 D1 satellites (four 200 ms receiver
    segments and the last epoch's samples)."""
    prns = (6, 9, 14)
    sj, _ = _scenarios(prns, 0.802)
    codes = {p: jcodes.beidou_b1i_code(p) for p in prns}
    return sj, jgen(_spec(jconst, "B1"), sj.sats, codes, FS, 0.802,
                    noise=True, seed=1234)


def _cfg_kw(prns, **kw):
    """tests/test_system_beidou.py's receiver configuration."""
    return {**dict(fs_hz=FS, signal_id="B1", n_channels=len(prns),
                   prn_search=tuple(prns), acq_dwells=3,
                   acq_bit_transition=True, pll_bw_hz=18.0, dll_bw_hz=2.0,
                   early_late_space_chips=0.2, doppler_step2_hz=15.0,
                   num_doppler_bins_step2=40), **kw}


def test_acquisition_matches_jax(capture):
    """PCPS over 0.1 s at the B1I shape with the two-period window, over
    the capture's satellites and two absent PRNs: the same detections,
    Doppler bins, delays within 1 sample and statistics at rtol 1e-4."""
    scen, x = capture
    prns = tuple(s.prn for s in scen.sats) + (21, 30)
    # the window is forced by the NH20 code in both packages
    kw = _cfg_kw(prns, acq_bit_transition=False)
    rj = JReceiver(JReceiverConfig(correlator="mxu", **kw))
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    assert rt.acq.cfg.bit_transition_flag and rj.acq.cfg.bit_transition_flag
    assert rt.acq.cfg.fft_size == rj.acq.cfg.fft_size == 2 * 4000
    head = x[: int(FS * 0.1)]
    a, b = rt.acq.acquire(head), rj.acq.acquire(head)
    np.testing.assert_array_equal(a.positive, b.positive)
    assert a.positive[:3].all() and not a.positive[3:].any()
    np.testing.assert_array_equal(np.ravel(a.doppler_hz),
                                  np.ravel(b.doppler_hz))
    spc = rt.samples_per_code
    dd = np.abs(np.ravel(a.delay_samples) - np.ravel(b.delay_samples)) % spc
    assert (np.minimum(dd, spc - dd) <= 1.0).all()
    np.testing.assert_allclose(a.test_stat, b.test_stat, rtol=1e-4)
    for s, f in zip(scen.sats, np.ravel(a.doppler_hz)):
        assert abs(f - s.doppler_hz) < 300.0


def test_receiver_reaches_nh20_wipe_like_jax(capture):
    """0.8 s in 200 ms segments: acquisition, pull-in, NH20 sync, then the
    extended mode with the in-loop wipe for the channels whose decoder
    synced; the same assignments, symbol counts, NH20 offsets, modes and
    secondary indices as the JAX receiver.  The receivers pull in with a
    45 Hz PLL (the 18 Hz of the system test syncs one channel in a
    second)."""
    scen, x = capture
    prns = tuple(s.prn for s in scen.sats)
    kw = _cfg_kw(prns, reacq_interval_blocks=5, pll_bw_hz=45.0)
    rj = JReceiver(JReceiverConfig(correlator="mxu", **kw))
    rj.process(x)
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    rt.preload(x)
    rt.process(x)
    assert rt._sec_period == rj._sec_period == 20
    assert rt.trk.cfg.extend_correlation_symbols == 20
    spec = rt.trk.chain_spec
    assert (spec.K, spec.sec_len, spec.sec_data) == (3, 20, True)
    np.testing.assert_array_equal(rt.trk._sec.cpu().numpy(),
                                  np.tile(tcodes.BEIDOU_NH20, (3, 1)))
    assert rt.channel_prn == rj.channel_prn
    assert None not in rt.channel_prn
    for prn, (dj, fj, sj) in rj._acq_info.items():
        dt, ft, st = rt._acq_info[prn]
        assert ft == fj, prn
        assert abs(dt - dj) <= 1.0, prn
    assert rt.sym_count == rj.sym_count
    offs = {p: d.sec_sync_offset for p, d in rt.decoders.items()}
    assert offs == {p: d.sec_sync_offset for p, d in rj.decoders.items()}
    assert list(rt._mode_host) == list(rj._mode_host)
    synced = [ch for ch, p in enumerate(rt.channel_prn)
              if offs[p] is not None]
    assert synced
    st = state_to_numpy(rt.state)
    np.testing.assert_array_equal(st["sec_on"], np.asarray(rj.state.sec_on))
    np.testing.assert_array_equal(st["sec_idx"],
                                  np.asarray(rj.state.sec_idx))
    assert st["sec_on"][synced].all() and (st["mode"][synced] == 1).all()
    # the wipe index is the NH20 chip of the next epoch
    for ch in synced:
        p = rt.channel_prn[ch]
        assert st["sec_idx"][ch] == (rt.sym_count[p] - offs[p]) % 20


def test_geo_channel_stays_wide():
    """A GEO satellite (PRN 3, D2) on a channel whose decoder holds a
    complete ephemeris: it never reports NH20 sync, so both receivers keep
    it in the wide mode with the wipe off, next to a MEO channel that
    switches."""
    mods = ((Receiver, ReceiverConfig, tadapt, {"device": "cpu"}),
            (JReceiver, JReceiverConfig, jadapt, {}))
    sym = 1.0 - 2.0 * _d2_stream(tdnav, frames=True)
    prompts = np.repeat(sym, 2)
    sj, _ = _scenarios((9,), 25.0)
    d1 = np.asarray(sj.sats[0].nav_bits)[:25000] * 80.0
    modes = []
    for rcls, ccls, adapt, kw in mods:
        extra = {} if rcls is Receiver else {"correlator": "mxu"}
        rx = rcls(ccls(fs_hz=FS, signal_id="B1", n_channels=2,
                       prn_search=(3, 9), **extra), **kw)
        for ch, (prn, stream) in enumerate(((3, prompts), (9, d1))):
            dec = adapt.BeidouChannelDecoder(prn)
            dec.push(stream)
            assert dec.ephemeris_complete
            rx.channel_prn[ch] = prn
            rx.decoders[prn] = dec
            rx.sym_count[prn] = len(stream)
            rx.state = rx.trk.activate_channel(rx.state, ch, ch, 100.0,
                                               1000.0, 0, 0)
        assert rx.decoders[3].is_geo and rx.decoders[3].sec_sync_offset \
            is None
        rx._maybe_extend()
        rx._maybe_extend()
        sec_on = np.asarray(rx.state.sec_on)
        modes.append((list(rx._mode_host), sec_on.tolist()))
        assert list(rx._mode_host) == [0, 1]
        assert not sec_on[0] and sec_on[1]
        assert rx._pull_in_done() is False
    assert modes[0] == modes[1]


# ---------------------------------------------------------------------------
# the chunked engine with the NH20 wipe on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signal,fs", [("B1", FS), ("B3", 12.5e6)])
def test_engine_with_nh20_wipe_matches_jax(signal, fs):
    """tests/test_torch_l5_e5a_engine.py's check with NH20: three channels
    activated at the truth and tracked 29 ms, switched to the extended mode
    with the wipe at each channel's true (non-zero) NH20 chip by both
    engines, then 0.2 s by both from the same state: valid, start and
    cur_len exact; Doppler, code delta and rem code at 2e-2 (B1I at 4 Msps
    with the conf's 0.2-chip correlator; B3I at 12.5 Msps)."""
    engine_secondary_wipe_parity(signal, fs, jcodes.BEIDOU_NH20,
                                 early_late=0.2 if signal == "B1" else 0.5)


# ---------------------------------------------------------------------------
# the chain at the B1I shape against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

FS_B1I = 5.0e6       # bds_b1i_ibyte.conf's rate: 2.44 samples per chip
C_B1I = 8            # and its channels
CHAIN_CHUNKS = 3


def test_chain_at_b1i_shape_matches_pallas_interpret():
    """The B1I receiver's chain (5 Msps, 8 channels, 0.2-chip spacing,
    NH20 with sec_data) on the state of channels the port's engine tracked
    40 ms, with the wipe on from non-zero NH20 chips on six channels (four
    extended, one window closing in the first chunk), over three chunks of
    lag windows whose peak sign follows each channel's NH20 chip; each
    implementation carries its own state across the seams."""
    from gnss_sdr_1_tpu.ops import pallas_chain

    prns = tuple(range(6, 6 + C_B1I))
    rng = np.random.default_rng(31)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-3000, 3000)),
                      delay_chips=float(rng.uniform(0, 2046)),
                      cn0_dbhz=50.0,
                      nav_bits=(np.repeat(rng.choice([-1.0, 1.0], 4), 20)
                                * np.tile(tcodes.BEIDOU_NH20, 4)),
                      bit_rate_override_bps=1000.0)
            for p in prns]
    rx = Receiver(ReceiverConfig(fs_hz=FS_B1I, signal_id="B1",
                                 n_channels=C_B1I, prn_search=prns,
                                 early_late_space_chips=0.2), device="cpu")
    eng = rx.trk
    spec = eng.chain_spec
    assert (spec.E, spec.C, spec.K, spec.sec_len, spec.sec_data) == (
        16, C_B1I, 3, 20, True)
    assert spec.spc_samples == pytest.approx(FS_B1I / 2.046e6)
    codes = {p: tcodes.beidou_b1i_code(p) for p in prns}
    x = tgen(_spec(tconst, "B1"), sats, codes, FS_B1I, 0.045, noise=True,
             seed=9)
    st = eng.init_state()
    for ch, s in enumerate(sats):
        st = eng.activate_channel(st, ch, ch, s.delay_chips / 2.046e6
                                  * FS_B1I, s.doppler_hz, 0, 0)
    st, _ = eng.track_capture(torch.from_numpy(x), st, int(FS_B1I * 0.04))
    fst, ist = (t.numpy().copy() for t in eng._pack_rows(st, 10 ** 9))
    ist[tc.I_SEC_ON, :6] = 1
    ist[tc.I_SEC_IDX, :6] = (19, 3, 7, 11, 0, 15)
    ist[tc.I_MODE, :4] = 1
    ist[tc.I_EXTCNT, :4] = (18, 4, 0, 9)
    sec = np.ascontiguousarray(np.tile(tcodes.BEIDOU_NH20[:, None],
                                       (1, C_B1I)))
    call = pallas_chain.make_chain_call(
        pallas_chain.ChainSpec(**dataclasses.asdict(spec)), interpret=True)
    rng = np.random.default_rng(20)
    E, LW = spec.E, spec.LW
    fj, ij, ft, it = fst, ist, fst, ist
    pushes = ist[tc.I_PUSH].copy()
    for k in range(CHAIN_CHUNKS):
        start = ij[tc.I_START].astype(np.int64)
        s_reg = (start[None, :] - (E + 4)
                 + np.arange(E)[:, None] * spec.t0_int).astype(np.int32)
        lag = np.arange(LW)[None, :, None]
        pk = (spec.lag_margin + (E + 4) + fj[tc.F_REM_CODE])[None, None, :]
        tri = np.maximum(0.0, 1.0 - np.abs(lag - pk) / spec.spc_samples)
        chip = sec[(ij[tc.I_SEC_IDX][None, :] + np.arange(E)[:, None]) % 20,
                   0]
        amp = (rng.normal(size=(E, 1, C_B1I)) * 20.0 + 300.0) \
            * chip[:, None, :]
        ph = rng.uniform(-0.3, 0.3, size=(E, 1, C_B1I))
        zr = (amp * np.cos(ph) * tri + rng.normal(size=(E, LW, C_B1I))
              * 10.0).astype(np.float32)
        zi = (amp * np.sin(ph) * tri + rng.normal(size=(E, LW, C_B1I))
              * 10.0).astype(np.float32)
        step0 = (2 * np.pi * (fj[tc.F_DOPPLER] + 0.7) / spec.fs)[None] \
            .astype(np.float32)
        want = call(*(jnp.asarray(a) for a in (zr, zi, s_reg, step0, sec,
                                               fj, ij)))
        got = tc.chain(spec, *(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (zr.transpose(2, 0, 1),
                                         zi.transpose(2, 0, 1), s_reg.T,
                                         step0[0], sec, ft, it)))
        _compare(got, want, f"chunk {k}", _complex_pairs(spec.K))
        np.testing.assert_array_equal(np.asarray(got[4])[tc.I_SEC_IDX],
                                      (ij[tc.I_SEC_IDX] + E) % 20)
        assert (np.asarray(got[0])[:, tc.O_VALID].sum(axis=0) == E).all()
        fj, ij = np.asarray(want[3]), np.asarray(want[4])
        ft, it = got[3].numpy(), got[4].numpy()
    done = it[tc.I_PUSH] - pushes
    # wide channels close every epoch; ch0's 20-epoch window closes after
    # 2 epochs, then every 20
    assert (done[4:] == CHAIN_CHUNKS * E).all()
    assert done[0] == 1 + (CHAIN_CHUNKS * E - 2) // 20


# ---------------------------------------------------------------------------
# the system scenario (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_system_scenario_matches_jax_chunked_path():
    """tests/test_system_beidou.py's scenario (5 D1 satellites, 24 s at
    4 Msps, 48 dB-Hz) and receiver through the port on the CPU and through
    the JAX package's chunked path (`correlator='mxu'`): that test's
    ephemeris and fix bars (at least 4 ephemerides of system 'C' with
    sqrt_a within 2e-5 of the truth, at least 10 fixes), the same
    ephemerides and fix count as the JAX package, positions within 0.5 m of
    its.  Its 5 m bars on the median 3D error and the mean bias hold for
    the JAX package's exact per-epoch path (the system test's default on
    the CPU: 0.97 m), not for the chunked path of either package: 33.8 m
    here, from range biases of up to ~9 m on the satellite whose code
    Doppler is slowest, which 4 satellites turn into metres of position
    (ROADMAP.md §3); the test records the median next to the JAX
    package's.  The capture is the port's own generator's, cached under the
    temporary directory (tests/test_torch_capture_cache.py)."""
    from test_torch_capture_cache import cached_capture

    prns = (6, 7, 8, 9, 10)
    duration = 24.0
    sj, st = _scenarios(prns, duration)
    x = cached_capture(
        f"beidou_{FS:.0f}_{duration:.0f}_v1",
        lambda: tgen(_spec(tconst, "B1"), st.sats,
                     {p: tcodes.beidou_b1i_code(p) for p in prns}, FS,
                     duration, noise=True))
    rt = Receiver(ReceiverConfig(**_cfg_kw(prns)), device="cpu")
    rt.preload(x)
    sols = rt.process(x)
    rj = JReceiver(JReceiverConfig(correlator="mxu", **_cfg_kw(prns)))
    sols_j = rj.process(x)
    done = {p: d for p, d in rt.decoders.items() if d.ephemeris_complete}
    assert len(done) >= 4, f"only {len(done)} BeiDou ephemerides decoded"
    for p, d in done.items():
        assert d.ephemeris.sqrt_a == pytest.approx(st.ephemerides[p].sqrt_a,
                                                   abs=2e-5)
        assert d.ephemeris.system == "C"
        assert dataclasses.asdict(d.ephemeris) == dataclasses.asdict(
            rj.decoders[p].ephemeris)
    assert {p for p, d in rj.decoders.items() if d.ephemeris_complete} \
        == set(done)
    assert len(sols) >= 10 and len(sols) == len(sols_j)
    pos = np.stack([s.rx_ecef_m for s in sols])
    pos_j = np.stack([s.rx_ecef_m for s in sols_j])
    assert np.abs(pos - pos_j).max() < 0.5
    e3d = np.linalg.norm(pos - st.rx_ecef, axis=1)
    e3d_j = np.linalg.norm(pos_j - st.rx_ecef, axis=1)
    assert abs(np.median(e3d) - np.median(e3d_j)) < 0.1, (
        np.median(e3d), np.median(e3d_j))
