"""The PyTorch port's own copies of the numpy host modules give the same
results as the JAX package's, and the port imports nothing of JAX or of the
JAX package."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

import gnss_sdr_1_tpu.codes as jcodes
import gnss_sdr_1_tpu.pvt.solver as jsolver
import gnss_sdr_1_tpu.siggen.scenario as jscen
import gnss_sdr_1_tpu.telemetry.decoder as jdecoder
import gnss_sdr_1_tpu.telemetry.lnav as jlnav
import gnss_sdr_1_tpu_torch.codes as tcodes
import gnss_sdr_1_tpu_torch.pvt.solver as tsolver
import gnss_sdr_1_tpu_torch.siggen.scenario as tscen
import gnss_sdr_1_tpu_torch.telemetry.decoder as tdecoder
import gnss_sdr_1_tpu_torch.telemetry.lnav as tlnav
from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef

ROOT = pathlib.Path(__file__).resolve().parent.parent
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
PRNS = [1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("prn", range(1, 33))
def test_gps_l1ca_codes_bit_identical(prn):
    a = jcodes.gps_l1ca_code(prn)
    b = tcodes.gps_l1ca_code(prn)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    ra = jcodes.tracking_replica("1C", prn)
    rb = tcodes.tracking_replica("1C", prn)
    np.testing.assert_array_equal(ra[0], rb[0])
    assert ra[1:] == rb[1:]


def test_resample_code_identical():
    chips = jcodes.gps_l1ca_code(7)
    for fs in (2.046e6, 4.092e6, 4e6):
        n = int(round(fs * 1e-3))
        np.testing.assert_array_equal(
            jcodes.resample_code(chips, fs, 1.023e6, n),
            tcodes.resample_code(chips, fs, 1.023e6, n))


def _scenarios():
    kw = dict(t0_tow=345601.25, duration_s=24.0, cn0_dbhz=47.0,
              subframe_cycle=(1, 2, 3))
    return (jscen.build_scenario(RX, PRNS, **kw),
            tscen.build_scenario(RX, PRNS, **kw))


def test_scenario_ephemerides_and_signals_identical():
    sj, st = _scenarios()
    assert sj.t0_tow == st.t0_tow and sj.bits_tow0 == st.bits_tow0
    for p in PRNS:
        assert dataclasses.asdict(sj.ephemerides[p]) == \
            dataclasses.asdict(st.ephemerides[p])
    for a, b in zip(sj.sats, st.sats):
        assert (a.prn, a.doppler_hz, a.delay_chips, a.doppler_rate_hz_s) \
            == (b.prn, b.doppler_hz, b.delay_chips, b.doppler_rate_hz_s)
        np.testing.assert_array_equal(a.nav_bits, b.nav_bits)


def test_generator_identical():
    from gnss_sdr_1_tpu.constants import GPS_L1_CA as JL1
    from gnss_sdr_1_tpu.siggen.generator import generate_baseband as jgen
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA as TL1
    from gnss_sdr_1_tpu_torch.siggen.generator import generate_baseband as tgen

    sj, st = _scenarios()
    codes = {p: jcodes.gps_l1ca_code(p) for p in PRNS}
    a = jgen(JL1, sj.sats, codes, 2.046e6, 0.01, noise=True)
    b = tgen(TL1, st.sats, codes, 2.046e6, 0.01, noise=True)
    np.testing.assert_array_equal(a, b)


def test_lnav_encode_decode_round_trip():
    """A scenario frame encodes to the same bits in both packages and both
    decoders recover the same ephemeris and TOW from it."""
    sj, _ = _scenarios()
    eph = sj.ephemerides[3]
    bits_j = jlnav.encode_lnav_frame(eph, 345600.0, n_subframes=5)
    bits_t = tlnav.encode_lnav_frame(
        tlnav.GpsEphemeris(**dataclasses.asdict(eph)), 345600.0,
        n_subframes=5)
    np.testing.assert_array_equal(bits_j, bits_t)
    ej, et = jlnav.GpsEphemeris(prn=3), tlnav.GpsEphemeris(prn=3)
    d29 = d30 = 0
    for k in range(3):
        sf = bits_t[k * 300:(k + 1) * 300]
        rj = jlnav.decode_subframe(sf, d29, d30, ej)
        rt = tlnav.decode_subframe(sf, d29, d30, et)
        assert rj == rt and rt is not None
        d29, d30 = int(sf[-2]), int(sf[-1])
    assert dataclasses.asdict(ej) == dataclasses.asdict(et)
    for name in ("sqrt_a", "e", "m0", "omega0", "i0", "omega", "toe"):
        assert getattr(et, name) == pytest.approx(getattr(eph, name),
                                                  rel=1e-6, abs=1e-9)


def test_lnav_decoder_symbol_stream_identical():
    """Both decoders fed the same 20-epoch symbol stream agree on bit sync,
    TOW and ephemeris."""
    sj, _ = _scenarios()
    bits = 1.0 - 2.0 * jlnav.encode_lnav_frame(
        sj.ephemerides[2], 345600.0, n_subframes=4, subframe_cycle=(1, 2, 3))
    rng = np.random.default_rng(5)
    prompts = np.repeat(bits, 20) * 100.0 + rng.normal(size=20 * len(bits))
    prompts = prompts[7:]
    starts = np.arange(len(prompts), dtype=np.int64) * 2046
    dj, dt = jdecoder.LnavDecoder(2), tdecoder.LnavDecoder(2)
    for k in range(0, len(prompts), 997):
        dj.push(prompts[k:k + 997], starts[k:k + 997])
        dt.push(prompts[k:k + 997], starts[k:k + 997])
    assert dj.bit_offset == dt.bit_offset is not None
    assert dj.ephemeris_complete and dt.ephemeris_complete
    for s in (0, 5000, len(prompts) - 1):
        assert dj.tow_at_symbol(s) == dt.tow_at_symbol(s)
    assert dataclasses.asdict(dj.ephemeris) == \
        dataclasses.asdict(dt.ephemeris)


def test_solve_pvt_identical():
    sj, st = _scenarios()
    t = sj.t0_tow + 1.0
    prs = {}
    rng = np.random.default_rng(1)
    for p in PRNS:
        tau = jscen.observed_delay_s(sj.ephemerides[p], RX, t)
        prs[p] = tau * 299792458.0 + 1500.0 + rng.normal() * 2.0
    dops = {p: sj.truth[p]["doppler_hz"] for p in PRNS}
    a = jsolver.solve_pvt(sj.ephemerides, prs, t, dopplers_hz=dops,
                          el_mask_deg=5.0, weighted=True)
    b = tsolver.solve_pvt(st.ephemerides, prs, t, dopplers_hz=dops,
                          el_mask_deg=5.0, weighted=True)
    assert a.valid and b.valid and a.n_sats == b.n_sats
    np.testing.assert_array_equal(a.rx_ecef_m, b.rx_ecef_m)
    np.testing.assert_array_equal(a.rx_vel_ecef_ms, b.rx_vel_ecef_ms)
    assert a.rx_clock_bias_s == b.rx_clock_bias_s
    assert np.linalg.norm(b.rx_ecef_m - RX) < 20.0


def _port_sources():
    files = sorted((ROOT / "gnss_sdr_1_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_port.py"]
    return files


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and the port's profiler
    import neither jax nor anything of the JAX package."""
    files = _port_sources()
    assert len(files) > 20
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "gnss_sdr_1_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"{name}")
    assert not bad, bad
