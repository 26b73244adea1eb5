"""The port's SBAS decoder and correction chain (telemetry/sbas.py)
against the JAX package's: every case of tests/test_sbas.py and
tests/test_sbas_corrections.py runs once through each package on the same
inputs (the encoders' blocks and the decoder's soft symbols equal bit for
bit, the decoded navigation and corrections equal field by field, and the
corrected fix through the port's solve_pvt(sat_corr=) equal value for
value), each run keeping the reference test's bars."""

import importlib

import numpy as np
import pytest

from test_torch_precise_ppp_rtk import (JAX, PORT, T0, assert_same, geometry,
                                        modules, sbas_pseudoranges)
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def sbas(pkg):
    M = modules(pkg)
    M.sbas = importlib.import_module(f"{pkg}.telemetry.sbas")
    M.native = importlib.import_module(f"{pkg}.utils.native")
    return M


def both(case):
    want, got = case(sbas(JAX)), case(sbas(PORT))
    assert_same(want, got)
    return got


def _nav(M):
    return M.sbas.SbasGeoNav(
        iodn=3, t0=45616.0, ura=2,
        pos_m=(24786016.64, -34155781.92, -74213.2),
        vel_ms=(1.2, -0.8, 0.52),
        acc_ms2=(0.0000125, -0.0000375, 0.000125),
        agf0=-4.6566e-9, agf1=9.0949e-13)


def _encode_fec(M, bits):
    reg = 0
    syms = []
    for b in bits:
        reg = (int(b) << 6) | (reg >> 1)
        syms.append(bin(reg & M.native.G1_POLY).count("1") & 1)
        syms.append(bin(reg & M.native.G2_POLY).count("1") & 1)
    return np.asarray(syms, dtype=np.int64)


def _mt9_roundtrip(M):
    nav = _nav(M)
    b = M.sbas.encode_mt9(nav, preamble_idx=1)
    assert M.sbas.crc_check(b)
    out = M.sbas.decode_mt9(b)
    assert out.valid and out.iodn == 3 and out.t0 == nav.t0
    for got, want, tol in zip(out.pos_m, nav.pos_m, (0.08, 0.08, 0.4)):
        assert abs(got - want) <= tol
    for got, want in zip(out.vel_ms, nav.vel_ms):
        assert abs(got - want) <= 0.004
    for got, want in zip(out.acc_ms2, nav.acc_ms2):
        assert got == pytest.approx(want, abs=0.0000625)
    assert out.agf0 == pytest.approx(nav.agf0, abs=2.0 ** -31)
    flipped = b.copy()
    flipped[40] ^= 1
    assert not M.sbas.crc_check(flipped)
    return b, out


def _stream_decoder(M):
    nav = _nav(M)
    blocks = [M.sbas.encode_mt9(nav, preamble_idx=k) for k in range(3)]
    bits = np.concatenate([np.zeros(17, dtype=np.int64)] + blocks)
    syms = _encode_fec(M, bits)
    rng = np.random.default_rng(11)
    amp = -((1.0 - 2.0 * syms) * 150.0) + 30.0 * rng.standard_normal(
        len(syms))
    dec = M.sbas.SbasDecoder(prn=123)
    for i in range(0, len(amp), 333):
        dec.push(amp[i:i + 333])
    assert dec.frame_sync and dec.geo_nav.valid
    assert dec.geo_nav.pos_m[0] == pytest.approx(nav.pos_m[0], abs=0.08)
    assert {m.msg_type for m in dec.messages} == {9}
    p = dec.geo_nav.position_at(nav.t0 + 10.0)
    expect = (np.asarray(dec.geo_nav.pos_m)
              + 10.0 * np.asarray(dec.geo_nav.vel_ms)
              + 50.0 * np.asarray(dec.geo_nav.acc_ms2))
    assert np.allclose(p, expect)
    return syms, dec.geo_nav, dec.messages, p


def _igp_bands(M):
    out = []
    for band in range(9):
        pts = [M.sbas.igp_of_mask_index(band, i) for i in range(1, 202)]
        n = sum(1 for p in pts if p is not None)
        assert n in (200, 201), (band, n)
        for i in (1, 50, 150, n):
            lat, lon = M.sbas.igp_of_mask_index(band, i)
            assert M.sbas.mask_index_of_igp(band, lat, lon) == i
        out.append(pts)
    return out


def _mask_fast_longterm(M):
    prns, _ephs = geometry(M)[1:]
    corr = M.sbas.SbasCorrections()
    blocks = [M.sbas.encode_mt1(prns, iodp=1)]
    assert M.sbas.crc_check(blocks[0])
    corr.update(blocks[0])
    assert corr.iodp == 1 and corr.mask == prns
    prcs = [0.125 * (i + 1) for i in range(len(prns))]
    blocks.append(M.sbas.encode_mt2(2, prcs, [5] * len(prns), iodp=1))
    corr.update(blocks[-1])
    assert corr.fast[prns[0]] == pytest.approx(0.125)
    assert corr.fast[prns[-1]] == pytest.approx(0.125 * len(prns))
    blocks.append(M.sbas.encode_mt2(2, [0.0] * len(prns),
                                    [14] + [5] * (len(prns) - 1), iodp=1))
    corr.update(blocks[-1])
    assert prns[0] not in corr.fast
    blocks.append(M.sbas.encode_mt25_vel0(
        [(2, 17, (1.0, -2.0, 0.5), 2e-8)], iodp=1))
    corr.update(blocks[-1])
    lc = corr.long[prns[1]]
    assert lc["iode"] == 17
    np.testing.assert_allclose(lc["dpos"], [1.0, -2.0, 0.5])
    assert lc["daf0"] == pytest.approx(2e-8, rel=0.05)
    n0 = dict(corr.fast)
    blocks.append(M.sbas.encode_mt2(2, [9.0] * len(prns), [3] * len(prns),
                                    iodp=3))
    corr.update(blocks[-1])
    assert corr.fast == n0
    return blocks, corr.fast, corr.long


def _iono_grid(M):
    corr = M.sbas.SbasCorrections()
    igps = [(la, lo) for lo in (0.0, 5.0, 10.0)
            for la in (40.0, 45.0, 50.0, 55.0)]
    blocks = [M.sbas.encode_mt18(4, igps, iodi=2),
              M.sbas.encode_mt26(4, 0, [2.0] * len(igps), iodi=2)]
    corr.update(blocks[0])
    assert len(corr.bands[4]["igps"]) == len(igps)
    corr.update(blocks[1])
    assert len(corr.igp_delay) == len(igps)
    lat, lon = np.radians(41.275), np.radians(1.988)
    d = corr.iono_delay_m(lat, lon, 0.3, np.radians(80.0))
    assert 2.0 < d < 2.4
    d_low = corr.iono_delay_m(lat, lon, 0.3, np.radians(10.0))
    assert d_low > 2.0 * d
    d5 = corr.iono_delay_m(lat, lon, 0.3, np.radians(80.0),
                           freq_hz=1176.45e6)
    assert d5 == pytest.approx(d * (1575.42 / 1176.45) ** 2, rel=1e-6)
    return blocks, corr.igp_delay, d, d_low, d5


def _corrected_fix(M):
    rx, prns, ephs = geometry(M)
    rng = np.random.default_rng(3)
    fast_bias = {p: ((i % 3) - 1) * 2.5 + 1.5 for i, p in enumerate(prns)}
    prs = sbas_pseudoranges(M, rx, prns, ephs, 4.0, fast_bias, rng)
    corr = M.sbas.SbasCorrections()
    corr.update(M.sbas.encode_mt1(prns, iodp=0))
    corr.update(M.sbas.encode_mt2(2, [-fast_bias[p] for p in prns],
                                  [5] * len(prns), iodp=0))
    igps3 = [(la, lo) for lo in (-30.0, -25.0)
             for la in (25.0, 30.0, 35.0, 40.0, 45.0, 50.0, 55.0)]
    igps4 = [(la, lo) for lo in (-20.0, -15.0, -10.0, -5.0, 0.0, 5.0,
                                 10.0, 15.0)
             for la in (25.0, 30.0, 35.0, 40.0, 45.0, 50.0, 55.0)]
    corr.update(M.sbas.encode_mt18(3, igps3, iodi=0))
    corr.update(M.sbas.encode_mt18(4, igps4, iodi=0))
    for band, igps in ((3, igps3), (4, igps4)):
        for blk in range((len(igps) + 14) // 15):
            corr.update(M.sbas.encode_mt26(band, blk, [4.0] * 15, iodi=0))
    sol_raw = M.solver.solve_pvt(ephs, prs, T0, raim=False)
    sol_cor = M.solver.solve_pvt(ephs, prs, T0, raim=False,
                                 sat_corr=corr.sat_corr())
    assert sol_raw.valid and sol_cor.valid
    e_raw = np.linalg.norm(sol_raw.rx_ecef_m - rx)
    e_cor = np.linalg.norm(sol_cor.rx_ecef_m - rx)
    assert e_cor < e_raw and e_cor < 2.0
    return sol_raw, sol_cor


def _decoder_routes_corrections(M):
    dec = M.sbas.SbasDecoder(prn=120)
    dec.corrections.update(M.sbas.encode_mt1([2, 5, 11], iodp=0))
    dec.corrections.update(M.sbas.encode_mt2(2, [1.0, -1.0, 0.5], [4, 4, 4],
                                             iodp=0))
    assert dec.corrections.fast == {2: 1.0, 5: -1.0, 11: 0.5}
    return dec.corrections.fast


@pytest.mark.parametrize("case", [_mt9_roundtrip, _stream_decoder],
                         ids=["mt9_roundtrip", "stream_decoder"])
def test_sbas_decoder_matches_jax(case):
    """tests/test_sbas.py's two cases: the MT9 block round trip with its
    CRC, and the rate-1/2 Viterbi stream decoder to frame sync."""
    both(case)


@pytest.mark.parametrize("case", [
    _igp_bands, _mask_fast_longterm, _iono_grid, _corrected_fix,
    _decoder_routes_corrections],
    ids=["igp_bands", "mask_fast_longterm", "iono_grid", "corrected_fix",
         "decoder_routes"])
def test_sbas_corrections_match_jax(case):
    """tests/test_sbas_corrections.py's five cases: the IGP band tables,
    MT1/2/25 mask, fast and long-term corrections with IODP gating, the
    MT18/26 ionospheric grid and its interpolation, the corrected fix
    through solve_pvt's sat_corr hook, and the decoder's routing."""
    both(case)
