"""The port's SUPL client/server and RRLP codec (runtime/{supl,rrlp}.py)
against the JAX package's: every case of tests/test_supl.py runs once
through each package, each building its own assistance bundle from the
same field values.  The payloads and PDUs are the same bytes, the decoded
bundles equal field by field, and the sessions (servers on 127.0.0.1, port
0) hand the client the same maps; the port's client also reads the JAX
package's server, and the JAX package's client the port's.  The bundle
then feeds the port's Receiver.set_assistance, which predicts what the
JAX receiver predicts."""

import importlib

import numpy as np
import pytest

from test_torch_precise_ppp_rtk import JAX, PORT, assert_same, modules
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def pkgmods(pkg):
    M = modules(pkg)
    M.supl = importlib.import_module(f"{pkg}.runtime.supl")
    M.rrlp = importlib.import_module(f"{pkg}.runtime.rrlp")
    M.receiver = importlib.import_module(f"{pkg}.runtime.receiver")
    return M


def both(case):
    want, got = case(pkgmods(JAX)), case(pkgmods(PORT))
    assert_same(want, got)
    return got


def bundle(M):
    """tests/test_supl.py's _assist: four ephemerides, iono, UTC, a
    reference time and location and one acquisition-assist entry."""
    ephs = {}
    rng = np.random.default_rng(1)
    for prn in (2, 5, 17, 29):
        ephs[prn] = M.lnav.GpsEphemeris(
            prn=prn, week=314, toc=345600.0, toe=345600.0,
            af0=-1.5e-4, af1=2.3e-12, af2=0.0, tgd=4.7e-9, iodc=44,
            iode=44, sv_health=0,
            sqrt_a=5153.7 + prn * 0.01, e=0.012, m0=float(rng.uniform(-1, 1)),
            delta_n=1.4e-9 / np.pi, omega0=float(rng.uniform(-1, 1)),
            i0=0.31, omega=float(rng.uniform(-1, 1)),
            omega_dot=-8.1e-9 / np.pi, idot=3e-11 / np.pi,
            cuc=-3.1e-6, cus=7.9e-6, crc=230.1, crs=-42.9,
            cic=-9.3e-8, cis=5.6e-8)
    iono = M.lnav.GpsIono(1.2e-8, -7.45e-9, -5.96e-8, 1.19e-7,
                          96256.0, -32768.0, -196608.0, 196608.0, valid=True)
    utc = M.lnav.GpsUtc(a0=9.3e-10, a1=8.8e-15, tot=405504.0, wn_t=58,
                        delta_t_ls=18, wn_lsf=137, dn=7, delta_t_lsf=18,
                        valid=True)
    acq = {2: M.supl.AcqAssist(prn=2, doppler0_hz=-2250.0, doppler1_hz_s=0.5,
                               code_phase_chips=512.25, code_phase_int_ms=37,
                               azimuth_deg=214.0, elevation_deg=48.0)}
    return M.supl.SuplAssist(ref_time_week=2314, ref_time_tow_s=345601.25,
                             ref_lat_deg=41.2750, ref_lon_deg=1.9880,
                             ref_alt_m=80.0, has_ref_location=True,
                             ephemerides=ephs, iono=iono, utc=utc,
                             acq_assist=acq)


def _client_maps(cli):
    return (cli.gps_ephemeris_map, cli.gps_acq_map, cli.gps_time,
            cli.gps_ref_loc, cli.gps_iono, cli.gps_utc)


def _payload_roundtrip(M):
    a = bundle(M)
    wire = M.supl.encode_assist(a)
    b = M.supl.decode_assist(wire)
    assert b.ref_time_week == 2314
    assert abs(b.ref_time_tow_s - 345601.25) < 0.01
    assert abs(b.ref_lat_deg - 41.2750) < 1e-4
    assert abs(b.ref_lon_deg - 1.9880) < 1e-4
    assert abs(b.ref_alt_m - 80.0) < 1.0
    assert set(b.ephemerides) == set(a.ephemerides)
    for prn, e in a.ephemerides.items():
        g = b.ephemerides[prn]
        for name, lsb in (("sqrt_a", 2.0 ** -19), ("e", 2.0 ** -33),
                          ("m0", 2.0 ** -31), ("omega0", 2.0 ** -31),
                          ("af0", 2.0 ** -31), ("delta_n", 2.0 ** -43),
                          ("crc", 2.0 ** -5), ("cuc", 2.0 ** -29)):
            assert abs(getattr(g, name) - getattr(e, name)) <= lsb, name
        assert g.week == e.week and g.iodc == e.iodc
    assert b.iono is not None and abs(b.iono.alpha0 - 1.2e-8) < 2.0 ** -30
    assert b.utc is not None and b.utc.delta_t_ls == 18
    q = b.acq_assist[2]
    assert abs(q.doppler0_hz - (-2250.0)) <= 2.5
    assert abs(q.code_phase_chips - 512.25) <= 1.1
    assert q.code_phase_int_ms == 37
    return wire, b


def _session_loopback(M):
    srv = M.supl.SuplServer(bundle(M), port=0)
    try:
        cli = M.supl.SuplClient("127.0.0.1", srv.port)
        assert cli.get_assistance(244, 5, 0x59E2, 0x31B0) == 0
    finally:
        srv.close()
    assert set(cli.gps_ephemeris_map) == {2, 5, 17, 29}
    assert cli.gps_time is not None and cli.gps_time[0] == 2314 % 1024
    assert cli.gps_ref_loc is not None
    assert abs(cli.gps_ref_loc[0] - 41.275) < 1e-4
    assert cli.gps_iono.valid
    assert cli.gps_utc.valid and cli.gps_utc.delta_t_ls == 18
    assert 2 in cli.gps_acq_map
    return _client_maps(cli)


def _dead_server(M):
    cli = M.supl.SuplClient("127.0.0.1", 1)     # nothing listens there
    rc = cli.get_assistance()
    assert rc != 0
    return rc, _client_maps(cli)


def _feeds_receiver(M):
    srv = M.supl.SuplServer(bundle(M), port=0)
    try:
        cli = M.supl.SuplClient("127.0.0.1", srv.port)
        assert cli.get_assistance() == 0
    finally:
        srv.close()
    cfg = M.receiver.ReceiverConfig(fs_hz=4.092e6, n_channels=4,
                                    prn_search=(2, 5, 17, 29))
    rx = (M.receiver.Receiver(cfg, device="cpu") if M.pkg == PORT
          else M.receiver.Receiver(cfg))
    lat, lon, alt = cli.gps_ref_loc
    n_vis = rx.set_assistance(
        cli.gps_ephemeris_map,
        M.geo.llh_to_ecef(np.radians(lat), np.radians(lon), alt),
        cli.gps_time[1])
    assert 0 <= n_vis <= 4
    vis = sorted(rx._assist)
    assert (rx._assist_acq is None) == (not vis)
    if vis:
        assert rx._assist_acq.prns == vis
    return n_vis, rx._assist


def _bits_to_bytes(bits):
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _rrlp_iono_fixture(M):
    iono = M.lnav.GpsIono(alpha0=2 * 2.0 ** -30, alpha1=-3 * 2.0 ** -27,
                          alpha2=5 * 2.0 ** -24, alpha3=0.0,
                          beta0=7 * 2.0 ** 11, beta1=-8 * 2.0 ** 14,
                          beta2=1 * 2.0 ** 16, beta3=-1 * 2.0 ** 16,
                          valid=True)
    got = M.rrlp.encode_assistance_pdu(M.supl.SuplAssist(iono=iono),
                                       reference_number=1)
    bits = "001" + "0" + "010" + "0" + "000100" + "000010000"
    for q in (2, -3, 5, 0, 7, -8, 1, -1):
        bits += format((q + 128) & 0xFF, "08b")
    assert got == _bits_to_bytes(bits), got.hex()
    back = M.rrlp.decode_assistance_pdu(got)
    assert back.iono.valid
    assert back.iono.alpha1 == pytest.approx(-3 * 2.0 ** -27)
    assert back.iono.beta1 == pytest.approx(-8 * 2.0 ** 14)
    return got, back


def _rrlp_time_fixture(M):
    a = M.supl.SuplAssist(ref_time_week=220, ref_time_tow_s=345601.6)
    got = M.rrlp.encode_assistance_pdu(a, reference_number=3)
    bits = "011" + "0" + "010" + "0" + "000100" + "100000000" + "00"
    bits += format(4320020, "023b") + format(220, "010b")
    assert got == _bits_to_bytes(bits), got.hex()
    back = M.rrlp.decode_assistance_pdu(got)
    assert back.ref_time_week == 220
    assert back.ref_time_tow_s == pytest.approx(345601.6, abs=0.081)
    return got, back


def _rrlp_full_roundtrip(M):
    ephs = {p: M.scen.make_test_ephemeris(p, toe=345600.0)
            for p in (2, 17, 30)}
    a = M.supl.SuplAssist(
        ref_time_week=220, ref_time_tow_s=345600.0,
        ref_lat_deg=41.275, ref_lon_deg=-1.988, ref_alt_m=80.0,
        has_ref_location=True, ephemerides=ephs,
        iono=M.lnav.GpsIono(alpha0=1e-8, alpha1=-1.5e-8, alpha2=6e-8,
                            alpha3=6e-8, beta0=80e3, beta1=-16e3,
                            beta2=66e3, beta3=-66e3, valid=True),
        utc=M.lnav.GpsUtc(a0=3e-9, a1=-1e-14, tot=405504.0, wn_t=220,
                          delta_t_ls=18, wn_lsf=137, dn=7, delta_t_lsf=18,
                          valid=True),
        acq_assist={5: M.supl.AcqAssist(
            prn=5, doppler0_hz=-1250.0, doppler1_hz_s=-0.5,
            code_phase_chips=512.0, code_phase_int_ms=37,
            azimuth_deg=135.0, elevation_deg=45.0)})
    pdu = M.rrlp.encode_assistance_pdu(a)
    b = M.rrlp.decode_assistance_pdu(pdu)
    assert sorted(b.ephemerides) == [2, 17, 30]
    for p, e in ephs.items():
        d = b.ephemerides[p]
        assert d.iodc == e.iodc and d.week == 220
        assert d.sqrt_a == pytest.approx(e.sqrt_a, abs=2.0 ** -19)
        assert d.e == pytest.approx(e.e, abs=2.0 ** -33)
        assert d.m0 == pytest.approx(e.m0, abs=2.0 ** -31)
        assert d.af0 == pytest.approx(e.af0, abs=2.0 ** -31)
        assert d.omega_dot == pytest.approx(e.omega_dot, abs=2.0 ** -43)
        assert d.crs == pytest.approx(e.crs, abs=2.0 ** -5)
    assert b.has_ref_location
    assert b.ref_lat_deg == pytest.approx(41.275, abs=1e-5)
    assert b.ref_lon_deg == pytest.approx(-1.988, abs=1e-4)
    assert b.ref_alt_m == pytest.approx(80.0, abs=1.0)
    assert b.utc.delta_t_ls == 18 and b.utc.wn_lsf == 137
    q = b.acq_assist[5]
    assert q.doppler0_hz == pytest.approx(-1250.0, abs=2.5)
    assert q.doppler1_hz_s == pytest.approx(-0.5, abs=1 / 42)
    assert q.code_phase_chips == pytest.approx(512.0, abs=1.0)
    assert q.code_phase_int_ms == 37
    assert q.azimuth_deg == pytest.approx(135.0, abs=11.25)
    assert q.elevation_deg == pytest.approx(45.0, abs=11.25)
    return pdu, b


def _session_carries_rrlp(M):
    ephs = {p: M.scen.make_test_ephemeris(p, toe=345600.0) for p in (1, 9)}
    srv = M.supl.SuplServer(M.supl.SuplAssist(
        ref_time_week=220, ref_time_tow_s=345600.0, ephemerides=ephs),
        port=0)
    try:
        cli = M.supl.SuplClient("127.0.0.1", srv.port)
        assert cli.get_assistance() == 0
    finally:
        srv.close()
    assert sorted(cli.gps_ephemeris_map) == [1, 9]
    assert cli.gps_time == (220, pytest.approx(345600.0, abs=0.081))
    assert cli.gps_ephemeris_map[9].sqrt_a == pytest.approx(
        ephs[9].sqrt_a, abs=2.0 ** -19)
    return _client_maps(cli)


@pytest.mark.parametrize("case", [
    _payload_roundtrip, _session_loopback, _dead_server, _feeds_receiver,
    _rrlp_iono_fixture, _rrlp_time_fixture, _rrlp_full_roundtrip,
    _session_carries_rrlp],
    ids=["payload_roundtrip", "session_loopback", "dead_server",
         "feeds_receiver", "rrlp_iono_fixture", "rrlp_time_fixture",
         "rrlp_full_roundtrip", "session_carries_rrlp"])
def test_supl_matches_jax(case):
    """tests/test_supl.py's eight cases: the assistance payload at
    broadcast quantization, the loopback session, a dead server, the
    receiver's assisted acquisition fed from SUPL, the two hand-computed
    UPER fixtures, the full RRLP bundle, and the session's RRLP payload."""
    both(case)


@pytest.mark.parametrize("server_pkg,client_pkg", [(JAX, PORT), (PORT, JAX)])
def test_supl_wire_crosses_packages(server_pkg, client_pkg):
    """The two packages speak the same wire: a client of one reads a
    server of the other and decodes what a client of its own package
    decodes from a server of its own."""
    S, C = pkgmods(server_pkg), pkgmods(client_pkg)
    srv = S.supl.SuplServer(bundle(S), port=0)
    ref = C.supl.SuplServer(bundle(C), port=0)
    try:
        cross = C.supl.SuplClient("127.0.0.1", srv.port)
        own = C.supl.SuplClient("127.0.0.1", ref.port)
        assert cross.get_assistance() == own.get_assistance() == 0
    finally:
        srv.close()
        ref.close()
    want, got = _client_maps(own), _client_maps(cross)
    assert list(want[0]) == list(got[0]) == [2, 5, 17, 29]
    for x, y in zip(want, got):
        assert repr(x) == repr(y)
