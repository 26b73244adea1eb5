"""The port's precise products, PPP, RTK, IONEX and tide modules
(pvt/{precise,ppp,rtk,rtk_ekf,ionex,tides}.py) against the JAX
package's: every case of tests/test_ppp.py, test_rtk.py, test_precise.py
and test_ionex_tides.py runs once through each package on the same seeded
inputs, each package building its own ephemerides, observations and
products from the same field values.  Each run keeps the reference test's
own bars, and the two runs agree bit for bit (arrays equal, dataclasses
field by field).  The solver's ephemeris dispatch sends the port's
PreciseEphemeris down the precise branch."""

import dataclasses
import importlib
import types

import numpy as np
import pytest

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JAX, PORT = "gnss_sdr_1_tpu", "gnss_sdr_1_tpu_torch"
T0 = 345600.0
F1 = 1575.42e6
F2 = 1227.60e6


def modules(pkg):
    """One package's modules under short names."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return types.SimpleNamespace(
        pkg=pkg, const=m("constants"), geo=m("pvt.geodesy"),
        atm=m("pvt.atmosphere"), eph=m("pvt.ephemeris"),
        solver=m("pvt.solver"), ppp=m("pvt.ppp"), rtk=m("pvt.rtk"),
        rtk_ekf=m("pvt.rtk_ekf"), precise=m("pvt.precise"),
        ionex=m("pvt.ionex"), tides=m("pvt.tides"),
        scen=m("siggen.scenario"), lnav=m("telemetry.lnav"))


def _owner(obj):
    mod = type(obj).__module__
    for pkg in (PORT, JAX):
        if mod == pkg or mod.startswith(pkg + "."):
            return pkg
    return None


def assert_same(a, b, path="result"):
    """`b` (the port's) equals `a` (the JAX package's) bit for bit, and
    every object of `b` that one of the packages defines is the port's
    own."""
    if _owner(a) == JAX:
        assert _owner(b) == PORT, f"{path}: {type(b)} is not the port's"
        assert type(a).__name__ == type(b).__name__, path
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)
    elif isinstance(a, (float, np.floating)) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, f"{path}: {b!r} != {a!r}"


def both(case, *args):
    """Run `case(modules, *args)` through the JAX package and the port,
    hold the results to each other, and return the port's."""
    want = case(modules(JAX), *args)
    got = case(modules(PORT), *args)
    assert_same(want, got)
    return got


# ---------------------------------------------------------------------------
# tests/test_ppp.py
# ---------------------------------------------------------------------------


def make_obs(M, rx_traj, towt, prns, ephs, ztd_wet=0.12, iono_zenith_m=3.0,
             code_noise=0.4, phase_noise=0.003, seed=7, dual=True,
             iono_model=None):
    """tests/test_ppp.py's _make_obs on package M's modules: geometric
    observables with tropo, iono, satellite clocks, a receiver clock ramp
    and per-satellite constant ambiguities."""
    c = M.const.SPEED_OF_LIGHT_M_S
    lam1, lam2 = c / F1, c / F2
    rng = np.random.default_rng(seed)
    amb1 = {p: rng.integers(-5000, 5000) * lam1 for p in prns}
    amb2 = {p: rng.integers(-5000, 5000) * lam2 for p in prns}
    epochs = []
    for k, tow in enumerate(towt):
        xk = rx_traj[k]
        lat, lon, hgt = M.geo.ecef_to_llh(xk)
        dry = M.ppp._dry_ztd_m(lat, hgt)
        dt_rx = 1e-7 * k
        obs = {}
        for p in prns:
            eph = ephs[p]
            tau = 0.07
            for _ in range(3):
                t_tx = tow - tau
                clk = M.eph.satellite_clock_correction(eph, t_tx)
                pos, _ = M.eph.satellite_position_velocity(eph, t_tx - clk)
                posr = M.solver._rotate_earth(pos, tau)
                tau = np.linalg.norm(posr - xk) / c
            rho = np.linalg.norm(posr - xk)
            az, el = M.geo.az_el(xk, posr)
            if np.degrees(el) < 10:
                continue
            m = M.ppp._map_el(el)
            trop = (dry + ztd_wet) * m
            if iono_model is not None:
                iono1 = M.atm.klobuchar_delay_m(iono_model, lat, lon, az, el,
                                                tow, F1)
            else:
                iono1 = iono_zenith_m * m
            iono2 = iono1 * (F1 / F2) ** 2
            clk = M.eph.satellite_clock_correction(eph, tow - tau)
            base = rho + c * (dt_rx - clk) + trop
            p1 = base + iono1 + rng.normal(0, code_noise)
            l1 = base - iono1 + amb1[p] + rng.normal(0, phase_noise)
            o = M.ppp.PppObs(pseudorange_m=p1, carrier_phase_cycles=-l1 / lam1)
            if dual:
                o.pseudorange2_m = base + iono2 + rng.normal(0, code_noise)
                o.carrier_phase2_cycles = -(base - iono2 + amb2[p]
                                            + rng.normal(0, phase_noise)) \
                    / lam2
            obs[p] = o
        epochs.append((tow + dt_rx, obs))
    return epochs


def geometry(M, prns=(2, 5, 11, 17, 23, 29), af0=True):
    """The PPP tests' six-satellite sky over the receiver at T0, built
    from package M's scenario helpers."""
    rx = M.geo.llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    prns = list(prns)
    toe = np.floor(T0 / 7200.0) * 7200.0
    raans, anoms = M.scen._auto_place(rx, prns, toe, T0)
    ephs = {p: M.scen.make_test_ephemeris(
        p, toe, plane_raan_deg=raans[i], anomaly_deg=anoms[i],
        **({"af0": 1e-5 * (i % 3)} if af0 else {}))
        for i, p in enumerate(prns)}
    return rx, prns, ephs


def _static_epochs(M, rx, prns, ephs, **kw):
    towt = T0 + np.arange(0, 240, 2.0)
    return make_obs(M, np.tile(rx, (len(towt), 1)), towt, prns, ephs, **kw)


def _ppp_static_dual(M):
    rx, prns, ephs = geometry(M)
    sol = M.ppp.solve_ppp(_static_epochs(M, rx, prns, ephs, dual=True), ephs,
                          M.ppp.PppConfig(mode="PPP_Static", f1_hz=F1,
                                          f2_hz=F2))
    assert sol.valid
    assert np.linalg.norm(sol.rx_ecef_m - rx) < 0.5
    assert abs(sol.ztd_wet_m - 0.12) < 0.05
    return sol


def _ppp_static_graphic(M):
    rx, prns, ephs = geometry(M)
    iono = M.lnav.GpsIono(alpha0=1.2e-8, alpha1=1.5e-8, alpha2=-6.0e-8,
                          alpha3=-6.0e-8, beta0=8.0e4, beta1=9.8e4,
                          beta2=-6.6e4, beta3=-3.3e5)
    epochs = _static_epochs(M, rx, prns, ephs, dual=False, iono_model=iono)
    sol = M.ppp.solve_ppp(epochs, ephs, M.ppp.PppConfig(
        mode="PPP_Static", f1_hz=F1, f2_hz=None, iono=iono))
    assert sol.valid
    assert np.linalg.norm(sol.rx_ecef_m - rx) < 1.0
    return sol


def _ppp_kinematic(M):
    rx, prns, ephs = geometry(M)
    towt = T0 + np.arange(0, 240, 2.0)
    east = np.array([-np.sin(np.radians(1.988)),
                     np.cos(np.radians(1.988)), 0.0])
    traj = rx[None, :] + 0.1 * (towt - T0)[:, None] * east[None, :]
    epochs = make_obs(M, traj, towt, prns, ephs, dual=True)
    sol = M.ppp.solve_ppp(epochs, ephs, M.ppp.PppConfig(
        mode="PPP_Kinematic", f1_hz=F1, f2_hz=F2, kinematic_process_m=0.5))
    assert sol.valid and sol.epoch_positions is not None
    errs = [np.linalg.norm(x - traj[k])
            for k, (_t, x) in enumerate(sol.epoch_positions)]
    assert np.median(errs) < 0.7
    disp = np.linalg.norm(sol.epoch_positions[-1][1]
                          - sol.epoch_positions[0][1])
    assert 19.0 < disp < 29.0
    return sol


def _ppp_cycle_slip(M):
    rx, prns, ephs = geometry(M)
    epochs = _static_epochs(M, rx, prns, ephs, dual=True)
    for _tow, obs in epochs[60:]:
        if prns[0] in obs:
            obs[prns[0]].carrier_phase_cycles += 10.0
            if obs[prns[0]].carrier_phase2_cycles is not None:
                obs[prns[0]].carrier_phase2_cycles += 10.0
    sol = M.ppp.solve_ppp(epochs, ephs, M.ppp.PppConfig(
        mode="PPP_Static", f1_hz=F1, f2_hz=F2))
    assert sol.valid
    assert sol.n_arcs >= len(prns) + 1
    assert np.linalg.norm(sol.rx_ecef_m - rx) < 0.6
    return sol


@pytest.mark.parametrize("case", [_ppp_static_dual, _ppp_static_graphic,
                                  _ppp_kinematic, _ppp_cycle_slip],
                         ids=["static_dual", "static_graphic", "kinematic",
                              "cycle_slip"])
def test_ppp_matches_jax(case):
    """tests/test_ppp.py's four cases: PPP_Static dual-frequency and
    single-frequency GRAPHIC, PPP_Kinematic on a drifting receiver, and a
    cycle slip opening a new arc."""
    both(case)


# ---------------------------------------------------------------------------
# tests/test_rtk.py
# ---------------------------------------------------------------------------


def _lambda_recovers_integers(M):
    rng = np.random.default_rng(5)
    n = 8
    out = []
    for _ in range(5):
        a_true = rng.integers(-50, 50, size=n).astype(float)
        B = rng.standard_normal((n, n)) * 0.2
        Q = B @ B.T + 0.05 * np.eye(n)
        noise = np.linalg.cholesky(Q) @ rng.standard_normal(n) * 0.3
        cands, s = M.rtk.lambda_ilse(a_true + noise, Q, m=2)
        assert s[0] <= s[1]
        np.testing.assert_array_equal(cands[0], a_true)
        out.append((cands, s))
    return out


def _lambda_identity_rounds(M):
    cands, s = M.rtk.lambda_ilse(np.array([1.2, -3.4, 0.49]),
                                 np.eye(3) * 0.01, m=2)
    np.testing.assert_array_equal(cands[0], [1.0, -3.0, 0.0])
    return cands, s


class _Obs:
    def __init__(self, pr, ph):
        self.pseudorange_m = pr
        self.carrier_phase_cycles = ph


def synthetic_baseline(M, rover_offset, n_epochs=10, seed=7, dt_s=3.0,
                       n_sats=8):
    """tests/test_rtk.py's _synthetic_baseline on package M's modules:
    base and rover on the same ephemerides, per-receiver clock biases,
    integer carrier ambiguities and thermal noise."""
    c = M.const.SPEED_OF_LIGHT_M_S
    lam = c / 1575.42e6
    rng = np.random.default_rng(seed)
    base = M.geo.llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    rover = base + np.asarray(rover_offset)
    prns = list(range(1, 1 + n_sats))
    t0 = 345601.0
    toe = np.floor(t0 / 7200.0) * 7200.0
    raans, anoms = M.scen._auto_place(base, prns, toe, t0)
    ephs = {p: M.scen.make_test_ephemeris(p, toe, plane_raan_deg=raans[i],
                                          anomaly_deg=anoms[i])
            for i, p in enumerate(prns)}
    amb = {p: float(rng.integers(-30, 30)) for p in prns}

    def epochs_for(rx_ecef, ambs, bias_scale):
        out = []
        for k in range(n_epochs):
            tow = t0 + k * dt_s
            clk = rng.uniform(-1e-3, 1e-3) * bias_scale
            obs = {}
            for p in prns:
                tau = M.scen.observed_delay_s(ephs[p], rx_ecef, tow)
                pr = (tau + clk) * c + rng.normal(0, 0.4)
                ph = (-(tau + clk) * c / lam + ambs[p]
                      + rng.normal(0, 0.004 / lam))
                obs[p] = _Obs(pr, ph)
            out.append((tow, obs))
        return out

    base_epochs = epochs_for(base, {p: 0.0 for p in prns}, 1.0)
    rover_epochs = epochs_for(rover, amb, 1.3)
    return base, rover, ephs, base_epochs, rover_epochs, lam


def _dgnss(M):
    base, rover, ephs, be, re, lam = synthetic_baseline(
        M, [30.0, -12.0, 5.0], n_epochs=12)
    sol = M.rtk.solve_baseline(re, be, base, ephs, lam, mode="DGNSS")
    assert sol.valid
    assert np.linalg.norm(sol.rover_ecef_m - rover) < 0.9
    return sol


def _rtk_static(M):
    base, rover, ephs, be, re, lam = synthetic_baseline(
        M, [55.0, 20.0, -8.0], n_epochs=20)
    sol = M.rtk.solve_baseline(re, be, base, ephs, lam, mode="Static")
    assert sol.valid
    assert np.linalg.norm(sol.rover_float_ecef_m - rover) < 1.0
    assert sol.fixed, f"ratio={sol.ratio}"
    assert np.linalg.norm(sol.rover_ecef_m - rover) < 0.03
    return sol


def _rtk_kinematic(M):
    base, rover, ephs, be, re, lam = synthetic_baseline(
        M, [15.0, 40.0, 3.0], n_epochs=20)
    sol = M.rtk.solve_baseline(re, be, base, ephs, lam, mode="Kinematic")
    assert sol.valid and sol.fixed
    errs = [np.linalg.norm(x - rover) for _, x in sol.epoch_positions]
    assert np.median(errs) < 0.05
    return sol


def _base_interpolation(M):
    be = [(10.0, {1: _Obs(100.0, 50.0)}), (12.0, {1: _Obs(104.0, 52.0)})]
    got = M.rtk.interpolate_base(be, 11.0)
    assert got[1] == (102.0, 51.0)
    assert M.rtk.interpolate_base(be, 9.0) is None
    return got


def _ekf_static(M):
    base, rover, ephs, be, re, lam = synthetic_baseline(
        M, [55.0, 20.0, -8.0], n_epochs=30)
    sols = M.rtk_ekf.solve_baseline_ekf(re, be, base, ephs, lam,
                                        mode="Static")
    assert len(sols) >= 25
    tail = sols[len(sols) // 2:]
    ferr = [np.linalg.norm(s.rover_float_ecef_m - rover) for s in tail]
    assert np.median(ferr) < 0.5
    fixed = [s for s in tail if s.fixed]
    assert len(fixed) >= len(tail) // 2
    fx = [np.linalg.norm(s.rover_fixed_ecef_m - rover) for s in fixed]
    assert np.median(fx) < 0.05
    return sols


def _ekf_kinematic(M):
    c = M.const.SPEED_OF_LIGHT_M_S
    lam = c / 1575.42e6
    rng = np.random.default_rng(11)
    base = M.geo.llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    prns = list(range(1, 9))
    t0 = 345601.0
    toe = np.floor(t0 / 7200.0) * 7200.0
    raans, anoms = M.scen._auto_place(base, prns, toe, t0)
    ephs = {p: M.scen.make_test_ephemeris(p, toe, plane_raan_deg=raans[i],
                                          anomaly_deg=anoms[i])
            for i, p in enumerate(prns)}
    amb = {p: float(rng.integers(-30, 30)) for p in prns}
    vel = np.array([0.8, -0.5, 0.3])

    def epochs_for(pos0, v, ambs, bias_scale):
        out = []
        for k in range(40):
            tow = t0 + k * 1.0
            rx = pos0 + v * (k * 1.0)
            clk = rng.uniform(-1e-3, 1e-3) * bias_scale
            obs = {}
            for p in prns:
                tau = M.scen.observed_delay_s(ephs[p], rx, tow)
                pr = (tau + clk) * c + rng.normal(0, 0.4)
                ph = (-(tau + clk) * c / lam + ambs[p]
                      + rng.normal(0, 0.004 / lam))
                obs[p] = _Obs(pr, ph)
            out.append((tow, obs))
        return out

    be = epochs_for(base, np.zeros(3), {p: 0.0 for p in prns}, 1.0)
    re = epochs_for(base + [40.0, 10.0, 0.0], vel, amb, 1.3)
    ekf = M.rtk_ekf.RtkEkf(base, ephs, lam, mode="Kinematic")
    for tow, robs in re:
        bobs = M.rtk.interpolate_base(be, tow)
        if bobs is not None:
            ekf.process_epoch(tow, robs, bobs)
    sols = ekf.solutions
    assert len(sols) >= 30
    tail = sols[15:]
    errs = []
    for s in tail:
        truth = base + np.asarray([40.0, 10.0, 0.0]) + vel * (s.tow - t0)
        pos = s.rover_fixed_ecef_m if s.fixed else s.rover_float_ecef_m
        errs.append(np.linalg.norm(pos - truth))
    assert np.median(errs) < 0.3
    assert sum(s.fixed for s in tail) >= len(tail) // 2
    return sols


@pytest.mark.parametrize("case", [
    _lambda_recovers_integers, _lambda_identity_rounds, _dgnss, _rtk_static,
    _rtk_kinematic, _base_interpolation, _ekf_static, _ekf_kinematic],
    ids=["lambda_integers", "lambda_identity", "dgnss", "static",
         "kinematic", "base_interpolation", "ekf_static", "ekf_kinematic"])
def test_rtk_matches_jax(case):
    """tests/test_rtk.py's eight cases: LAMBDA on correlated and identity
    covariances, the DGNSS / Static / Kinematic batch baselines, the base
    interpolation, and the sequential EKF static and kinematic."""
    both(case)


# ---------------------------------------------------------------------------
# tests/test_precise.py
# ---------------------------------------------------------------------------


def _sp3_roundtrip(M, tmp_path):
    _rx, prns, ephs = geometry(M)
    prod = M.precise.sp3_from_broadcast(ephs, T0 - 900, T0 + 1800,
                                        step_s=300.0, week=2204)
    path = tmp_path / f"{M.pkg}.sp3"
    M.precise.write_sp3(path, prod)
    back = M.precise.read_sp3(str(path))
    assert back.week == prod.week
    np.testing.assert_allclose(back.epochs_tow, prod.epochs_tow, atol=1e-6)
    for p in prns:
        np.testing.assert_allclose(back.positions[p], prod.positions[p],
                                   atol=2e-3)
        np.testing.assert_allclose(back.clocks[p], prod.clocks[p],
                                   atol=1e-11)
    return prod, back, path.read_text()


def _sp3_interpolation(M):
    _rx, prns, ephs = geometry(M)
    prod = M.precise.sp3_from_broadcast(ephs, T0 - 1800, T0 + 1800,
                                        step_s=300.0)
    out = []
    for p in prns[:3]:
        for t in (T0 + 37.0, T0 + 151.0, T0 + 600.5):
            pos_i, vel_i = prod.sat_position_velocity(p, t)
            pos_t, vel_t = M.solver.sat_pos_vel(ephs[p], t)
            assert np.linalg.norm(pos_i - pos_t) < 1e-3
            assert np.linalg.norm(vel_i - vel_t) < 1e-3
            clk = prod.sat_clock(p, t)
            assert abs(clk - M.solver.sat_clock(ephs[p], t)) < 2e-10
            out.append((pos_i, vel_i, clk))
    return out


def _precise_adapter(M):
    c = M.const.SPEED_OF_LIGHT_M_S
    rx, prns, ephs = geometry(M)
    prod = M.precise.sp3_from_broadcast(ephs, T0 - 1800, T0 + 1800,
                                        step_s=300.0)
    pephs = prod.as_ephemerides()
    prs = {}
    for p in prns:
        tau = 0.07
        for _ in range(3):
            pos, _v = M.solver.sat_pos_vel(ephs[p], T0 - tau)
            tau = np.linalg.norm(M.solver._rotate_earth(pos, tau) - rx) / c
        clk = M.solver.sat_clock(ephs[p], T0 - tau)
        prs[p] = (tau - clk) * c
    # the dispatch takes the precise branch: the adapter's own
    # interpolation, not the Keplerian propagator
    t = T0 + 151.0
    for p in prns:
        pos, vel = M.solver.sat_pos_vel(pephs[p], t)
        np.testing.assert_array_equal(
            pos, prod.sat_position_velocity(p, t)[0])
        assert M.solver.sat_clock(pephs[p], t) == prod.sat_clock(p, t)
    sol = M.solver.solve_pvt(pephs, prs, T0)
    assert sol.valid
    assert np.linalg.norm(sol.rx_ecef_m - rx) < 1.0
    return sol


def _ppp_precise_beats_broadcast(M):
    rx, prns, ephs = geometry(M)
    epochs = _static_epochs(M, rx, prns, ephs, dual=True)
    toe = np.floor(T0 / 7200.0) * 7200.0
    raans, anoms = M.scen._auto_place(rx, prns, toe, T0)
    bad = {}
    for i, p in enumerate(prns):
        e = M.scen.make_test_ephemeris(p, toe, plane_raan_deg=raans[i],
                                       anomaly_deg=anoms[i],
                                       af0=1e-5 * (i % 3))
        e.m0 += 1.5e-7 * (1 + (i % 3))
        e.af0 += 1e-8 * ((i % 5) - 2)
        bad[p] = e
    cfg = dict(mode="PPP_Static", f1_hz=F1, f2_hz=F2)
    sol_bad = M.ppp.solve_ppp(epochs, bad, M.ppp.PppConfig(**cfg))
    assert sol_bad.valid
    err_bad = np.linalg.norm(sol_bad.rx_ecef_m - rx)
    sp3 = M.precise.sp3_from_broadcast(ephs, T0 - 1800, T0 + 2100,
                                       step_s=300.0)
    sol_prec = M.ppp.solve_ppp(epochs, bad, M.ppp.PppConfig(
        precise=sp3, **cfg))
    assert sol_prec.valid
    err_prec = np.linalg.norm(sol_prec.rx_ecef_m - rx)
    assert err_prec < 0.5 and err_prec < err_bad
    up = rx / np.linalg.norm(rx)
    d = sol_prec.rx_ecef_m - rx
    assert np.linalg.norm(d - np.dot(d, up) * up) < 0.5
    return sol_bad, sol_prec


@pytest.mark.parametrize("case", [
    _sp3_roundtrip, _sp3_interpolation, _precise_adapter,
    _ppp_precise_beats_broadcast],
    ids=["sp3_roundtrip", "interpolation", "adapter_solver",
         "ppp_precise"])
def test_precise_matches_jax(case, tmp_path):
    """tests/test_precise.py's four cases: the SP3 write/read round trip
    (the two files are the same text), Neville interpolation against the
    Keplerian orbit, PreciseEphemeris through solve_pvt's dispatch, and
    PPP with precise products beating a degraded broadcast."""
    if case is _sp3_roundtrip:
        both(case, tmp_path)
    else:
        both(case)


def test_precise_ephemeris_takes_the_precise_branch():
    """sat_pos_vel picks the precise path by `position_velocity` and
    GLONASS by `tb_s`: the port's PreciseEphemeris takes the first, a
    Keplerian ephemeris the broadcast propagator, in both packages."""
    for pkg in (JAX, PORT):
        M = modules(pkg)
        _rx, prns, ephs = geometry(M)
        prod = M.precise.sp3_from_broadcast(ephs, T0 - 1800, T0 + 1800,
                                            step_s=300.0)
        pe = prod.as_ephemerides()[prns[0]]
        assert _owner(pe) == pkg and hasattr(pe, "position_velocity")
        assert not hasattr(ephs[prns[0]], "position_velocity")
        t = T0 + 600.5
        kep = M.eph.satellite_position_velocity(ephs[prns[0]], t)
        np.testing.assert_array_equal(
            M.solver.sat_pos_vel(ephs[prns[0]], t)[0], kep[0])
        assert M.solver.sat_clock(pe, t) == prod.sat_clock(prns[0], t)


# ---------------------------------------------------------------------------
# tests/test_ionex_tides.py
# ---------------------------------------------------------------------------

LAT, LON = np.radians(41.275), np.radians(1.988)


def tec_product(M, vtec=20.0):
    lats = np.arange(60.0, 19.0, -5.0)
    lons = np.arange(-20.0, 21.0, 5.0)
    tec = np.full((3, len(lats), len(lons)), float(vtec))
    tec += np.linspace(0, 4, len(lons))[None, None, :]
    tec += np.array([0.0, 2.0, 4.0])[:, None, None]
    return M.ionex.TecProduct(
        epochs_tow=np.array([T0 - 3600, T0, T0 + 3600.0]), lats=lats,
        lons=lons, tec=tec, week=2204)


def _ionex_roundtrip(M, tmp_path):
    prod = tec_product(M)
    path = tmp_path / f"{M.pkg}.24i"
    M.ionex.write_ionex(path, prod)
    back = M.ionex.read_ionex(str(path), week=2204)
    np.testing.assert_allclose(back.epochs_tow, prod.epochs_tow)
    np.testing.assert_allclose(back.lats, prod.lats)
    np.testing.assert_allclose(back.lons, prod.lons)
    np.testing.assert_allclose(back.tec, prod.tec, atol=0.051)
    assert back.hgt_km == prod.hgt_km
    return back, path.read_text()


def _tec_delay(M):
    prod = tec_product(M)
    d_hi = prod.delay_m(T0, LAT, LON, 0.3, np.radians(80.0))
    d_lo = prod.delay_m(T0, LAT, LON, 0.3, np.radians(15.0))
    assert 3.0 < d_hi < 4.5 and d_lo > 1.8 * d_hi
    d_mid = prod.delay_m(T0 + 1800.0, LAT, LON, 0.3, np.radians(80.0))
    assert d_mid > d_hi + 0.08
    assert prod.delay_m(T0 + 7300.0, LAT, LON, 0.3, 1.0) is None
    d5 = prod.delay_m(T0, LAT, LON, 0.3, np.radians(80.0),
                      freq_hz=1176.45e6)
    assert d5 == pytest.approx(d_hi * (1575.42 / 1176.45) ** 2, rel=1e-9)
    return d_hi, d_lo, d_mid, d5


def sbas_pseudoranges(M, rx, prns, ephs, iono_vert_m, fast_bias, rng):
    """tests/test_sbas_corrections.py's _pseudoranges on package M:
    geometric pseudoranges with an iono slab and per-satellite biases."""
    c = M.const.SPEED_OF_LIGHT_M_S
    prs = {}
    for p in prns:
        tau = 0.07
        for _ in range(3):
            pos, _v = M.solver.sat_pos_vel(ephs[p], T0 - tau)
            tau = np.linalg.norm(M.solver._rotate_earth(pos, tau) - rx) / c
        clk = M.solver.sat_clock(ephs[p], T0 - tau)
        pos, _v = M.solver.sat_pos_vel(ephs[p], T0 - tau)
        _az, el = M.geo.az_el(rx, M.solver._rotate_earth(pos, tau))
        fp = 1.0 / np.sqrt(
            1.0 - (6378.1363 / (6378.1363 + 350.0) * np.cos(el)) ** 2)
        prs[p] = ((tau - clk) * c + iono_vert_m * fp
                  + fast_bias.get(p, 0.0) + rng.normal(0.0, 0.3))
    return prs


def _tec_sat_corr(M):
    rx, prns, ephs = geometry(M, af0=False)
    prs = sbas_pseudoranges(M, rx, prns, ephs, 3.3, {},
                            np.random.default_rng(5))
    prod = tec_product(M, vtec=20.0)
    sol_raw = M.solver.solve_pvt(ephs, prs, T0, raim=False)
    sol_tec = M.solver.solve_pvt(ephs, prs, T0, raim=False,
                                 sat_corr=prod.sat_corr())
    e_raw = np.linalg.norm(sol_raw.rx_ecef_m - rx)
    e_tec = np.linalg.norm(sol_tec.rx_ecef_m - rx)
    assert e_tec < e_raw and e_tec < 2.5
    return sol_raw, sol_tec


def _sun_moon(M):
    rs, rm, gmst = M.tides.sun_moon_pos_ecef(2204, T0)
    assert abs(np.linalg.norm(rs) - 1.496e11) < 0.05e11
    assert 3.5e8 < np.linalg.norm(rm) < 4.2e8
    assert 0.0 <= gmst < 2.0 * np.pi
    return rs, rm, gmst


def _tides(M):
    rx = M.geo.llh_to_ecef(LAT, LON, 80.0)
    drs = [M.tides.tide_displacement(2204, T0 + 3600.0 * k, rx)
           for k in range(25)]
    mags = np.array([np.linalg.norm(d) for d in drs])
    assert 0.02 < mags.max() < 0.6 and mags.max() - mags.min() > 0.01
    return drs


def _ppp_tec_tides(M):
    rx, prns, ephs = geometry(M, af0=False)
    epochs = _static_epochs(M, rx, prns, ephs, dual=False, iono_zenith_m=3.3)
    sol = M.ppp.solve_ppp(epochs, ephs, M.ppp.PppConfig(
        mode="PPP_Static", f1_hz=F1, f2_hz=None, tec=tec_product(M),
        tides_week=2204))
    assert sol.valid
    assert np.linalg.norm(sol.rx_ecef_m - rx) < 2.0
    return sol


@pytest.mark.parametrize("case", [
    _ionex_roundtrip, _tec_delay, _tec_sat_corr, _sun_moon, _tides,
    _ppp_tec_tides],
    ids=["ionex_roundtrip", "tec_delay", "tec_sat_corr", "sun_moon",
         "tides", "ppp_tec_tides"])
def test_ionex_tides_match_jax(case, tmp_path):
    """tests/test_ionex_tides.py's six cases: the IONEX round trip (the
    same text), TEC slant delay with obliquity and time interpolation,
    the TEC sat_corr hook through solve_pvt, the Sun and Moon positions,
    the solid-earth tide, and PPP with TEC and tides."""
    if case is _ionex_roundtrip:
        both(case, tmp_path)
    else:
        both(case)
