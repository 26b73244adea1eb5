"""The port's multi-group receiver (runtime/multi_receiver.py) and its
configuration layer against the JAX package's.

- The inter-system-bias solve: the port's twins of
  tests/test_multi_receiver.py's two solver cases.
- `joint_fixes` of both packages on the same stub groups (the same epoch
  histories, decoders and configurations, the JAX MultiReceiver built with
  object.__new__): the same fixes, positions and clocks to 1e-6 m, per
  system PRN lists equal; with one and with two same-system groups, with
  and without the Hatch smoothers.
- `to_receiver_configs` of both packages on the three multi-group confs:
  the same groups with the same values.
- The shared-stream mode's fs check and the per-group stream count.

The slow cases are the port's twins of tests/test_system_mixed.py: the
GPS L1 C/A + Galileo E1B joint fix on one stream (held to the JAX
package's chunked path, `correlator='mxu'`, on the same capture: the same
joint-fix count, positions within 0.5 m) and the GPS L1 + L2C dual-band
run on two streams, each at the JAX test's bars."""

import dataclasses
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest

import gnss_sdr_1_tpu.siggen.scenario as jscen
import gnss_sdr_1_tpu_torch.siggen.scenario as tscen
from gnss_sdr_1_tpu.observables import ChannelEpochHistory as JHistory
from gnss_sdr_1_tpu.runtime.config import FileConfiguration as JConf
from gnss_sdr_1_tpu.runtime.config import to_receiver_configs as jrcs
from gnss_sdr_1_tpu.runtime.multi_receiver import MultiReceiver as JMulti
from gnss_sdr_1_tpu.runtime.receiver import ReceiverConfig as JCfg
from gnss_sdr_1_tpu_torch.constants import SPEED_OF_LIGHT_M_S
from gnss_sdr_1_tpu_torch.observables import ChannelEpochHistory
from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu_torch.pvt.solver import solve_pvt
from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig
from gnss_sdr_1_tpu_torch.runtime.config import FileConfiguration as TConf
from gnss_sdr_1_tpu_torch.runtime.config import to_receiver_configs as trcs
from gnss_sdr_1_tpu_torch.runtime.multi_receiver import (JointSolution,
                                                         MultiReceiver)
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONF_DIR = pathlib.Path(__file__).resolve().parent.parent / "conf"
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
MULTI_CONFS = ["glonass_l1_gps_l1_ibyte.conf", "hybrid_ishort.conf",
               "multisource_hybrid_ishort.conf"]


# ---------------------------------------------------------------------------
# the inter-system-bias solve (tests/test_multi_receiver.py's cases)
# ---------------------------------------------------------------------------


def test_isb_solver_two_systems():
    t_rx = 345601.0
    bias_g, bias_e = 2.1e-4, 2.1e-4 + 45e-9   # 45 ns inter-system bias
    scen = tscen.build_scenario(RX, [1, 2, 3, 4, 5, 6, 7, 8], t0_tow=t_rx,
                                duration_s=1.0)
    ephs, prs, systems = {}, {}, {}
    for i, p in enumerate(scen.ephemerides):
        tau = tscen.observed_delay_s(scen.ephemerides[p], RX, t_rx)
        sysid = "G" if i < 4 else "E"
        bias = bias_g if sysid == "G" else bias_e
        ephs[p] = scen.ephemerides[p]
        prs[p] = (tau + bias) * SPEED_OF_LIGHT_M_S
        systems[p] = sysid
    sol = solve_pvt(ephs, prs, t_rx + bias_g, systems=systems)
    assert sol.valid
    assert np.linalg.norm(sol.rx_ecef_m - RX) < 0.05
    # the alphabetically-first system's ('E') bias is reported; the 45 ns
    # inter-system bias is resolved, not smeared into position
    assert sol.rx_clock_bias_s == pytest.approx(bias_e, abs=1e-10)


def test_isb_solver_insufficient_per_system():
    """3 sats of one system + 1 of another = 4 total but 5 unknowns."""
    t_rx = 345601.0
    scen = tscen.build_scenario(RX, [1, 2, 3, 4], t0_tow=t_rx,
                                duration_s=1.0)
    ephs, prs, systems = {}, {}, {}
    for i, p in enumerate(scen.ephemerides):
        tau = tscen.observed_delay_s(scen.ephemerides[p], RX, t_rx)
        ephs[p] = scen.ephemerides[p]
        prs[p] = tau * SPEED_OF_LIGHT_M_S
        systems[p] = "G" if i < 3 else "E"
    assert not solve_pvt(ephs, prs, t_rx, systems=systems).valid


# ---------------------------------------------------------------------------
# joint_fixes on stub groups
# ---------------------------------------------------------------------------

T0 = 345601.25
# (signal, fs, PRNs, receiver-clock offset of the group's TOW tags [s])
GROUPS = {
    "gps_gal": [("1C", 4.0e6, (1, 2, 3, 4), 0.0),
                ("1B", 4.0e6, (11, 12, 13), 45e-9)],
    "l1_l2c": [("1C", 2.046e6, (1, 2, 3, 4), 0.0),
               ("2S", 2.046e6, (1, 2, 3, 4), -30e-9)],
}


def _stub_groups(mod, groups, smoothing, seed=3):
    """One stub receiver per group, from package `mod`'s scenario and
    ReceiverConfig: a history per PRN with a point every 4 ms over 1.5 s
    (the transmit TOW of the truth with 0.5 m of seeded code noise, the
    carrier phase following the range) and a decoder holding the
    scenario's ephemeris."""
    scen_mod = jscen if mod == "jax" else tscen
    rng = np.random.default_rng(seed)
    out = []
    for sig, fs, prns, offset in groups:
        scen = scen_mod.build_scenario(RX, list(prns), t0_tow=T0,
                                       duration_s=2.0)
        cfg = (JCfg if mod == "jax" else ReceiverConfig)(
            fs_hz=fs, signal_id=sig, n_channels=len(prns),
            prn_search=tuple(prns), carrier_smoothing_epochs=smoothing)
        lam = SPEED_OF_LIGHT_M_S / cfg.spec.carrier_freq_hz
        hists, decs = {}, {}
        for p in prns:
            h = (JHistory if mod == "jax" else ChannelEpochHistory)()
            for k in range(376):
                s = k * 0.004 * fs + 0.37 * (p % 5)
                t = T0 + s / fs
                tau = scen_mod.observed_delay_s(scen.ephemerides[p], RX, t)
                tow = t - tau - offset + rng.normal() * 0.5 \
                    / SPEED_OF_LIGHT_M_S
                h.push(s, tow, scen.truth[p]["doppler_hz"],
                       -2.0 * np.pi * tau * SPEED_OF_LIGHT_M_S / lam, 45.0)
            hists[p] = h
            decs[p] = SimpleNamespace(ephemeris=scen.ephemerides[p],
                                      ephemeris_complete=True)
        out.append(SimpleNamespace(cfg=cfg, histories=hists, decoders=decs))
    return out


@pytest.mark.parametrize("smoothing", [0, 25])
@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_joint_fixes_match_jax(groups, smoothing):
    mj = object.__new__(JMulti)
    mj.receivers = _stub_groups("jax", GROUPS[groups], smoothing)
    mt = object.__new__(MultiReceiver)
    mt.receivers = _stub_groups("port", GROUPS[groups], smoothing)
    sj, st = mj.joint_fixes(), mt.joint_fixes()
    assert len(st) == len(sj) > 50
    for a, b in zip(sj, st):
        assert isinstance(b, JointSolution)
        assert b.per_system_prns == a.per_system_prns
        assert b.solution.n_sats == a.solution.n_sats
        np.testing.assert_allclose(b.solution.rx_ecef_m, a.solution.rx_ecef_m,
                                   rtol=0, atol=1e-6)
        assert b.solution.rx_time_tow_s == a.solution.rx_time_tow_s
        assert b.solution.rx_clock_bias_s * SPEED_OF_LIGHT_M_S == \
            pytest.approx(a.solution.rx_clock_bias_s * SPEED_OF_LIGHT_M_S,
                          abs=1e-6)
    # the joint fix holds the truth: GPS + Galileo through one ISB column,
    # or two bands of the same four satellites with a clock column each
    err = np.linalg.norm(np.stack([s.solution.rx_ecef_m for s in st]) - RX,
                         axis=1)
    assert np.median(err) < 3.0
    if groups == "l1_l2c":
        assert all(len(s.per_system_prns["G"]) == 8 for s in st)
    else:
        assert all(set(s.per_system_prns) == {"G", "E"} for s in st)


def test_joint_fixes_need_four_distinct_satellites():
    """Two bands of three satellites are six measurements but only three
    lines of sight: no joint fix in either package."""
    groups = [("1C", 2.046e6, (1, 2, 3), 0.0), ("2S", 2.046e6, (1, 2, 3),
                                                 0.0)]
    mj = object.__new__(JMulti)
    mj.receivers = _stub_groups("jax", groups, 0)
    mt = object.__new__(MultiReceiver)
    mt.receivers = _stub_groups("port", groups, 0)
    assert mj.joint_fixes() == [] and mt.joint_fixes() == []


# ---------------------------------------------------------------------------
# configuration and the stream checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MULTI_CONFS)
def test_to_receiver_configs_match_jax(name):
    cj = jrcs(JConf(str(CONF_DIR / name)))
    ct = trcs(TConf(str(CONF_DIR / name)))
    assert [c.signal_id for c in ct] == [c.signal_id for c in cj]
    assert len(ct) == 2
    for a, b in zip(cj, ct):
        shared = ({f.name for f in dataclasses.fields(a)}
                  & {f.name for f in dataclasses.fields(b)})
        for f in sorted(shared):
            assert getattr(b, f) == getattr(a, f), (name, b.signal_id, f)
        # no conf key maps to the FDMA channel numbers in either package
        assert b.fdma_k == ()


def test_shared_stream_needs_one_fs():
    cfgs = [ReceiverConfig(fs_hz=4.0e6, signal_id="1C", n_channels=2,
                           prn_search=(1, 2)),
            ReceiverConfig(fs_hz=2.046e6, signal_id="1C", n_channels=2,
                           prn_search=(3, 4))]
    mrx = MultiReceiver(cfgs, device="cpu")
    with pytest.raises(ValueError, match="one common fs"):
        mrx.process(np.zeros(1000, np.complex64))
    with pytest.raises(ValueError, match="one sample stream per group"):
        mrx.process([np.zeros(1000, np.complex64)])
    with pytest.raises(ValueError):
        MultiReceiver([], device="cpu")
    assert [r.device.type for r in mrx.receivers] == ["cpu", "cpu"]


def test_groups_run_their_own_receivers_on_a_short_stream():
    """Two groups over 0.2 s of noise on the CPU: each group runs its own
    acquisition and tracking, and no group fixes (no signal)."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=800_000) + 1j * rng.normal(size=800_000)).astype(
        np.complex64)
    cfgs = [ReceiverConfig(fs_hz=4.0e6, signal_id="1C", n_channels=2,
                           prn_search=(1, 2)),
            ReceiverConfig(fs_hz=4.0e6, signal_id="1B", n_channels=2,
                           prn_search=(11, 12))]
    mrx = MultiReceiver(cfgs, device="cpu")
    assert mrx.process(x) == []
    assert [r.trk.chain_spec.K for r in mrx.receivers] == [3, 5]
    assert all(r._pos > 0 for r in mrx.receivers)


# ---------------------------------------------------------------------------
# the system scenarios (tests/test_system_mixed.py), slow
# ---------------------------------------------------------------------------


def _mixed_capture():
    from test_torch_capture_cache import cached_capture

    from gnss_sdr_1_tpu.codes import gps_l1ca_code, tracking_replica
    from gnss_sdr_1_tpu.constants import GALILEO_E1B, GPS_L1_CA
    from gnss_sdr_1_tpu.siggen.generator import generate_baseband

    fs, dur = 4.0e6, 30.0
    gps_prns, gal_prns = [1, 2, 3, 4], [11, 12, 13]
    scen_g = jscen.build_scenario(RX, gps_prns, t0_tow=345601.25,
                                  duration_s=dur, cn0_dbhz=47.0,
                                  subframe_cycle=(1, 2, 3))
    scen_e = jscen.build_scenario(RX, gal_prns, t0_tow=345601.25,
                                  duration_s=dur, cn0_dbhz=48.0,
                                  chip_rate=2.046e6, signal="1B")

    def _build():
        x = generate_baseband(
            GPS_L1_CA, scen_g.sats, {p: gps_l1ca_code(p) for p in gps_prns},
            fs, dur, noise=True)
        spec_e = dataclasses.replace(
            GALILEO_E1B, code_rate_chips_s=2.046e6,
            code_length_chips=2 * 4092, bit_rate_bps=250.0)
        return x + generate_baseband(
            spec_e, scen_e.sats,
            {p: tracking_replica("1B", p)[0] for p in gal_prns},
            fs, dur, noise=False)

    x = cached_capture(f"sysmixed_{fs:.0f}_{dur:.0f}_v1", _build)
    return gps_prns, gal_prns, scen_e, np.ascontiguousarray(x)


def _mixed_configs(mod, gps_prns, gal_prns):
    """tests/test_system_mixed.py's groups from its in-memory conf."""
    if mod == "jax":
        from gnss_sdr_1_tpu.runtime.config import InMemoryConfiguration
        conv = jrcs
    else:
        from gnss_sdr_1_tpu_torch.runtime.config import \
            InMemoryConfiguration
        conv = trcs
    conf = InMemoryConfiguration({
        "GNSS-SDR.internal_fs_sps": "4000000.0",
        "Channels_1C.count": "4",
        "Channels_1B.count": "3",
        "Acquisition_1C.implementation": "GPS_L1_CA_PCPS_Acquisition",
        "Acquisition_1B.implementation":
            "Galileo_E1_PCPS_Ambiguous_Acquisition",
        "Tracking_1C.implementation": "GPS_L1_CA_DLL_PLL_Tracking",
        "Tracking_1B.implementation": "Galileo_E1_DLL_PLL_VEML_Tracking",
    })
    cfgs = conv(conf)
    assert [c.signal_id for c in cfgs] == ["1C", "1B"]
    extra = {"correlator": "mxu"} if mod == "jax" else {}
    cfgs[0] = dataclasses.replace(cfgs[0], prn_search=tuple(gps_prns),
                                  **extra)
    cfgs[1] = dataclasses.replace(cfgs[1], prn_search=tuple(gal_prns),
                                  acq_dwells=3, pll_bw_hz=15.0,
                                  dll_bw_hz=2.0, **extra)
    return cfgs


@pytest.mark.slow
def test_mixed_joint_fix_matches_jax_chunked_path():
    """The GPS L1 + Galileo E1B joint fix on one 30 s stream: the port
    against the JAX package's chunked path on the same capture (the same
    joint-fix count, positions within 0.5 m), and the JAX system test's
    bars: >= 10 joint fixes, median 3D < 5 m, every fix on both systems,
    no Galileo-only fix.  The median bar is the one the chunked path
    misses on Galileo E1 with few satellites (ROADMAP.md §3): the test
    asserts the port's median and the JAX chunked path's alike."""
    gps_prns, gal_prns, scen_e, x = _mixed_capture()
    mj = JMulti(_mixed_configs("jax", gps_prns, gal_prns))
    sols_j = mj.process(x)
    mt = MultiReceiver(_mixed_configs("port", gps_prns, gal_prns),
                       device="cpu")
    sols_t = mt.process(x)
    assert len(mt.receivers[1].solutions) == 0
    assert len(sols_t) == len(sols_j) >= 10
    pj = np.stack([s.solution.rx_ecef_m for s in sols_j])
    pt = np.stack([s.solution.rx_ecef_m for s in sols_t])
    assert np.linalg.norm(pt - pj, axis=1).max() < 0.5
    for s in sols_t:
        assert set(s.per_system_prns) == {"G", "E"}
        assert len(s.per_system_prns["G"]) >= 3
        assert len(s.per_system_prns["E"]) >= 2
    e3d = np.linalg.norm(pt - RX, axis=1)
    assert np.median(e3d) < 5.0, f"median 3D {np.median(e3d):.2f} m"
    rx_e = mt.receivers[1]
    assert sum(d.ephemeris_complete for d in rx_e.decoders.values()) >= 2
    for p, d in rx_e.decoders.items():
        if d.ephemeris_complete:
            assert d.ephemeris.sqrt_a == pytest.approx(
                scen_e.ephemerides[p].sqrt_a, abs=2e-5)


@pytest.mark.slow
def test_dual_band_l1_l2c_joint():
    """tests/test_system_mixed.py's GPS L1 + L2C dual-band case on the
    port, on the CPU: the same satellites on two 55 s streams at
    2.046 Msps through MultiReceiver's per-group streams, at the JAX test's
    bars (>= 3 CNAV ephemerides, >= 10 joint fixes, converged-half median
    3D < 5 m, the L2 band in the joint fixes)."""
    from test_torch_capture_cache import cached_capture

    from gnss_sdr_1_tpu.codes import gps_l1ca_code, tracking_replica
    from gnss_sdr_1_tpu.constants import GPS_L1_CA, GPS_L2C
    from gnss_sdr_1_tpu.siggen.generator import generate_baseband
    from gnss_sdr_1_tpu_torch.telemetry.channel_adapters import \
        GpsL2ChannelDecoder

    prns = [1, 2, 3, 4]
    fs2, dur = 2.046e6, 55.0
    scen_1 = jscen.build_scenario(RX, prns, t0_tow=345601.25,
                                  duration_s=dur, cn0_dbhz=47.0,
                                  subframe_cycle=(1, 2, 3))
    scen_2 = jscen.build_scenario(RX, prns, t0_tow=345601.25,
                                  duration_s=dur, cn0_dbhz=47.0, signal="2S")
    x1 = cached_capture(
        f"dual_l1_{fs2:.0f}_{dur:.0f}_v1",
        lambda: generate_baseband(
            GPS_L1_CA, scen_1.sats, {p: gps_l1ca_code(p) for p in prns},
            fs2, dur, noise=True))
    codes2 = {p: tracking_replica("2S", p)[0] for p in prns}
    x2 = cached_capture(
        f"dual_l2_{fs2:.0f}_{dur:.0f}_v1",
        lambda: generate_baseband(GPS_L2C, scen_2.sats, codes2, fs2, dur,
                                  noise=True))
    cfg1 = ReceiverConfig(fs_hz=fs2, signal_id="1C", n_channels=4,
                          prn_search=tuple(prns),
                          carrier_smoothing_epochs=200)
    cfg2 = ReceiverConfig(fs_hz=fs2, signal_id="2S", n_channels=4,
                          prn_search=tuple(prns),
                          pll_bw_hz=4.0, dll_bw_hz=0.4,
                          doppler_max_hz=3000.0, doppler_step_hz=50.0,
                          acq_threshold=1.6, doppler_step2_hz=4.0,
                          num_doppler_bins_step2=50,
                          carrier_smoothing_epochs=200)
    mrx = MultiReceiver([cfg1, cfg2], device="cpu")
    sols = mrx.process([x1, x2])
    rx2 = mrx.receivers[1]
    assert all(isinstance(d, GpsL2ChannelDecoder)
               for d in rx2.decoders.values())
    n2 = sum(d.ephemeris_complete for d in rx2.decoders.values())
    assert n2 >= 3, f"only {n2} CNAV ephemerides decoded"
    assert len(sols) >= 10
    e3d = np.linalg.norm(np.stack([s.solution.rx_ecef_m for s in sols])
                         - RX, axis=1)
    assert np.median(e3d[len(e3d) // 2:]) < 5.0, np.median(e3d)
    assert np.median(e3d) < 20.0
    assert any(len(s.per_system_prns.get("G", [])) > 4 for s in sols)
