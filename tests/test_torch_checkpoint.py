"""Checkpoint / resume of the port's Receiver (device='cpu'): a receiver
checkpointed after the first half of a capture and resumed from the file
holds the checkpointed receiver's state (sample clock, assignments,
decoders' ephemeris state, the tracking state, `_empty_acq_streak`), and
its run over the second half gives the uninterrupted receiver's symbol
counts and tracking state.  The file holds numpy and host objects only
(no torch tensor), so it does not tie a run to a device.  The slow case is
tests/test_checkpoint_resume.py's at full size."""

import pickle
import pickletools

import numpy as np
import pytest

from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.siggen.generator import generate_baseband
from gnss_sdr_1_tpu_torch.siggen.scenario import build_scenario
from gnss_sdr_1_tpu_torch.track.engine import state_to_numpy
from test_torch_capture_cache import cached_capture
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
PRNS = (3, 8, 14, 22)


def _n_eph(rx):
    return sum(1 for d in rx.decoders.values() if d.ephemeris_complete)


def _globals(path):
    """Module names of every global a pickle file refers to."""
    mods = []
    with open(path, "rb") as f:
        ops = list(pickletools.genops(f))
    strings = [arg for op, arg, _ in ops if op.name in ("SHORT_BINUNICODE",
                                                        "BINUNICODE",
                                                        "UNICODE")]
    for op, arg, _ in ops:
        if op.name == "GLOBAL":
            mods.append(arg.split(" ")[0])
    # STACK_GLOBAL takes module and name from the two strings before it
    mods += [s for s in strings if "." in s and " " not in s
             and s.split(".")[0] in ("torch", "gnss_sdr_1_tpu",
                                     "gnss_sdr_1_tpu_torch", "numpy")]
    return mods


@pytest.fixture(scope="module")
def resumed(one_torch_thread, tmp_path_factory):  # noqa: F811
    scen = build_scenario(RX, list(PRNS), t0_tow=345606.1,
                          duration_s=4.0 + 2e-3, cn0_dbhz=47.0,
                          subframe_cycle=(1, 2, 3))
    x = generate_baseband(GPS_L1_CA, scen.sats,
                          {p: gps_l1ca_code(p) for p in PRNS}, FS,
                          4.0 + 2e-3, noise=True, seed=1234)
    # one channel more than satellites: the idle channel's empty
    # acquisitions count in _empty_acq_streak
    cfg = ReceiverConfig(fs_hz=FS, n_channels=len(PRNS) + 1,
                         prn_search=PRNS)
    ck = str(tmp_path_factory.mktemp("ckpt") / "receiver.ckpt")
    rx1 = Receiver(cfg, device="cpu")
    rx1.process(x[:int(2.1 * FS)])
    at_split = {
        "abs_base": rx1._abs_base, "channel_prn": list(rx1.channel_prn),
        "n_eph": _n_eph(rx1), "streak": rx1._empty_acq_streak,
        "state": state_to_numpy(rx1.state),
        "decoders": pickle.dumps(rx1.decoders)}
    rx1.checkpoint(ck)
    rx2 = Receiver.resume_from(ck, device="cpu")
    resumed_at_split = {"state": state_to_numpy(rx2.state),
                        "decoders": pickle.dumps(rx2.decoders),
                        "rx": (rx2._abs_base, list(rx2.channel_prn),
                               _n_eph(rx2), rx2._empty_acq_streak)}
    consumed = rx1._abs_base
    rx1.process(x[consumed:])             # the uninterrupted receiver
    rx2.process(x[consumed:])
    return at_split, resumed_at_split, rx1, rx2, ck


def test_resumed_receiver_holds_the_state_at_the_split(resumed):
    at, back, _, _, _ = resumed
    assert at["abs_base"] > 0
    assert back["rx"] == (at["abs_base"], at["channel_prn"], at["n_eph"],
                          at["streak"])
    # the idle channel's empty acquisitions survived the round trip
    assert at["streak"] > 0
    # every decoder's state (symbols, bit sync, subframes, ephemeris)
    assert back["decoders"] == at["decoders"]
    for name, v in at["state"].items():
        if isinstance(v, tuple):
            for a, b in zip(v, back["state"][name]):
                np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(v, back["state"][name],
                                          err_msg=name)


def test_resumed_run_equals_the_uninterrupted_run(resumed):
    _, _, rx1, rx2, _ = resumed
    assert rx2._abs_base == rx1._abs_base
    assert rx2.channel_prn == rx1.channel_prn
    assert rx2.sym_count == rx1.sym_count
    assert list(rx2._mode_host) == list(rx1._mode_host)
    assert rx2._empty_acq_streak == rx1._empty_acq_streak
    for prn, d in rx1.decoders.items():
        assert rx2.decoders[prn].bit_offset == d.bit_offset is not None
        np.testing.assert_array_equal(rx2.decoders[prn]._sym.start_samples,
                                      d._sym.start_samples)
    s1, s2 = state_to_numpy(rx1.state), state_to_numpy(rx2.state)
    for name in ("active", "start", "cur_len", "mode", "rem_code_phase_"
                 "samples", "carrier_doppler_hz"):
        np.testing.assert_array_equal(s2[name], s1[name], err_msg=name)


def test_checkpoint_holds_no_torch_object(resumed):
    ck = resumed[4]
    mods = _globals(ck)
    assert not [m for m in mods if m.startswith("torch")], mods
    assert not [m for m in mods if m.split(".")[0] == "gnss_sdr_1_tpu"]
    with open(ck, "rb") as f:
        blob = pickle.load(f)
    assert blob["version"] == 1 and "_empty_acq_streak" in blob
    assert all(isinstance(v, np.ndarray) or isinstance(v, tuple)
               for v in blob["track_state"].values())


def test_other_versions_refused(tmp_path):
    p = tmp_path / "v2.ckpt"
    with open(p, "wb") as f:
        pickle.dump({"version": 2}, f)
    with pytest.raises(ValueError, match="unsupported checkpoint version: 2"):
        Receiver.resume_from(str(p), device="cpu")


@pytest.mark.slow
def test_checkpoint_resume_continues_run_full_size(tmp_path):
    """tests/test_checkpoint_resume.py at its size: 24 s, six satellites
    at 4 Msps, checkpointed at 12 s: >= 30 fixes, the last 10 within 1 m of
    an uninterrupted run's."""
    fs, dur, prns = 4.0e6, 24.0, (1, 2, 3, 4, 5, 6)
    scen = build_scenario(RX, list(prns), t0_tow=345601.25, duration_s=dur,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    x = cached_capture(
        f"syspos_{fs:.0f}_{dur:.0f}",
        lambda: generate_baseband(GPS_L1_CA, scen.sats,
                                  {p: gps_l1ca_code(p) for p in prns}, fs,
                                  dur, noise=True))
    cfg = ReceiverConfig(fs_hz=fs, n_channels=6, prn_search=prns)
    ck = str(tmp_path / "receiver.ckpt")
    rx1 = Receiver(cfg, device="cpu")
    rx1.process(x[:int(fs * 12.0)])
    consumed = rx1._abs_base
    rx1.checkpoint(ck)
    rx2 = Receiver.resume_from(ck, device="cpu")
    assert rx2._abs_base == consumed
    assert rx2.channel_prn == rx1.channel_prn
    assert _n_eph(rx2) == _n_eph(rx1)
    np.testing.assert_array_equal(rx2.state.start.numpy(),
                                  rx1.state.start.numpy())
    sols = rx2.process(x[consumed:])
    assert len(sols) >= 30
    e = np.stack([s.rx_ecef_m - scen.rx_ecef for s in sols[-10:]])
    assert np.median(np.linalg.norm(e, axis=1)) < 5.0
    rx3 = Receiver(cfg, device="cpu")
    sols3 = rx3.process(x)
    d = np.linalg.norm(np.mean([s.rx_ecef_m for s in sols[-10:]], axis=0)
                       - np.mean([s.rx_ecef_m for s in sols3[-10:]], axis=0))
    assert d < 1.0, f"resumed vs uninterrupted final fix differs by {d:.2f} m"


@pytest.mark.slow
def test_resumed_fix_count_matches_jax(tmp_path):
    """A resumed receiver's fixes against the JAX package's (its chunked
    `mxu` path, as the port's default), on the verify recipe's capture
    (six satellites, 24 s at 2.046 Msps), uninterrupted and checkpointed
    at 12 s: the same fix counts and first-fix times in both packages, and
    in both the resumed run's count differs from the uninterrupted one's.
    The resume restarts `process()`'s segment grid at the split, so the
    fourth ephemeris is first seen at another segment's end and the
    512-point observables history then reaches back to another epoch
    (ROADMAP.md §3, chip_smoke.py [30]'s 132 fixes against [5]'s 159)."""
    from gnss_sdr_1_tpu.runtime import Receiver as JaxReceiver
    from gnss_sdr_1_tpu.runtime import ReceiverConfig as JaxConfig

    fs, dur, prns = 2.046e6, 24.0, (1, 2, 3, 4, 5, 6)
    scen = build_scenario(RX, list(prns), t0_tow=345601.25, duration_s=dur,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    x = cached_capture(
        f"syspos_{fs:.0f}_{dur:.0f}",
        lambda: generate_baseband(GPS_L1_CA, scen.sats,
                                  {p: gps_l1ca_code(p) for p in prns}, fs,
                                  dur, noise=True))
    split = int(fs * 12.0)

    def runs(make, resume):
        full = make().process(x)
        rx1 = make()
        rx1.process(x[:split])
        consumed = rx1._abs_base
        ck = str(tmp_path / "receiver.ckpt")
        rx1.checkpoint(ck)
        resumed = resume(ck).process(x[consumed:])
        return [(len(s), s[0].rx_time_tow_s) for s in (list(full),
                                                        list(resumed))]

    port = runs(lambda: Receiver(ReceiverConfig(fs_hz=fs, n_channels=6,
                                                prn_search=prns),
                                 device="cpu"),
                lambda ck: Receiver.resume_from(ck, device="cpu"))
    jax_ = runs(lambda: JaxReceiver(JaxConfig(fs_hz=fs, n_channels=6,
                                              prn_search=prns,
                                              correlator="mxu")),
                JaxReceiver.resume_from)
    for (n_t, t_t), (n_j, t_j) in zip(port, jax_):
        assert n_t == n_j
        assert abs(t_t - t_j) < 1e-3
    assert port[0][0] != port[1][0]
