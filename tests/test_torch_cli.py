"""The port's conf-file CLI and its configuration layer against the JAX
package's: every conf in conf/ parses to the same items and frontend; the
six GPS L1 C/A confs, the two Galileo E1 confs, the GPS L5 and L2C confs,
the Galileo E5a (CAF) conf, the BeiDou B1I conf and the three multi-group
confs (GPS L1 + Galileo E1 on one or two sources, GPS L1 + GLONASS L1)
that need only what the port carries map to the same ReceiverConfig values
and build a Receiver; the multi-group ones run through the
mixed-constellation branch; `--signal B1` and `--signal B3` run;
`--telecommand_port`, `--monitor_port` and `--pvt_monitor_port` run and
serve their sockets; every other conf, and every flag of a feature not
ported yet, is refused with its ROADMAP.md item; the block registries agree; and both CLIs print
the same lines on a short capture.  The slow case runs both CLIs to fixes
on a 24 s capture."""

import dataclasses
import json
import pathlib
import socket

import numpy as np
import pytest

from gnss_sdr_1_tpu import __main__ as jcli
from gnss_sdr_1_tpu.runtime import factory as jfactory
from gnss_sdr_1_tpu.runtime.config import FileConfiguration as JConf
from gnss_sdr_1_tpu.runtime.config import build_frontend as jbuild
from gnss_sdr_1_tpu.runtime.config import to_receiver_config as jrc
from gnss_sdr_1_tpu_torch import __main__ as tcli
from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
from gnss_sdr_1_tpu_torch.ops import chunk_corr as cc
from gnss_sdr_1_tpu_torch.ops.cluster_walk import SMEM_MAX
from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu_torch.runtime import Receiver
from gnss_sdr_1_tpu_torch.runtime import factory as tfactory
from gnss_sdr_1_tpu_torch.runtime.config import FileConfiguration as TConf
from gnss_sdr_1_tpu_torch.runtime.config import build_frontend as tbuild
from gnss_sdr_1_tpu_torch.runtime.config import to_receiver_config as trc
from gnss_sdr_1_tpu_torch.siggen.generator import generate_baseband
from gnss_sdr_1_tpu_torch.siggen.scenario import build_scenario
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONF_DIR = pathlib.Path(__file__).resolve().parent.parent / "conf"
CONFS = sorted(p.name for p in CONF_DIR.glob("*.conf"))
PORTED = ["bds_b1i_ibyte.conf", "galileo_e1_gr_complex.conf",
          "galileo_e1_quicksync.conf", "galileo_e5a.conf",
          "glonass_l1_gps_l1_ibyte.conf", "gps_l1_if_xlating.conf",
          "gps_l1_ishort.conf", "gps_l1_kalman.conf", "gps_l1_nsr.conf",
          "gps_l1_rtl_tcp.conf", "gps_l1_two_bit_packed.conf",
          "gps_l2c_ibyte.conf", "gps_l5.conf", "hybrid_ishort.conf",
          "multisource_hybrid_ishort.conf"]
MULTI_GROUP = ["glonass_l1_gps_l1_ibyte.conf", "hybrid_ishort.conf",
               "multisource_hybrid_ishort.conf"]
UNPORTED = [c for c in CONFS if c not in PORTED]
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
FS_FLAGS = 2.046e6


def test_corpus_split():
    assert len(CONFS) == 16 and UNPORTED == ["gps_l1_supl_assisted.conf"]
    assert set(PORTED) <= set(CONFS)


@pytest.mark.parametrize("name", CONFS)
def test_conf_parses_like_jax(name):
    path = str(CONF_DIR / name)
    cj, ct = JConf(path), TConf(path)
    assert dict(ct.items()) == dict(cj.items())
    assert dataclasses.asdict(tbuild(ct)) == dataclasses.asdict(jbuild(cj))


@pytest.mark.parametrize("name", PORTED)
def test_ported_conf_maps_like_jax(name):
    path = str(CONF_DIR / name)
    rj, rt = jrc(JConf(path)), trc(TConf(path))
    shared = ({f.name for f in dataclasses.fields(rt)}
              & {f.name for f in dataclasses.fields(rj)})
    # every field but the port's own chunk length and the QuickSync
    # folding factor it reads from the conf (the JAX receiver fixes it at 2)
    assert {f.name for f in dataclasses.fields(rt)} - shared == {
        "chunk_epochs", "acq_folding_factor"}
    for f in sorted(shared):
        assert getattr(rt, f) == getattr(rj, f), f
    rx = Receiver(rt, device="cpu")
    assert rx.trk_kind == rt.track_engine
    if rx.trk_kind == "dll_pll":
        # the chunk correlator's geometry holds at this rate (a
        # non-integer number of samples per chip included), on any
        # cluster the card may give a channel
        spec = rx.trk.corr_spec
        for G in (1, 8, cc.MAX_CLUSTER):
            geo = cc.corr_geometry(spec.E, spec.LW, spec.NW, G)
            assert geo.smem <= SMEM_MAX and (geo.MB, geo.NB) == (1, 1)
        # 5 taps (VE/E/P/L/VL) for Galileo E1B, 3 for GPS L1 C/A, L5
        # and Galileo E5a
        assert rx.trk.chain_spec.K == (5 if rt.signal_id == "1B" else 3)
        assert rx.trk.chain_spec.order in (2, 3)


@pytest.mark.parametrize("name,strategy,channels,fs", [
    ("galileo_e1_gr_complex.conf", "pcps", 8, 4.092e6),
    ("galileo_e1_quicksync.conf", "quicksync", 6, 4.0e6)])
def test_galileo_confs_map(name, strategy, channels, fs):
    rt = trc(TConf(str(CONF_DIR / name)))
    assert (rt.signal_id, rt.acq_strategy, rt.n_channels, rt.fs_hz) == (
        "1B", strategy, channels, fs)
    assert rt.acq_folding_factor == 2 and not rt.acq_tong
    assert rt.track_engine == "dll_pll"
    assert rt.extend_correlation_symbols == 0
    rx = Receiver(rt, device="cpu")
    assert type(rx.acq).__name__ == (
        "QuickSyncAcquisition" if strategy == "quicksync"
        else "PcpsAcquisition")
    assert rx.trk.cfg.veml and rx.trk.cfg.early_late_space_chips == 0.15


@pytest.mark.parametrize("name,signal,strategy,fs,sec_len", [
    ("gps_l5.conf", "L5", "pcps", 12.5e6, 10),
    ("galileo_e5a.conf", "5X", "caf", 12.0e6, 20)])
def test_l5_e5a_confs_map(name, signal, strategy, fs, sec_len, capsys):
    """Both confs map to their signal, strategy, rate and 6 channels; the
    receiver carries the secondary code in the chain (NH10 / CS20) and the
    conf's extension default (none off GPS L1 C/A) as the JAX package's
    does, and the CLI accepts the signal."""
    rt = trc(TConf(str(CONF_DIR / name)))
    assert (rt.signal_id, rt.acq_strategy, rt.n_channels, rt.fs_hz) == (
        signal, strategy, 6, fs)
    assert rt.extend_correlation_symbols == 0
    rx = Receiver(rt, device="cpu")
    assert type(rx.acq).__name__ == (
        "CafAcquisition" if strategy == "caf" else "PcpsAcquisition")
    assert rx._sec_period == sec_len
    spec = rx.trk.chain_spec
    assert (spec.K, spec.sec_len, spec.sec_data, spec.ext_n) == (
        3, sec_len, True, 1)
    # the flag passes; the run stops at the missing file
    with pytest.raises(SystemExit):
        tcli.main(["--signal_file", "missing.dat", "--device", "cpu",
                   "--signal", signal])
    err = capsys.readouterr().err
    assert "signal file not found" in err and "ROADMAP" not in err


def test_galileo_tong_and_folding_keys_map(tmp_path):
    """The Tong counters (tong_init_val, tong_max_val) and QuickSync's
    folding factor come from the conf; the JAX package maps the Tong
    implementation name alike and keeps its own defaults for the keys."""
    base = (CONF_DIR / "galileo_e1_quicksync.conf").read_text()
    tong = tmp_path / "tong.conf"
    tong.write_text(base.replace(
        "Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition",
        "Galileo_E1_PCPS_Tong_Ambiguous_Acquisition")
        + "Acquisition_1B.tong_init_val=3\nAcquisition_1B.tong_max_val=7\n")
    rt, rj = trc(TConf(str(tong))), jrc(JConf(str(tong)))
    assert (rt.acq_strategy, rt.acq_tong) == (rj.acq_strategy,
                                              rj.acq_tong) == ("tong", True)
    assert (rt.tong_init, rt.tong_max) == (3, 7)
    assert Receiver(rt, device="cpu")._acq_tong
    fold = tmp_path / "fold.conf"
    fold.write_text(base.replace("folding_factor=2", "folding_factor=4"))
    rx = Receiver(trc(TConf(str(fold))), device="cpu")
    assert rx.acq.fold == 4


@pytest.mark.parametrize("name,item", [
    ("gps_l1_supl_assisted.conf", "item 4")])
def test_unported_conf_names_its_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        trc(TConf(str(CONF_DIR / name)))


@pytest.mark.parametrize("name", PORTED)
def test_ported_conf_runs_through_cli(name, tmp_path, capsys):
    """The port's CLI runs each ported conf end to end on the CPU over
    0.1 s of random items in the conf's item_type at its source rate (the
    conf names no file here, so --signal_file gives one)."""
    from gnss_sdr_1_tpu_torch.io.formats import FORMATS

    conf = TConf(str(CONF_DIR / name))
    fe = tbuild(conf)
    fmt = FORMATS[conf.property("SignalSource.item_type", "ishort")]
    n_items = int(fe.source_fs_hz * 0.1) * fmt.items_per_sample \
        // fmt.samples_per_item
    rng = np.random.default_rng(17)
    if fmt.dtype == np.complex64:
        raw = (rng.standard_normal(n_items)
               + 1j * rng.standard_normal(n_items)).astype(np.complex64)
    else:
        info = np.iinfo(fmt.dtype)
        raw = rng.integers(info.min, info.max, size=n_items, endpoint=True,
                           dtype=np.int64).astype(fmt.dtype)
    cap = tmp_path / "cap.raw"
    raw.tofile(cap)
    lines = _run(tcli, ["-c", str(CONF_DIR / name), "--signal_file",
                        str(cap), "--device", "cpu", "--channels", "2",
                        "--out_dir", str(tmp_path / "out")], capsys)
    sid = trc(conf).signal_id
    assert lines[0].startswith("Processing ") and f"2 {sid} channels" in \
        lines[0]
    assert (lines[1].startswith("Conditioning: ")) == (not fe.is_passthrough)
    assert any(ln.startswith("Processed in ") for ln in lines)
    if name in MULTI_GROUP:
        # the groups run at the conf's channel counts, as the JAX CLI runs
        # them (--channels sets the first group's configuration only)
        assert _mixed_line(name) in lines
        assert lines[-1] == "No joint position fix obtained."
    else:
        assert lines[-1] == "No position fix obtained."


def _mixed_line(name):
    """The JAX CLI's `Mixed-constellation run:` line for a multi-group
    conf, from the JAX package's own group configurations."""
    from gnss_sdr_1_tpu.runtime.config import to_receiver_configs as jrcs

    cfgs = jrcs(JConf(str(CONF_DIR / name)))
    return (f"Mixed-constellation run: "
            f"{'+'.join(c.signal_id for c in cfgs)} "
            f"({'/'.join(str(c.n_channels) for c in cfgs)} channels)")


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_conf_refused_with_roadmap_item(name, capsys):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 item"):
        trc(TConf(str(CONF_DIR / name)))
    with pytest.raises(SystemExit) as e:
        tcli.main(["-c", str(CONF_DIR / name), "--device", "cpu",
                   "--signal_file", str(CONF_DIR / name)])
    assert e.value.code == 2
    assert "ROADMAP.md §1 item" in capsys.readouterr().err


@pytest.mark.parametrize("flag,value", [
    ("--base_obs", "base.rtcm"), ("--assist", "a.json"),
    ("--supl", "localhost")])
def test_unported_flag_refused(flag, value, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--signal_file", "x.dat", "--device", "cpu", flag, value])
    assert e.value.code == 2
    assert "ROADMAP.md §1 item" in capsys.readouterr().err


def _free_port(kind):
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("flag", ["--telecommand_port", "--monitor_port",
                                  "--pvt_monitor_port"])
def test_monitor_and_telecommand_flags_run(flag, tmp_path, capsys,
                                           monkeypatch):
    """Each flag on a 0.1 s ishort capture of one GPS satellite (random
    items would track nothing for a monitor to send): the CLI exits 0 and
    the other side sees the traffic.  --telecommand_port: a client gets
    the receiver's status over TCP while the receiver runs.
    --monitor_port: Gnss_Synchro records of the tracked PRN over UDP.
    --pvt_monitor_port: the receiver's PVT sink aims at the port and sends
    one datagram a fix; 0.1 s has no fix, so none arrives
    (tests/test_torch_streaming.py's slow case counts them on 24 s)."""
    import threading

    from gnss_sdr_1_tpu_torch import runtime

    cap = tmp_path / "cap.ishort"
    _write_ishort(cap, [3], FS_FLAGS, 0.1, 345606.1)
    built = []
    served = threading.Event()

    class Recorded(runtime.Receiver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

        def process(self, samples):
            if flag == "--telecommand_port":
                assert served.wait(10.0), "no telecommand client served"
            return super().process(samples)

    monkeypatch.setattr(runtime, "Receiver", Recorded)
    kind = (socket.SOCK_STREAM if flag == "--telecommand_port"
            else socket.SOCK_DGRAM)
    port = _free_port(kind)
    sock = None
    replies = []
    if kind == socket.SOCK_DGRAM:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("127.0.0.1", port))
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    else:
        def client():
            for _ in range(1000):
                try:
                    with socket.create_connection(("127.0.0.1", port),
                                                  timeout=5) as s:
                        f = s.makefile("rw")
                        f.write("status\n")
                        f.flush()
                        replies.append(f.readline().strip())
                        served.set()
                        return
                except OSError:
                    served.wait(0.01)

        threading.Thread(target=client, daemon=True).start()
    lines = _run(tcli, ["--signal_file", str(cap), "--item_type", "ishort",
                        "--fs", str(FS_FLAGS), "--channels", "1",
                        "--device", "cpu", "--out_dir",
                        str(tmp_path / "out"), flag, str(port)], capsys)
    assert any(ln.startswith("Processed in ") for ln in lines)
    assert lines[-1] == "No position fix obtained."
    (rx,) = built
    if flag == "--telecommand_port":
        assert lines[1] == f"Telecommand listening on port {port}"
        assert replies and replies[0].startswith("channels ")
        return
    sock.setblocking(False)
    recs = []
    while True:
        try:
            recs += sock.recv(1 << 20).decode().splitlines()
        except BlockingIOError:
            break
    sock.close()
    if flag == "--monitor_port":
        assert rx.monitor._addr == ("127.0.0.1", port)
        assert recs and all(json.loads(r)["prn"] == 3 for r in recs)
    else:
        assert rx.monitor is None
        assert rx.pvt_monitor._addr == ("127.0.0.1", port)
        assert len(recs) == len(rx.solutions) == 0


@pytest.mark.parametrize("signal,fs", [("B1", 5.0e6), ("B3", 12.5e6)])
def test_beidou_signal_flag_runs(signal, fs, tmp_path, capsys):
    """`--signal B1` and `--signal B3` run the BeiDou receiver end to end
    on the CPU over 0.1 s of random ishort items (B1 at
    bds_b1i_ibyte.conf's 5 Msps, B3 at 12.5 Msps): no fix, exit 0."""
    rng = np.random.default_rng(19)
    raw = rng.integers(-2000, 2000, size=2 * int(fs * 0.1)).astype(np.int16)
    cap = tmp_path / "cap.ishort"
    raw.tofile(cap)
    lines = _run(tcli, ["--signal_file", str(cap), "--item_type", "ishort",
                        "--fs", str(fs), "--signal", signal, "--channels",
                        "2", "--device", "cpu", "--out_dir",
                        str(tmp_path / "out")], capsys)
    assert lines[0].startswith(f"Processing {int(fs * 0.1)} samples") \
        and f"2 {signal} channels" in lines[0]
    assert any(ln.startswith("Processed in ") for ln in lines)
    assert lines[-1] == "No position fix obtained."


def test_cli_needs_a_card_unless_asked_for_the_cpu(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        tcli.main(["--signal_file", "x.dat"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_registries_match():
    assert list(tfactory.REGISTRY) == list(jfactory.REGISTRY)
    for name, bj in jfactory.REGISTRY.items():
        bt = tfactory.REGISTRY[name]
        assert (bt.kind, bt.signal, bt.strategy, bt.status) == (
            bj.kind, bj.signal, bj.strategy, bj.status), name
    with pytest.raises(KeyError):
        tfactory.resolve("No_Such_Block")
    # every strategy of the JAX package's but assisted acquisition (item 4)
    assert set(tfactory.STRATEGY_IMPL) == set(jfactory.STRATEGY_IMPL) - {
        ("acquisition", "assisted")}
    for kind, strategy in tfactory.STRATEGY_IMPL:
        assert tfactory.strategy_impl(kind, strategy).__module__.startswith(
            "gnss_sdr_1_tpu_torch.")


def _write_ishort(path, prns, fs, duration, t0_tow, scale=1500.0):
    scen = build_scenario(RX, prns, t0_tow=t0_tow, duration_s=duration,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(GPS_L1_CA, scen.sats,
                          {p: gps_l1ca_code(p) for p in prns}, fs, duration,
                          noise=True)
    iq = np.empty(2 * len(x), dtype=np.int16)
    iq[0::2] = np.clip(np.round(x.real * scale), -32767, 32767)
    iq[1::2] = np.clip(np.round(x.imag * scale), -32767, 32767)
    iq.tofile(path)
    return scen


def _run(cli, argv, capsys):
    assert cli.main(argv) == 0
    return capsys.readouterr().out.splitlines()


def test_cli_lines_match_jax(tmp_path, capsys):
    """gps_l1_ishort.conf (4 Msps ishort, Direct_Resampler to 2 Msps) on a
    0.3 s, 2-channel capture: the same Processing and Conditioning lines and
    the same outcome."""
    cap = tmp_path / "cap.ishort"
    _write_ishort(cap, [3, 8], 4.0e6, 0.3, 345606.1)
    common = ["-c", str(CONF_DIR / "gps_l1_ishort.conf"), "--signal_file",
              str(cap), "--channels", "2"]
    lj = _run(jcli, common + ["--platform", "cpu", "--out_dir",
                              str(tmp_path / "j")], capsys)
    lt = _run(tcli, common + ["--device", "cpu", "--out_dir",
                              str(tmp_path / "t")], capsys)
    assert lt[0].startswith("Processing 1200000 samples (0.3 s)")
    assert lt[1].startswith("Conditioning: fs 4000000 -> 2000000 Hz")
    assert lt[:2] == lj[:2]
    assert lt[2].startswith("Processed in") and lj[2].startswith(
        "Processed in")
    assert lt[2].split(";")[1] == lj[2].split(";")[1]
    assert lt[3:] == lj[3:]


@pytest.mark.slow
def test_cli_fixes_match_jax_on_24s_capture(tmp_path, capsys):
    """The verify recipe's capture (24 s, 6 satellites, 2.046 Msps ishort):
    the same fix count, identical brdc.rnx, the same observables.rnx
    epochs, GeoJSON positions within 0.5 m of each other."""
    cap = tmp_path / "verify.ishort"
    scen = _write_ishort(cap, [1, 2, 3, 4, 5, 6], 2.046e6, 24.0, 345601.25)
    conf = tmp_path / "verify.conf"
    conf.write_text("\n".join([
        "GNSS-SDR.internal_fs_sps=2046000",
        "SignalSource.implementation=File_Signal_Source",
        f"SignalSource.filename={cap}",
        "SignalSource.item_type=ishort",
        "SignalSource.sampling_frequency=2046000",
        "SignalConditioner.implementation=Pass_Through",
        "Channels_1C.count=6",
        "Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition",
        "Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking",
        # the JAX package's chunked engine (the port's counterpart)
        "Tracking_1C.correlator=mxu",
        "PVT.positioning_mode=Single", ""]))
    outs = {}
    for tag, cli, extra in (("j", jcli, ["--platform", "cpu"]),
                            ("t", tcli, ["--device", "cpu"])):
        lines = _run(cli, ["-c", str(conf), "--out_dir", str(tmp_path / tag)]
                     + extra, capsys)
        fixes = int(lines[1].split(";")[1].split()[0])
        outs[tag] = (fixes, tmp_path / tag)
    (fj, dj), (ft, dt) = outs["j"], outs["t"]
    assert ft == fj >= 40
    for name in ("position.kml", "position.gpx", "position.geojson",
                 "position.nmea", "observables.rnx", "brdc.rnx",
                 "observables.rtcm"):
        assert (dt / name).exists() and (dj / name).exists(), name
    assert (dt / "brdc.rnx").read_bytes() == (dj / "brdc.rnx").read_bytes()

    def epochs(d):
        return [ln for ln in (d / "observables.rnx").read_text().splitlines()
                if ln.startswith(">")]

    assert epochs(dt) == epochs(dj) and len(epochs(dt)) > 0

    def positions(d):
        feat = json.loads((d / "position.geojson").read_text())
        lon, lat, h = np.asarray(feat["geometry"]["coordinates"],
                                 np.float64).T
        return llh_to_ecef(np.radians(lat), np.radians(lon), h).T

    pj, pt = positions(dj), positions(dt)
    assert pj.shape == pt.shape
    assert np.linalg.norm(pt - pj, axis=1).max() < 0.5
    assert np.median(np.linalg.norm(pt - scen.rx_ecef, axis=1)) < 5.0


def _glonass_receiver_stub(mod):
    """A Receiver stand-in for package `mod` that has tracked one GLONASS
    slot: its decoder holds a broadcast state vector, one observables
    epoch and one fix near the scenario's receiver."""
    from types import SimpleNamespace

    from gnss_sdr_1_tpu_torch.observables import Observation
    from gnss_sdr_1_tpu_torch.pvt.solver import PvtSolution

    rx_ecef = llh_to_ecef(np.radians(55.75), np.radians(37.62), 180.0)
    scen = build_scenario(rx_ecef, [4], t0_tow=35995.0, duration_s=10.0,
                          chip_rate=0.511e6, signal="1G", fdma_ks={4: 1})
    eph = scen.ephemerides[4]
    tow = 36000.0
    obs = {4: Observation(prn=4, pseudorange_m=2.1e7, tow_s=tow - 0.07,
                          doppler_hz=-1234.5, carrier_phase_cycles=-1.1e8,
                          cn0_dbhz=44.0)}
    sol = PvtSolution(True, rx_ecef, 1e-4, np.zeros(3), 0.0, tow,
                      lat_deg=55.75, lon_deg=37.62, height_m=180.0,
                      dops={"pdop": 2.0, "hdop": 1.0, "vdop": 1.5,
                            "gdop": 2.4, "tdop": 1.1}, n_sats=5)

    class Stub:
        def __init__(self, cfg, device=None):
            self.cfg = cfg
            self.decoders = {4: SimpleNamespace(
                ephemeris=eph, raw=SimpleNamespace(ephemeris=eph),
                ephemeris_complete=True, iono=None)}
            self.obs_epochs = [(tow, obs)]

        def preload(self, samples):
            pass

        def process(self, samples):
            return [sol]

    return Stub


def test_glonass_group_writes_rinex_and_rtcm(tmp_path, capsys, monkeypatch):
    """A GLONASS ('1G') group's outputs through the CLI, with the receiver
    stubbed to one tracked slot: RINEX obs and nav for system R and an RTCM
    stream with the MT1005 GLONASS flag, the GLONASS ephemeris and MSM7.
    The receiver's time is the GLONASS time of day (10:00 here); the
    ephemeris' day number (NT 104: 13 April 1996, as the nav record dates
    it) dates the observation epochs (07:00 UTC) and the MSM7 epoch (day
    of week 6, 10:00 GLONASS time).  The JAX CLI raises AttributeError on
    the same run, reading a GPS week off a GLONASS ephemeris (which has
    none)."""
    import gnss_sdr_1_tpu.runtime as jrt
    import gnss_sdr_1_tpu_torch.runtime as trt
    from gnss_sdr_1_tpu_torch.pvt import rtcm

    cap = tmp_path / "glo.ishort"
    np.zeros(2 * 41000, np.int16).tofile(cap)
    argv = ["--signal_file", str(cap), "--item_type", "ishort", "--fs",
            "4.092e6", "--signal", "1G", "--channels", "1"]
    monkeypatch.setattr(trt, "Receiver", _glonass_receiver_stub("port"))
    lines = _run(tcli, argv + ["--device", "cpu", "--out_dir",
                               str(tmp_path / "t")], capsys)
    assert lines[-1] == f"Outputs written to {tmp_path / 't'}/"
    out = tmp_path / "t"
    nav = (out / "brdc.rnx").read_text().splitlines()
    assert "N: GNSS NAV DATA" in nav[0]
    assert any(ln.startswith("R04") for ln in nav)     # the state vector
    assert any(ln.startswith("R04 1996 04 13 10 00 00") for ln in nav)
    obs = (out / "observables.rnx").read_text()
    assert "R04" in obs
    assert "> 1996 04 13 07 00  0.0000000" in obs
    frames = (out / "observables.rtcm").read_bytes()
    msgs = []
    while frames:
        n = 3 + (((frames[1] & 0x03) << 8) | frames[2]) + 3
        msgs.append(rtcm.deframe(frames[:n]))
        frames = frames[n:]
    assert msgs[0][0] == 1005
    assert {1020, 1087} <= {m[0] for m in msgs}
    msm = rtcm.decode_msm(next(p for n, p in msgs if n == 1087))
    assert (msm["glonass_dow"], msm["glonass_tod_ms"]) == (6, 36_000_000)
    monkeypatch.setattr(jrt, "Receiver", _glonass_receiver_stub("jax"))
    with pytest.raises(AttributeError, match="week"):
        jcli.main(argv + ["--platform", "cpu", "--out_dir",
                          str(tmp_path / "j")])


def _conf_with(tmp_path, base, **extra):
    """conf/`base` with keys added or replaced (dots written as '__')."""
    text = (CONF_DIR / base).read_text()
    items = [f"{k.replace('__', '.')}={v}" for k, v in extra.items()]
    path = tmp_path / f"with_{len(items)}_{base}"
    path.write_text(text + "\n" + "\n".join(items) + "\n")
    return path


def test_gather_correlator_maps_like_jax_and_runs(tmp_path, capsys):
    """`Tracking_1C.correlator=gather` maps as in the JAX package and runs
    through the port's gather engine: gps_l1_ishort.conf on the 0.3 s,
    2-channel capture of test_cli_lines_match_jax, both CLIs on their
    gather paths, print the same lines but the wall time."""
    conf = _conf_with(tmp_path, "gps_l1_ishort.conf",
                      Tracking_1C__correlator="gather")
    rj, rt = jrc(JConf(str(conf))), trc(TConf(str(conf)))
    assert rt.correlator == rj.correlator == "gather"
    rx = Receiver(rt, device="cpu")
    assert rx.trk.correlator == "gather" and rx.trk.gather_spec.K == 3
    cap = tmp_path / "cap.ishort"
    _write_ishort(cap, [3, 8], 4.0e6, 0.3, 345606.1)
    common = ["-c", str(conf), "--signal_file", str(cap), "--channels", "2"]
    lj = _run(jcli, common + ["--platform", "cpu", "--out_dir",
                              str(tmp_path / "j")], capsys)
    lt = _run(tcli, common + ["--device", "cpu", "--out_dir",
                              str(tmp_path / "t")], capsys)
    assert lt[:2] == lj[:2]
    assert lt[2].split(";")[1] == lj[2].split(";")[1]
    assert lt[3:] == lj[3:]


@pytest.mark.parametrize("name,correlator", [
    ("pallas", "chunked"), ("mxu", "chunked"), ("auto", "chunked"),
    ("chunked", "chunked")])
def test_chunked_correlator_names_map(tmp_path, name, correlator):
    conf = _conf_with(tmp_path, "gps_l1_ishort.conf",
                      Tracking_1C__correlator=name)
    rt = trc(TConf(str(conf)))
    assert rt.correlator == name
    assert Receiver(rt, device="cpu").trk.correlator == correlator


def test_fft_correlator_refused(tmp_path):
    conf = _conf_with(tmp_path, "gps_l1_ishort.conf",
                      Tracking_1C__correlator="fft")
    assert jrc(JConf(str(conf))).correlator == "fft"
    with pytest.raises(ValueError, match="Does not carry over"):
        trc(TConf(str(conf)))


def test_tcp_connector_conf_raises_like_jax(tmp_path):
    """A TCP_CONNECTOR tracking conf raises the JAX package's ValueError
    (the tracker runs standalone, not inside the batched Receiver), naming
    the port's module."""
    conf = _conf_with(
        tmp_path, "gps_l1_ishort.conf",
        Tracking_1C__implementation="GPS_L1_CA_TCP_CONNECTOR_Tracking")
    with pytest.raises(ValueError, match="closes its loop over TCP") as ej:
        jrc(JConf(str(conf)))
    with pytest.raises(ValueError, match="closes its loop over TCP") as et:
        trc(TConf(str(conf)))
    assert "gnss_sdr_1_tpu.track.tcp_connector" in str(ej.value)
    assert "gnss_sdr_1_tpu_torch.track.tcp_connector" in str(et.value)
