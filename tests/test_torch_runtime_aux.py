"""Twins of tests/test_runtime_aux.py's telecommand, monitor and dump cases
for the port's host copies (runtime/{telecommand,monitor,dumps}.py), and
the port's Receiver as a monitor tap and a telecommand target on the CPU.
The receiver's Gnss_Synchro records are held field by field to the JAX
package's (correlator='mxu') on the same capture: identities, sample
counters and acquisition exact, Doppler at 2e-2 Hz, the fields the JAX
package ships as f16 (prompt, CN0) at f16 resolution."""

import json
import socket

import numpy as np
import pytest

from gnss_sdr_1_tpu.codes import gps_l1ca_code
from gnss_sdr_1_tpu.constants import GPS_L1_CA
from gnss_sdr_1_tpu.runtime.receiver import Receiver as JReceiver
from gnss_sdr_1_tpu.runtime.receiver import ReceiverConfig as JReceiverConfig
from gnss_sdr_1_tpu.siggen.generator import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.pvt.solver import PvtSolution
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.runtime.monitor import GnssSynchro, UdpSink
from gnss_sdr_1_tpu_torch.runtime.telecommand import TelecommandServer
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F16_RTOL = 2.0 ** -10


def test_telecommand_dispatch():
    class Dummy:
        def __init__(self):
            self.calls = []

        def status(self):
            return "tracking 5 channels"

        def standby(self):
            self.calls.append("standby")

        def hot_start(self, lat, lon, h, when):
            self.calls.append(("hot", lat, lon, h))

    d = Dummy()
    srv = TelecommandServer(d)
    assert srv.serve_once("status") == "tracking 5 channels"
    assert srv.serve_once("standby") == "OK"
    assert srv.serve_once("hotstart 17/08/2026 12:00:00 41.27 1.98 80") == "OK"
    assert srv.serve_once("bogus").startswith("ERROR")
    assert srv.serve_once("warmstart 17/08/2026") .startswith("ERROR")
    assert d.calls == ["standby", ("hot", 41.27, 1.98, 80.0)]


def test_telecommand_over_tcp():
    class Dummy:
        def status(self):
            return "OK-STATUS"

    srv = TelecommandServer(Dummy(), port=0)
    port = srv.start()
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        f = s.makefile("rw")
        f.write("status\n")
        f.flush()
        assert f.readline().strip() == "OK-STATUS"
    srv.stop()


def test_monitor_udp_sink():
    rx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx_sock.bind(("127.0.0.1", 0))
    rx_sock.settimeout(5.0)
    port = rx_sock.getsockname()[1]
    sink = UdpSink(port=port, decimation=1)
    rec = GnssSynchro(prn=9, cn0_db_hz=43.5, carrier_doppler_hz=-1234.0)
    sink.send_synchro([rec])
    data = rx_sock.recv(65536).decode()
    assert '"prn": 9' in data and '"cn0_db_hz": 43.5' in data
    sol = PvtSolution(True, np.array([1.0, 2.0, 3.0]), 1e-4,
                      np.zeros(3), 0.0, 345600.0, lat_deg=41.0, lon_deg=2.0,
                      height_m=80.0, dops={"pdop": 2.0}, n_sats=6)
    sink.send_pvt(sol)
    data = json.loads(rx_sock.recv(65536).decode())
    assert data["n_sats"] == 6 and data["pdop"] == 2.0
    # decimation: one datagram in every `decimation` calls
    dec = UdpSink(port=port, decimation=3)
    for k in range(6):
        dec.send_synchro([GnssSynchro(prn=k)])
    got = [json.loads(rx_sock.recv(65536).decode())["prn"] for _ in range(2)]
    assert got == [2, 5]
    for s in (sink, dec, rx_sock):
        s.close()


def test_tracking_dump_roundtrip(tmp_path):
    from gnss_sdr_1_tpu_torch.runtime.dumps import (TrackingDump,
                                                    dump_acquisition_grid,
                                                    read_tracking_dump)

    class O:  # minimal TrackOutputs stand-in (planar correlators)
        pass

    t, c, k = 5, 2, 3
    o = O()
    o.valid = np.ones((t, c), bool)
    o.start = np.arange(t * c).reshape(t, c).astype(np.int32)
    o.cur_len = np.full((t, c), 4000, np.int32)
    o.correlators = np.random.default_rng(0).standard_normal(
        (t, c, k, 2)).astype(np.float32)
    o.carrier_doppler_hz = np.zeros((t, c), np.float32)
    o.code_freq_delta = np.zeros((t, c), np.float32)
    o.rem_code_phase_samples = np.zeros((t, c), np.float32)
    o.cn0_dbhz = np.full((t, c), 43.0, np.float32)
    d = TrackingDump()
    d.push_outputs([7, None], o, block_offset=1000)
    files = d.write(str(tmp_path))
    assert any("prn07" in f for f in files)
    back = read_tracking_dump([f for f in files if f.endswith(".npz")][0])
    assert len(back["prompt_i"]) == t
    assert back["start_sample"][0] == 1000
    assert np.allclose(back["prompt_i"], o.correlators[:, 0, 1, 0])
    assert np.allclose(back["late_q"], o.correlators[:, 0, -1, 1])
    grid = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    p = dump_acquisition_grid(str(tmp_path / "acq" / "grid.npz"), grid,
                              [3, 8], [-250.0, 0.0, 250.0], 2.046e6)
    with np.load(p) as z:
        np.testing.assert_array_equal(z["grid"], grid)
        assert list(z["prns"]) == [3, 8] and float(z["fs_hz"]) == 2.046e6


# ---------------- the receiver as a monitor tap and telecommand target ----

FS = 2.046e6


@pytest.fixture(scope="module")
def short_capture(one_torch_thread):  # noqa: F811
    """tests/test_runtime_aux.py's capture: one strong GPS L1 satellite
    whose nav bits never frame-sync (all-ones stream): tracking locks,
    telemetry TOW stays None.  Its first two whole 1 s segments (and one
    epoch's tail), so that both receivers run one segment length."""
    x = generate_baseband(
        GPS_L1_CA,
        [SatParams(prn=7, doppler_hz=1200.0, delay_chips=300.25,
                   cn0_dbhz=48.0)],
        {7: gps_l1ca_code(7)}, FS, 2.5, noise=True, seed=3)
    return x[:int(2 * FS) + 2 * int(FS * 1e-3)]


def _drain(sock):
    sock.setblocking(False)
    recs = []
    while True:
        try:
            data = sock.recv(1 << 20)
        except BlockingIOError:
            break
        recs += [json.loads(ln) for ln in data.decode().splitlines()]
    sock.close()
    return recs


def _monitor_run(make_rx, cfg_cls, x):
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    cfg = cfg_cls(fs_hz=FS, signal_id="1C", n_channels=1, prn_search=(7,),
                  enable_monitor=True, monitor_port=sock.getsockname()[1],
                  monitor_decimation=100, watchdog_symbols=1200)
    rx = make_rx(cfg)
    rx.process(x)
    return rx, _drain(sock)


@pytest.fixture(scope="module")
def monitored(short_capture):
    rj, recs_j = _monitor_run(lambda c: JReceiver(c), lambda **kw:
                              JReceiverConfig(correlator="mxu", **kw),
                              short_capture)
    rt, recs_t = _monitor_run(lambda c: Receiver(c, device="cpu"),
                              ReceiverConfig, short_capture)
    return rj, recs_j, rt, recs_t


def test_receiver_monitor_tap_and_watchdog(monitored):
    """enable_monitor streams Gnss_Synchro records over UDP during a run;
    the telemetry watchdog releases a channel that never frame-syncs."""
    rj, recs_j, rt, recs_t = monitored
    assert rt.monitor is not None and rt._symbol_offsets() is None
    assert rt.watchdog_trips >= 1
    assert rt.watchdog_trips == rj.watchdog_trips
    assert 7 in rt.sym_count
    assert recs_t and recs_t[0]["prn"] == 7
    assert recs_t[0]["signal"] == "1C" and recs_t[0]["flag_valid_symbol_output"]
    assert not any(r["flag_valid_word"] for r in recs_t)   # no TOW decoded


def test_monitor_records_match_jax(monitored):
    _, recs_j, _, recs_t = monitored
    assert len(recs_t) == len(recs_j) >= 10
    assert list(recs_t[0]) == list(recs_j[0])          # the same fields
    exact = ("system", "signal", "prn", "channel_id",
             "acq_samplestamp_samples", "acq_doppler_hz",
             "flag_valid_acquisition", "tracking_sample_counter",
             "flag_valid_symbol_output", "tow_at_current_symbol_ms",
             "flag_valid_word", "pseudorange_m", "rx_time",
             "flag_valid_pseudorange")
    for rt_, rj_ in zip(recs_t, recs_j):
        for name in exact:
            assert rt_[name] == rj_[name], name
        assert abs(rt_["acq_delay_samples"] - rj_["acq_delay_samples"]) <= 1
        assert rt_["code_phase_samples"] == pytest.approx(
            rj_["code_phase_samples"], abs=2e-2)
        assert rt_["carrier_doppler_hz"] == pytest.approx(
            rj_["carrier_doppler_hz"], abs=2e-2)
    for name in ("prompt_i", "cn0_db_hz"):
        got = np.array([r[name] for r in recs_t])
        want = np.array([r[name] for r in recs_j])
        np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=2e-2,
                                   err_msg=name)


def _command(port, *lines):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        f = s.makefile("rw")
        out = []
        for ln in lines:
            f.write(ln + "\n")
            f.flush()
            out.append(f.readline().strip())
        return out


def test_receiver_telecommand_target(short_capture):
    """The port's Receiver fulfils the TcpCmdInterface target contract:
    status, standby gating the processing loop, cold_start clearing the
    channel state (tcp_cmd_interface.cc:58-66)."""
    x = short_capture
    rx = Receiver(ReceiverConfig(fs_hz=FS, signal_id="1C", n_channels=1,
                                 prn_search=(7,), watchdog_symbols=0),
                  device="cpu")
    srv = TelecommandServer(rx, port=0)
    port = srv.start()
    assert _command(port, "standby") == ["OK"]
    rx.process(x)                       # standby: the loop exits at once
    assert rx.sym_count.get(7) is None and rx._abs_base == 0
    assert _command(port, "reset", "status")[1].startswith(
        "channels 0/1 tracking, 0 ephemerides, 0 fixes, no fix")
    rx.process(x)
    assert rx.sym_count.get(7, 0) > 1000
    assert "channels 1/1" in _command(port, "status")[0]
    assert _command(port, "coldstart") == ["OK"]
    assert all(p is None for p in rx.channel_prn)
    assert not rx.decoders and not rx.solutions
    assert not bool(rx.state.active.any())
    assert _command(port, "hotstart 17/08/2026 12:00:00 41.27 1.98 80") == \
        ["OK"]
    assert np.linalg.norm(rx.apriori_ecef) == pytest.approx(6.368e6, rel=1e-2)
    srv.stop()
