"""TCP-connector tracking: loop closure in an external process.

Reference parity: gps_l1_ca_tcp_connector_tracking_cc.cc /
galileo_e1_tcp_connector_tracking_cc.cc + tcp_communication/
tcp_packet_data (SURVEY §2.7) — the correlator runs in the receiver while
the DLL/PLL loop filters run in an external process (MATLAB/Simulink in
the reference, src/utils/simulink/) connected over TCP.

The correlator is the A.1/A.2 multicorrelator evaluated per epoch: on the
card one `multicorrelate_cuda` launch per epoch (ops.multicorrelator,
csrc/multicorrelate.cuh), on the CPU its plain version when the tracker is
built with `device="cpu"`.  The wire protocol is newline-delimited JSON,
as the JAX package's (gnss_sdr_1_tpu/track/tcp_connector.py): per epoch the
tracker sends

    {"prn", "epoch", "t_int_s", "corr": [[I_E,Q_E],[I_P,Q_P],[I_L,Q_L]]}

and the controller replies

    {"carrier_doppler_hz", "code_freq_delta_chips_s"}

i.e. the ABSOLUTE loop outputs (the reference's tcp_packet_data carries
the same discriminator/filter quantities).  `LoopClosureServer` is the
in-repo reference controller (Costas + E-L with 2nd-order bilinear
filters, A.3/A.5, from track.loop_filter) used by the tests and as the
template for external controllers.  One epoch per round-trip: this is the
post-processing / algorithm-prototyping path, not the batched engine.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops.multicorrelator import correlate
from .loop_filter import (fll_pll_apply, fll_pll_coefficients, fll_pll_init,
                          iir_apply, iir_coefficients, iir_init)


# what each of track()'s per-epoch stamps marks
EPOCH_STAMPS = ("start", "params", "correlate", "readback", "sent", "reply",
                "stepped")


@dataclasses.dataclass
class TcpTrackConfig:
    fs_hz: float
    code_length_chips: int
    chip_rate_chips_s: float
    carrier_freq_hz: float
    early_late_space_chips: float = 0.5


class TcpConnectorTracking:
    """Single-channel epoch-loop tracker with TCP loop closure.  `device`:
    None correlates on the card (and raises without one); the CPU only when
    asked for (`device="cpu"`)."""

    def __init__(self, cfg: TcpTrackConfig, code: np.ndarray,
                 host: str, port: int, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        code = np.asarray(code, dtype=np.float32)
        if self.device.type == "cuda" and not np.all(np.abs(code) == 1.0):
            raise ValueError("the multicorrelator kernel takes a +-1 code")
        self.code = torch.as_tensor(code, device=self.device)
        self.sock = socket.create_connection((host, port), timeout=10.0)
        self._rf = self.sock.makefile("rw")
        # NCO state (A.6 recursion)
        self.rem_code_phase_samples = 0.0
        self.carrier_doppler_hz = 0.0
        self.code_freq_delta = 0.0
        self.rem_carr_phase_rad = 0.0
        self.start = 0
        self.epoch = 0

    def seed(self, delay_samples: float, doppler_hz: float) -> None:
        self.start = int(delay_samples)
        self.rem_code_phase_samples = float(delay_samples) - self.start
        self.carrier_doppler_hz = float(doppler_hz)

    def track(self, samples, n_epochs: int, stamps: list | None = None):
        """Track `n_epochs` code periods of `samples` (complex, numpy or a
        tensor; copied to the tracker's device once); returns per-epoch
        dict rows.  `stamps`, where given, gets one tuple of
        time.perf_counter() readings an epoch (EPOCH_STAMPS: its start, the
        NCO's epoch parameters ready, the correlator call returned, the
        taps read back, the JSON line written and flushed, the reply
        parsed, the NCO stepped)."""
        cfg = self.cfg
        fs = cfg.fs_hz
        d = cfg.early_late_space_chips
        shifts = (-d, 0.0, d)
        x = torch.as_tensor(samples, dtype=torch.complex64,
                            device=self.device)
        f32 = np.float32
        clock = time.perf_counter
        out = []
        for _ in range(n_epochs):
            t0 = clock()
            code_freq = cfg.chip_rate_chips_s * (
                1.0 + self.carrier_doppler_hz / cfg.carrier_freq_hz) \
                + self.code_freq_delta
            t_prn = fs * cfg.code_length_chips / code_freq
            k_blk = t_prn + self.rem_code_phase_samples
            n_len = int(np.floor(k_blk))
            if self.start + n_len > len(x):
                break
            step = code_freq / fs
            rem_chips = -self.rem_code_phase_samples * step
            carr_step = 2.0 * np.pi * self.carrier_doppler_hz / fs
            t_par = clock()
            taps = correlate(x[self.start:self.start + n_len], self.code,
                             shifts, float(f32(step)), float(f32(rem_chips)),
                             float(f32(self.rem_carr_phase_rad)),
                             float(f32(carr_step)))
            t_corr = clock()
            z = taps.cpu().numpy()
            t_read = clock()
            t_int = n_len / fs
            # ---- loop closure over TCP (the external process) ----
            self._rf.write(json.dumps({
                "prn": 0, "epoch": self.epoch, "t_int_s": t_int,
                "corr": [[float(c.real), float(c.imag)] for c in z],
            }) + "\n")
            self._rf.flush()
            t_sent = clock()
            reply = json.loads(self._rf.readline())
            self.carrier_doppler_hz = float(reply["carrier_doppler_hz"])
            self.code_freq_delta = float(
                reply["code_freq_delta_chips_s"])
            t_reply = clock()
            # ---- NCO stepping (A.6) ----
            self.rem_code_phase_samples = k_blk - n_len
            self.rem_carr_phase_rad = float(np.mod(
                self.rem_carr_phase_rad + carr_step * n_len,
                2.0 * np.pi))
            self.start += n_len
            self.epoch += 1
            out.append({"epoch": self.epoch, "start": self.start,
                        "prompt": complex(z[1]),
                        "doppler_hz": self.carrier_doppler_hz})
            if stamps is not None:
                stamps.append((t0, t_par, t_corr, t_read, t_sent, t_reply,
                               clock()))
        return out

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class LoopClosureServer:
    """Reference external controller: Costas PLL + normalized E-L DLL with
    2nd-order bilinear loop filters (A.3/A.5) behind the JSON protocol.
    Runs in a thread; real deployments replace this process with their own
    controller (the reference's MATLAB/Simulink role)."""

    def __init__(self, pll_bw_hz: float = 20.0, dll_bw_hz: float = 2.0,
                 seed_doppler_hz: float = 0.0, t_int_s: float = 1e-3):
        self.pll_bw = pll_bw_hz
        self.dll_bw = dll_bw_hz
        self.seed = seed_doppler_hz
        self._t = t_int_s
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        conn, _ = self._srv.accept()
        rf = conn.makefile("rw")
        # carrier: the reference's FLL-assisted PLL filter seeded with the
        # acquisition Doppler (A.5); pure-PLL here (fll_disc = 0)
        f32 = torch.float32
        cc = fll_pll_coefficients(0.0, self.pll_bw, 2)
        st_c = fll_pll_init(cc, self.seed)
        bi_d, bo_d = (torch.as_tensor(v) for v in iir_coefficients(
            self.dll_bw, self._t, 1, True))
        st_d = iir_init()
        while True:
            line = rf.readline()
            if not line:
                break
            msg = json.loads(line)
            (ie, qe), (ip_, qp), (il, ql) = msg["corr"]
            t_int = float(msg.get("t_int_s", self._t))
            # A.3 discriminators
            pll_err = float(0.0 if ip_ == 0.0
                            else np.arctan(qp / ip_)) / (2.0 * np.pi)
            e = np.hypot(ie, qe)
            lv = np.hypot(il, ql)
            dll_err = 0.5 * (e - lv) / (e + lv) if (e + lv) > 0 else 0.0
            st_c, carr = fll_pll_apply(st_c, cc, torch.tensor(0.0, dtype=f32),
                                       torch.tensor(pll_err, dtype=f32),
                                       torch.tensor(t_int, dtype=f32))
            st_d, out_d = iir_apply(st_d, torch.tensor(dll_err, dtype=f32),
                                    bi_d, bo_d)
            rf.write(json.dumps({
                "carrier_doppler_hz": float(carr),
                "code_freq_delta_chips_s": -float(out_d)}) + "\n")
            rf.flush()
        conn.close()

    def close(self) -> None:
        try:
            self._srv.close()
        except OSError:
            pass
