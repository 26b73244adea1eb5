"""Observables: pseudorange / carrier-phase / Doppler formation on a common
receiver clock (host).

Reference parity: src/algorithms/observables/gnuradio_blocks/
hybrid_observables_gs.cc (SURVEY.md §2.9, A.10): per epoch, each channel's
tracking history is interpolated to the common RX sample clock, the receiver
TOW is set from the channels, and
pseudorange = (T_rx_TOW - TOW_i + GPS_STARTOFFSET_MS) * c.

TPU-design difference: tracking epochs stream off-device with exact
(start_sample, TOW) pairs (tracking is code-locked: one epoch == one code
period of transmit time), so interpolation is linear between the two epochs
bracketing the RX tick, as in interp_trk_obs (:349-430).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import GNSS_STARTOFFSET_MS, SPEED_OF_LIGHT_M_S


@dataclasses.dataclass
class ChannelEpochHistory:
    """Per-channel ring of tracked epochs (the Gnss_circular_deque analogue)."""

    max_len: int = 512

    def __post_init__(self) -> None:
        # absolute sample of the code-period boundary (float: integer epoch
        # start + fractional rem_code_phase — sub-sample pseudorange
        # resolution, one sample would be 73 m at 4 Msps)
        self.start_samples: list[float] = []
        self.tow_s: list[float] = []         # transmit TOW at epoch start
        self.doppler_hz: list[float] = []
        self.carrier_phase_rad: list[float] = []  # accumulated (host f64)
        self.cn0_dbhz: list[float] = []

    def push(self, start_sample, tow_s, doppler_hz, carrier_phase_rad=0.0,
             cn0_dbhz=0.0):
        self.start_samples.append(float(start_sample))
        self.tow_s.append(float(tow_s))
        self.doppler_hz.append(float(doppler_hz))
        self.carrier_phase_rad.append(float(carrier_phase_rad))
        self.cn0_dbhz.append(float(cn0_dbhz))
        if len(self.start_samples) > self.max_len:
            del self.start_samples[0]
            del self.tow_s[0]
            del self.doppler_hz[0]
            del self.carrier_phase_rad[0]
            del self.cn0_dbhz[0]

    def interpolate(self, rx_sample: int, fs_hz: float):
        """Linear interpolation of (TOW, doppler, phase) at rx_sample.
        Returns None when rx_sample is outside (or > 20 ms from) the history,
        matching the 0.02 s gate of interp_trk_obs (:366)."""
        s = self.start_samples
        if len(s) < 2 or rx_sample < s[0] or rx_sample > s[-1]:
            return None
        idx = np.searchsorted(s, rx_sample)
        if idx == 0:
            idx = 1
        i0, i1 = idx - 1, idx
        if rx_sample - s[i0] > 0.02 * fs_hz and s[i1] - rx_sample > 0.02 * fs_hz:
            return None
        span = s[i1] - s[i0]
        w = 0.0 if span == 0 else (rx_sample - s[i0]) / span
        tow = self.tow_s[i0] + w * (self.tow_s[i1] - self.tow_s[i0])
        dop = self.doppler_hz[i0] + w * (self.doppler_hz[i1] - self.doppler_hz[i0])
        ph = self.carrier_phase_rad[i0] + w * (
            self.carrier_phase_rad[i1] - self.carrier_phase_rad[i0]
        )
        return tow, dop, ph, self.cn0_dbhz[i1]


class CarrierSmoother:
    """Hatch carrier-smoothed code pseudoranges.

    pr_s[k] = pr[k]/M + (M-1)/M * (pr_s[k-1] - lambda*(phi[k]-phi[k-1]))
    with the receiver phase convention -lambda*phi growing with range (see
    pvt/ppp.py PppObs).  The filter resets on cycle slips / gaps (code-minus
    -carrier prediction jump beyond `slip_gate_m`).  The smoothing window M
    saturates at `window` epochs.

    The reference's observables block gained the same feature as
    Observables.enable_carrier_smoothing (hybrid_observables_gs smoothing
    branch); rtklib pntpos consumes the smoothed codes transparently.
    """

    def __init__(self, window: int = 50, wavelength_m: float = 0.19029367,
                 slip_gate_m: float = 30.0):
        self.window = max(1, int(window))
        self.wavelength_m = wavelength_m
        self.slip_gate_m = slip_gate_m
        self._state: dict = {}   # key -> [count, last_phase_cycles, pr_s]

    def smooth(self, key, pr_m: float, phase_cycles: float) -> float:
        st = self._state.get(key)
        if st is not None:
            cnt, last_ph, last_pr = st
            pred = last_pr - self.wavelength_m * (phase_cycles - last_ph)
            if abs(pr_m - pred) <= self.slip_gate_m:
                m = min(cnt + 1, self.window)
                sm = pr_m / m + (m - 1) / m * pred
                self._state[key] = [cnt + 1, phase_cycles, sm]
                return sm
        self._state[key] = [1, phase_cycles, pr_m]
        return pr_m


@dataclasses.dataclass
class Observation:
    prn: int
    pseudorange_m: float
    tow_s: float
    doppler_hz: float
    carrier_phase_cycles: float
    cn0_dbhz: float = 0.0


def compute_observables(
    histories: dict[int, ChannelEpochHistory],
    rx_sample: int,
    fs_hz: float,
    rx_tow_s: float | None = None,
) -> tuple[float, dict[int, Observation]]:
    """Form observables for all channels at the common RX tick `rx_sample`.

    Returns (T_rx_TOW_s, {prn: Observation}).  If rx_tow_s is None the
    receiver TOW is initialized from the maximum interpolated channel TOW
    plus the start offset, rounded to 1 ms (update_TOW :439); afterwards the
    caller advances it with the sample counter.
    """
    interps: dict[int, tuple] = {}
    for prn, hist in histories.items():
        r = hist.interpolate(rx_sample, fs_hz)
        if r is not None:
            interps[prn] = r
    if not interps:
        return rx_tow_s if rx_tow_s is not None else 0.0, {}

    if rx_tow_s is None:
        t_max = max(v[0] for v in interps.values())
        rx_tow_s = (
            round((t_max + GNSS_STARTOFFSET_MS * 1e-3) * 1000.0) / 1000.0
        )

    obs: dict[int, Observation] = {}
    for prn, (tow, dop, ph, cn0) in interps.items():
        pr = (rx_tow_s - tow) * SPEED_OF_LIGHT_M_S
        obs[prn] = Observation(
            prn=prn,
            pseudorange_m=pr,
            tow_s=tow,
            doppler_hz=dop,
            carrier_phase_cycles=ph / (2.0 * np.pi),
            cn0_dbhz=cn0,
        )
    return rx_tow_s, obs
