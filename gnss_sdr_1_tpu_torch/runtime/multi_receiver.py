"""Multi-constellation / multi-signal receiver.

Reference parity: the hybrid receiver configurations
(conf/gnss-sdr_GLONASS_L1_CA_GPS_L1_CA_ibyte.conf and friends, BASELINE
configs #4-5): several per-signal channel groups, either over one wideband
sample stream or over per-band streams from separate RF chains
(Receiver_Chain multi-source, gnss-sdr_multisource_*.conf — config #5 is
GPS L1 + L2C + L5 from three front-ends at different sampling rates).

Design: one `Receiver` per signal group (each owns its batched acquisition
and its tracking engine, whose capture calls run on the card), run over
its capture; joint fixes are formed afterwards on the common receiver
clock — all streams share the sample-0 instant (one oscillator drives every
front-end, as in the reference's multi-source captures), so group epochs
interpolate to shared RX times and solve with per-system clock columns (the
ISB handling of rtklib_pntpos).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import SPEED_OF_LIGHT_M_S
from ..observables import CarrierSmoother, compute_observables
from ..pvt.solver import PvtSolution, solve_pvt
from .receiver import Receiver, ReceiverConfig

_SYSTEM_OF_SIGNAL = {"1C": "G", "2S": "G", "L5": "G",
                     "1B": "E", "5X": "E",
                     "1G": "R", "2G": "R",
                     "B1": "C", "B3": "C"}

# PRN-id offsets so satellites never collide across systems in the joint
# solve; multi-band groups of the SAME system share the offset so the same
# satellite seen on two bands contributes two measurements (band key bumps)
_SYS_OFFSET = {"G": 0, "E": 100, "R": 200, "C": 300}


@dataclasses.dataclass
class JointSolution:
    solution: PvtSolution
    per_system_prns: dict[str, list[int]]


class MultiReceiver:
    """Run several signal groups and solve jointly.

    `process(samples)` accepts one shared array (wideband single front-end)
    or a list with one stream per group (multi-source); per-group sampling
    rates may differ in the multi-source case.  `device`: None runs every
    group on the card (and raises without one); the CPU only when asked
    for.
    """

    def __init__(self, configs: list[ReceiverConfig], device=None):
        if not configs:
            raise ValueError("need at least one ReceiverConfig")
        self.receivers = [Receiver(c, device=device) for c in configs]
        self.fs_hz = configs[0].fs_hz

    def process(self, samples, obs_interval_ms: int = 20,
                ) -> list[JointSolution]:
        """Process the capture(s) with every group, then form joint fixes."""
        if isinstance(samples, (list, tuple)):
            if len(samples) != len(self.receivers):
                raise ValueError("need one sample stream per group")
            streams = list(samples)
        else:
            if len({r.cfg.fs_hz for r in self.receivers}) != 1:
                raise ValueError(
                    "shared-stream mode needs one common fs; pass per-group "
                    "streams for multi-source configs")
            streams = [samples] * len(self.receivers)
        for rx, s in zip(self.receivers, streams):
            if rx.device.type == "cuda":
                # one upload per group instead of one per capture segment
                rx.preload(s)
            rx.process(s)
            rx._samples_dev = None
        return self.joint_fixes(obs_interval_ms)

    def joint_fixes(self, obs_interval_ms: int = 20) -> list[JointSolution]:
        dt = obs_interval_ms * 1e-3
        # per group: histories of channels with complete ephemeris
        ready = []
        for rx in self.receivers:
            hists = {
                p: h for p, h in rx.histories.items()
                if p in rx.decoders and rx.decoders[p].ephemeris_complete
                and len(h.start_samples) >= 2
            }
            ready.append(hists)
        if sum(len(h) for h in ready) < 4:
            return []
        # common covered span on the receiver clock (seconds since sample 0)
        spans = [
            (min(h.start_samples[0] for h in hists.values()) / rx.cfg.fs_hz,
             max(h.start_samples[-1] for h in hists.values()) / rx.cfg.fs_hz)
            for rx, hists in zip(self.receivers, ready) if hists
        ]
        start_s = max(s for s, _ in spans)
        stop_s = min(e for _, e in spans)
        out: list[JointSolution] = []
        rx_tow = None
        rx_t_anchor = None
        # per-group Hatch smoothers at each band's wavelength (the joint
        # analogue of Receiver._smoother; keys are the offset PRN ids so
        # L1/L2C of one SV smooth independently)
        smoothers = [
            CarrierSmoother(
                window=rx.cfg.carrier_smoothing_epochs,
                wavelength_m=SPEED_OF_LIGHT_M_S / rx.cfg.spec.carrier_freq_hz)
            if rx.cfg.carrier_smoothing_epochs > 0 else None
            for rx in self.receivers
        ]
        t = (np.floor(start_s / dt) + 1.0) * dt
        while t < stop_s:
            ephs, prs, dops, freqs, systems = {}, {}, {}, {}, {}
            per_sys: dict[str, list[int]] = {}
            for gi, (rx_i, hists) in enumerate(
                    zip(self.receivers, ready)):
                if not hists:
                    continue
                fs_i = rx_i.cfg.fs_hz
                rx_sample = int(round(t * fs_i))
                sysid = _SYSTEM_OF_SIGNAL.get(rx_i.cfg.signal_id, "G")
                if rx_tow is None:
                    tow_k, obs = compute_observables(
                        hists, rx_sample, fs_i, None)
                    if obs:
                        rx_tow, rx_t_anchor = tow_k, t
                if rx_tow is None:
                    continue
                tow_k = rx_tow + (t - rx_t_anchor)
                _, obs = compute_observables(hists, rx_sample, fs_i, tow_k)
                for p, o in obs.items():
                    # offset PRN ids per system (+1000*group for same-system
                    # multi-band so L1/L2/L5 of one SV all contribute)
                    key = p + _SYS_OFFSET[sysid] + 1000 * gi
                    ephs[key] = rx_i.decoders[p].ephemeris
                    prs[key] = (
                        smoothers[gi].smooth(key, o.pseudorange_m,
                                             o.carrier_phase_cycles)
                        if smoothers[gi] is not None else o.pseudorange_m)
                    dops[key] = o.doppler_hz
                    # clock/ISB column PER GROUP: each group's observables
                    # carry an independent RX-clock anchor (its own obs
                    # start offset), so even same-system bands (L1+L2C)
                    # need separate bias unknowns — the reference's
                    # per-signal code-bias handling in rtklib prange()
                    systems[key] = f"{sysid}{gi}"
                    per_sys.setdefault(sysid, []).append(p)
            # >= 4 DISTINCT satellites: two bands of one SV share a line of
            # sight, so they add precision but not geometric rank
            n_distinct = len({(systems[k][:1], k % 1000) for k in prs})
            if len(prs) >= 4 and n_distinct >= 4 and rx_tow is not None:
                tow_k = rx_tow + (t - rx_t_anchor)
                sol = solve_pvt(ephs, prs, tow_k, dopplers_hz=dops,
                                systems=systems,
                                raim=self.receivers[0].cfg.raim,
                                raim_sigma_m=self.receivers[0].cfg.raim_sigma_m)
                if sol.valid:
                    out.append(JointSolution(sol, per_sys))
            t += dt
        return out
