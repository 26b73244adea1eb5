"""Acquisition ROC and tracking pull-in performance harnesses.

Reference parity: acq_performance_test.cc (Pd/Pfa over CN0 x threshold
sweeps, flags :59-89) and tracking_pull-in_test.cc (acquisition error
injection sweep, tracking_tests_flags.h:63-69).  Batched acquisition makes
these sweeps cheap: every Monte-Carlo trial is just another channel row.
Both run on the port's acquisition and chunked tracking engine; `device`
is passed to them (None: the card, raising without one; "cpu" runs on the
CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..codes import gps_l1ca_code
from ..constants import GPS_L1_CA
from ..siggen import SatParams, generate_baseband
from .pcps import AcqConfig, PcpsAcquisition


@dataclasses.dataclass
class RocPoint:
    cn0_dbhz: float
    pd: float             # detection prob (correct delay within 0.5 chip)
    pfa: float            # false-alarm prob on satellite-absent channels
    mean_stat_present: float
    mean_stat_absent: float


def acquisition_roc(
    cn0_grid=(30.0, 33.0, 36.0, 39.0, 42.0, 45.0),
    n_trials: int = 20,
    fs_hz: float = 4e6,
    threshold: float = 2.0,
    doppler_max: float = 5000.0,
    doppler_step: float = 250.0,
    max_dwells: int = 2,
    seed: int = 0,
    device=None,
) -> list[RocPoint]:
    """Pd/Pfa sweep for GPS L1 PCPS (peak-ratio statistic).

    Each trial generates a one-satellite capture (random delay/Doppler);
    acquisition runs the present PRN plus an absent PRN as the Pfa probe.
    """
    spc = int(round(fs_hz * 1e-3))
    cfg = AcqConfig(fs_hz=fs_hz, samples_per_code=spc,
                    samples_per_chip=int(round(fs_hz / 1.023e6)),
                    doppler_max_hz=doppler_max, doppler_step_hz=doppler_step,
                    max_dwells=max_dwells, use_cfar=False, threshold=threshold)
    eng = PcpsAcquisition(cfg, {1: gps_l1ca_code(1), 13: gps_l1ca_code(13)},
                          fs_code_rate=(1.023e6, 1023), device=device)
    i_p = eng.prns.index(1)
    i_a = eng.prns.index(13)
    rng = np.random.default_rng(seed)
    out = []
    for cn0 in cn0_grid:
        det = fa = 0
        sp = sa = 0.0
        for _ in range(n_trials):
            delay = float(rng.uniform(0, 1023))
            dopp = float(rng.uniform(-doppler_max * 0.8, doppler_max * 0.8))
            x = generate_baseband(
                GPS_L1_CA,
                [SatParams(prn=1, doppler_hz=dopp, delay_chips=delay,
                           cn0_dbhz=cn0)],
                {1: gps_l1ca_code(1)}, fs_hz,
                max_dwells * 1e-3 + 1e-3, noise=True,
                seed=int(rng.integers(1 << 31)))
            r = eng.acquire(x)
            true_delay = delay / 1.023e6 * fs_hz
            err = abs(r.delay_samples[i_p] - true_delay)
            err = min(err, spc - err)
            if r.positive[i_p] and err <= 0.5 * fs_hz / 1.023e6:
                det += 1
            if r.positive[i_a]:
                fa += 1
            sp += r.test_stat[i_p]
            sa += r.test_stat[i_a]
        out.append(RocPoint(cn0, det / n_trials, fa / n_trials,
                            sp / n_trials, sa / n_trials))
    return out


@dataclasses.dataclass
class PullInPoint:
    doppler_err_hz: float
    delay_err_chips: float
    locked: bool
    final_cn0_dbhz: float


def tracking_pull_in_map(
    doppler_errs=(-200.0, -100.0, 0.0, 100.0, 200.0),
    delay_errs=(-1.0, -0.5, 0.0, 0.5, 1.0),
    cn0_dbhz: float = 44.0,
    fs_hz: float = 4e6,
    duration_s: float = 1.5,
    enable_fll: bool = True,
    seed: int = 1,
    device=None,
) -> list[PullInPoint]:
    """Pull-in success map over injected acquisition errors
    (tracking_pull-in_test.cc analogue): one capture call of the chunked
    engine per injected error."""
    from ..track import TrackConfig, TrackingEngine

    rng = np.random.default_rng(seed)
    bits = rng.choice([-1.0, 1.0], size=int(duration_s * 50) + 4)
    td, tdc = -1500.0, 400.25
    x = generate_baseband(
        GPS_L1_CA,
        [SatParams(prn=1, doppler_hz=td, delay_chips=tdc, cn0_dbhz=cn0_dbhz,
                   nav_bits=bits)],
        {1: gps_l1ca_code(1)}, fs_hz, duration_s, noise=True, seed=seed)
    results = []
    xd = None
    for derr in doppler_errs:
        for cerr in delay_errs:
            cfg = TrackConfig(
                fs_hz=fs_hz, code_length_chips=1023,
                chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                n_channels=1, enable_fll_pull_in=enable_fll,
                pull_in_time_s=0.25)
            eng = TrackingEngine(cfg, np.stack([gps_l1ca_code(1)]),
                                 device=device)
            if xd is None:
                xd = torch.as_tensor(x, device=eng.device)
            st = eng.activate_channel(
                eng.init_state(), 0, 0,
                (tdc + cerr) / 1.023e6 * fs_hz, td + derr, 0, 0)
            st, _ = eng.track_capture(xd, st, len(x) - cfg.epoch_samples_max)
            # the CN0 of the last completed window (the capture outputs
            # hold the loop-state rows at capture_decim)
            cn0_last = float(st.cn0_last[0])
            dop_ok = abs(float(st.carrier_doppler_hz[0]) - td) < 10.0
            locked = bool(st.active[0]) and dop_ok \
                and cn0_last > cn0_dbhz - 8.0
            results.append(PullInPoint(derr, cerr, locked, cn0_last))
    return results
