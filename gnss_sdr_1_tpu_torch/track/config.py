"""Tracking configuration.

Reference parity: Dll_Pll_Conf (src/algorithms/tracking/libs/
dll_pll_conf.h:40-80) — field names mirror the reference's config properties
so reference .conf files translate mechanically.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    fs_hz: float
    code_length_chips: int
    chip_rate_chips_s: float
    carrier_freq_hz: float
    n_channels: int = 12
    code_samples_per_chip: int = 1     # local replica sampling (2 for sinBOC)

    # loop bandwidths / orders (wide = pull-in, narrow = steady state)
    pll_bw_hz: float = 35.0
    dll_bw_hz: float = 2.0
    # narrow (states 3/4) loop bandwidths: at 20 ms updates the bilinear
    # order-3 cascade is marginally damped below ~8 Hz (33 deg phase
    # oscillations persisting for seconds); 12 Hz converges in < 1 s with
    # sigma_phi ~ 6 deg at 30 dB-Hz
    pll_bw_narrow_hz: float = 12.0
    dll_bw_narrow_hz: float = 0.75
    pll_filter_order: int = 3
    dll_filter_order: int = 2
    enable_fll_pull_in: bool = False
    fll_bw_hz: float = 35.0
    # narrow-mode FLL pull-in transitory on half-window accumulations:
    # bridges the wide->narrow Doppler hand-off error past the narrow PLL
    # pull-in range (half-windows sit inside one bit, so the discriminator
    # is flip-free).  Runs FLL-assisted for fll_narrow_windows loop updates
    # after enable_extended, then the carrier filter is re-seeded from the
    # converged Doppler and the pure narrow PLL takes over.
    fll_bw_narrow_hz: float = 8.0
    fll_narrow_windows: int = 20
    pull_in_time_s: float = 2.0        # FLL transitory duration

    # correlator geometry
    early_late_space_chips: float = 0.5
    very_early_late_space_chips: float = 0.8
    veml: bool = False                 # 5-tap VE/E/P/L/VL (Galileo E1)

    # lock / CN0 supervision (defaults from gnss_sdr_flags.cc:53-59)
    cn0_samples: int = 20
    cn0_min_dbhz: float = 25.0
    max_lock_fail: int = 50
    carrier_lock_th: float = 0.85

    # states 3/4: coherent extension window in epochs once the host reports
    # bit/secondary sync (Dll_Pll_Conf.extend_correlation_symbols,
    # dll_pll_veml_tracking.cc:1774-1900)
    extend_correlation_symbols: int = 20
    # secondary-wiped channel still carries nav data (BeiDou B1I NH20,
    # Galileo E5a-I CS20): keep the two-quadrant Costas discriminator even
    # with sec_on — only a true pilot (dataless) channel may use the
    # four-quadrant PLL (dll_pll_veml_tracking.cc:1004-1012 d_trk_parameters
    # track_pilot branch)
    sec_data: bool = False
    # epochs correlated per chunk: one batched correlation, then one launch
    # of the tracking-chain kernel runs the exact per-epoch loop closures
    chunk_epochs: int = 16

    # correlator:
    #   'chunked' — `chunk_epochs` epochs correlated at once on the regular
    #               grid, taps read by linear interpolation between integer
    #               lags (the accelerator path)
    #   'gather'  — per-epoch, per-sample floor code resampler (the
    #               reference's exact A.2 contract): one gather_block launch
    #               walks every epoch of a capture segment
    correlator: str = "chunked"

    @property
    def samples_per_code(self) -> float:
        return self.fs_hz * self.code_length_chips / self.chip_rate_chips_s

    @property
    def epoch_samples_max(self) -> int:
        """Static upper bound on one integration block
        (d_current_prn_length_samples varies +-; +-10 kHz Doppler shifts the
        code rate by ~1e-5 relative)."""
        return int(math.floor(self.samples_per_code * (1.0 + 1e-4))) + 2

    @property
    def code_period_s(self) -> float:
        return self.code_length_chips / self.chip_rate_chips_s

    @property
    def n_taps(self) -> int:
        return 5 if self.veml else 3

    def tap_shifts_chips(self) -> list[float]:
        el = self.early_late_space_chips
        if self.veml:
            vl = self.very_early_late_space_chips
            return [-vl, -el, 0.0, el, vl]
        return [-el, 0.0, el]

    @property
    def prompt_index(self) -> int:
        return 2 if self.veml else 1
