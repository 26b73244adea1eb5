"""Deterministic GNSS baseband synthesis.

Signal model per satellite (complex baseband at sampling rate fs):

    x[n] = A * d(t_n - tau) * c((t_n - tau) * Rc') * exp(j*(2*pi*fd*t_n + phi0))

with code rate Rc' = Rc * (1 + fd/fc) (code Doppler coupled to carrier
Doppler, as a real receiver sees), data bits d at the signal's bit rate
aligned to the code epoch, amplitude A set from CN0 against unit-variance
complex noise.  Matches the observability assumptions of the reference's
signal_generator blocks (src/algorithms/signal_generator/gnuradio_blocks/
signal_generator_c.cc).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import SignalSpec


@dataclasses.dataclass
class SatParams:
    prn: int
    doppler_hz: float = 0.0
    doppler_rate_hz_s: float = 0.0  # carrier Doppler drift (dynamics)
    doppler_rate2_hz_s2: float = 0.0  # Doppler 2nd derivative (jerk term —
    #   a cubic delay model keeps a 24 s geometry-consistent scenario's
    #   truth error at the centimeter level instead of meters)
    delay_chips: float = 0.0        # code delay at t=0 [chips]
    cn0_dbhz: float = 45.0
    phase_rad: float = 0.0
    nav_bits: np.ndarray | None = None   # +-1 bit stream at bit_rate; None = all +1
    # constant baseband carrier offset (GLONASS FDMA slot k*DFRQ): rotates
    # the carrier but does NOT dilate the code (it is not motion)
    carrier_offset_hz: float = 0.0
    # navigation symbol rate override (GLONASS meander stream is 100 sps
    # while spec.bit_rate_bps is the 50 bps data rate); None = spec rate
    bit_rate_override_bps: float | None = None


def generate_baseband(
    spec: SignalSpec,
    sats: list[SatParams],
    codes_by_prn: dict[int, np.ndarray],
    fs_hz: float,
    duration_s: float,
    noise: bool = True,
    seed: int = 1234,
) -> np.ndarray:
    """Generate complex64 baseband samples of length round(fs*duration)."""
    n = int(round(fs_hz * duration_s))
    t = np.arange(n, dtype=np.float64) / fs_hz
    out = np.zeros(n, dtype=np.complex128)
    rng = np.random.default_rng(seed)
    for sat in sats:
        code = np.asarray(codes_by_prn[sat.prn], dtype=np.float64)
        code_len = len(code)
        fc = spec.carrier_freq_hz
        # code Doppler coupled to carrier Doppler (+ rate): chips(t) =
        # Rc*(t + (fd*t + 0.5*rate*t^2)/fc) - delay
        dil = (sat.doppler_hz * t + 0.5 * sat.doppler_rate_hz_s * t * t
               + sat.doppler_rate2_hz_s2 * t * t * t / 6.0) / fc
        chips = spec.code_rate_chips_s * (t + dil) - sat.delay_chips
        code_idx = np.floor(chips).astype(np.int64)
        c = code[np.mod(code_idx, code_len)]
        if sat.nav_bits is not None:
            bits = np.asarray(sat.nav_bits, dtype=np.float64)
            chips_per_bit = spec.code_rate_chips_s / (
                sat.bit_rate_override_bps or spec.bit_rate_bps)
            bit_idx = np.floor(chips / chips_per_bit).astype(np.int64)
            d = bits[np.clip(bit_idx, 0, len(bits) - 1)]
            d[bit_idx < 0] = 1.0
        else:
            d = 1.0
        # CN0 against unit-variance complex noise: A^2 * fs / sigma^2 = cn0
        amp = np.sqrt(10.0 ** (sat.cn0_dbhz / 10.0) / fs_hz) if noise else 1.0
        phase = (2.0 * np.pi * ((sat.doppler_hz + sat.carrier_offset_hz) * t
                                + 0.5 * sat.doppler_rate_hz_s * t * t
                                + sat.doppler_rate2_hz_s2 * t * t * t / 6.0)
                 + sat.phase_rad)
        # wrap in float64 (exact at these magnitudes), evaluate the
        # transcendentals in float32 — 3x faster at 98M-sample captures
        # with < 1e-7 rad phase error after wrapping
        ph32 = np.mod(phase, 2.0 * np.pi).astype(np.float32)
        env = (amp * d * c).astype(np.float32)
        out.real += env * np.cos(ph32)
        out.imag += env * np.sin(ph32)
    if noise:
        out += (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * np.sqrt(0.5)
    return out.astype(np.complex64)
