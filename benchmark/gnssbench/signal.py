"""The benchmark's inputs: spreading codes, the satellites drawn from the
seed, and the capture made from them on the card.

The generator is a frozen copy of `chip_smoke.py`'s `generate_on_card`
(the port's siggen signal model evaluated on the device in blocks, with
unit-variance complex noise from a seeded torch.Generator); the satellite
draw follows `chip_smoke.py`'s `_bench_sats` / `_e1_sats` with the ranges
of the traffic mix.  The codes are built here from their ICD definitions,
so the benchmark hands the same tables to the program and to its
reference and takes none from the program.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib

import numpy as np
import torch

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"

# IS-GPS-200 Table 3-I: G2 phase-select taps, index = PRN - 1
_G2_TAPS = ((2, 6), (3, 7), (4, 8), (5, 9), (1, 9), (2, 10), (1, 8),
            (2, 9), (3, 10), (2, 3), (3, 4), (5, 6), (6, 7), (7, 8), (8, 9),
            (9, 10), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9), (1, 3),
            (4, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 6), (2, 7), (3, 8),
            (4, 9))


def _lfsr(taps: tuple, n: int = 1023) -> np.ndarray:
    reg = np.ones(10, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        out[i] = reg[9]
        fb = 0
        for t in taps:
            fb ^= reg[t - 1]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=1)
def _g1_g2():
    return _lfsr((3, 10)), _lfsr((2, 3, 6, 8, 9, 10))


def gps_l1ca_code(prn: int) -> np.ndarray:
    """1023-chip C/A code, +-1 float32 (binary 1 -> -1)."""
    g1, g2 = _g1_g2()
    t1, t2 = _G2_TAPS[prn - 1]
    chips = g1 ^ np.roll(g2, t1 - 10) ^ np.roll(g2, t2 - 10)
    return np.where(chips == 1, -1.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _e1b_hex() -> list:
    lines = (DATA / "galileo_e1b_primary_hex.txt").read_text().splitlines()
    return [ln.strip() for ln in lines if ln.strip() and ln[0] != "#"]


def galileo_e1b_sinboc(prn: int) -> np.ndarray:
    """The E1B tracking replica: the 4092-chip primary code under the
    sinBOC(1,1) subcarrier, 2 samples a chip (8184 values, +-1)."""
    h = _e1b_hex()[prn - 1]
    bits = bin(int(h, 16))[2:].zfill(len(h) * 4)[:4092]
    chips = 1.0 - 2.0 * (np.frombuffer(bits.encode(), np.uint8) - ord("0"))
    return (chips[:, None] * np.array([1.0, -1.0])[None, :]).reshape(
        -1).astype(np.float32)


CODES = {"gps_l1ca": gps_l1ca_code, "galileo_e1b_sinboc": galileo_e1b_sinboc}


@dataclasses.dataclass
class Sat:
    """One satellite of the scenario (the port's SatParams fields that the
    generator reads)."""

    prn: int
    doppler_hz: float
    doppler_rate_hz_s: float
    delay_chips: float
    cn0_dbhz: float
    nav_bits: np.ndarray
    phase_rad: float


def draw_sats(signal: dict, mix: dict, prns, seed: int,
              duration_s: float) -> list:
    """The satellites of one seed: Doppler, Doppler rate, C/N0 and carrier
    phase uniform in the mix's ranges, the code delay uniform over one
    symbol (so each channel's symbol boundary falls at its own epoch), and
    random symbols.  Every seed draws the same number of each."""
    rng = np.random.default_rng(seed)
    code_chips = signal["code_chips"]
    sym_epochs = signal["symbol_epochs"]
    n_sym = int(duration_s / (signal["code_period_s"] * sym_epochs)) + 8
    d, r = mix["doppler_max_hz"], mix["doppler_rate_max_hz_s"]
    lo, hi = mix["cn0_dbhz"]
    return [Sat(prn=int(p), doppler_hz=float(rng.uniform(-d, d)),
                doppler_rate_hz_s=float(rng.uniform(-r, r)),
                delay_chips=float(rng.uniform(0, code_chips * sym_epochs)),
                cn0_dbhz=float(rng.uniform(lo, hi)),
                nav_bits=rng.choice([-1.0, 1.0], size=n_sym),
                phase_rad=float(rng.uniform(0, 2 * np.pi)))
            for p in prns]


def generate_on_card(signal: dict, sats, codes_by_prn, fs_hz: float,
                     duration_s: float, dev, seed: int,
                     block_s: float = 1.0) -> torch.Tensor:
    """The capture (complex64 on `dev`): each satellite's code, symbols
    and carrier with its Doppler and Doppler rate, at an amplitude that
    gives its C/N0 against unit-variance complex noise."""
    n = int(round(fs_hz * duration_s))
    out = torch.empty(n, dtype=torch.complex64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    two_pi = 2.0 * np.pi
    fc = signal["carrier_freq_hz"]
    rate = signal["code_rate_chips_s"]
    chips_per_sym = signal["code_chips"] * signal["symbol_epochs"]
    sat_data = []
    for sat in sats:
        code = torch.as_tensor(np.asarray(codes_by_prn[sat.prn], np.float64),
                               device=dev)
        bits = torch.as_tensor(np.asarray(sat.nav_bits, np.float64),
                               device=dev)
        amp = np.sqrt(10.0 ** (sat.cn0_dbhz / 10.0) / fs_hz)
        sat_data.append((sat, code, bits, amp))
    step = max(1, int(fs_hz * block_s))
    for a in range(0, n, step):
        m = min(step, n - a)
        t = torch.arange(a, a + m, dtype=torch.float64, device=dev) / fs_hz
        re = torch.zeros(m, dtype=torch.float64, device=dev)
        im = torch.zeros(m, dtype=torch.float64, device=dev)
        for sat, code, bits, amp in sat_data:
            dil = (sat.doppler_hz * t
                   + 0.5 * sat.doppler_rate_hz_s * t * t) / fc
            chips = rate * (t + dil) - sat.delay_chips
            c = code[torch.remainder(torch.floor(chips).long(),
                                     code.shape[0])]
            bit_idx = torch.floor(chips / chips_per_sym).long()
            d = bits[bit_idx.clamp(0, bits.shape[0] - 1)]
            c = c * torch.where(bit_idx < 0, torch.ones_like(d), d)
            env = (amp * c).float()
            phase = (two_pi * (sat.doppler_hz * t
                               + 0.5 * sat.doppler_rate_hz_s * t * t)
                     + sat.phase_rad)
            ph32 = torch.remainder(phase, two_pi).float()
            re += env * torch.cos(ph32)
            im += env * torch.sin(ph32)
        w = torch.randn((m, 2), generator=gen, dtype=torch.float64,
                        device=dev) * np.sqrt(0.5)
        re += w[:, 0]
        im += w[:, 1]
        out[a:a + m] = torch.complex(re.float(), im.float())
    return out


def carrier_phase(sat: Sat, sample: int, fs_hz: float) -> float:
    """The satellite's carrier phase at `sample`, in [0, 2 pi)."""
    t = sample / fs_hz
    ph = (2.0 * np.pi * (sat.doppler_hz * t
                         + 0.5 * sat.doppler_rate_hz_s * t * t)
          + sat.phase_rad)
    return float(np.mod(ph, 2.0 * np.pi))


def to_ishort(x: torch.Tensor, scale: float) -> np.ndarray:
    """Interleaved int16 I/Q items of a capture (round, clip), on the
    host, as a file or socket source hands them over."""
    iq = torch.view_as_real(x).reshape(-1) * scale
    iq = torch.clamp(torch.round(iq), -32767, 32767).to(torch.int16)
    return iq.cpu().numpy()
