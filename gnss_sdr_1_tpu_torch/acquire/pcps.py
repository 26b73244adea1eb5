"""Batched PCPS acquisition on torch.fft.

Reference parity: pcps_acquisition.cc (src/algorithms/acquisition/
gnuradio_blocks/).  The reference iterates a per-Doppler-bin loop of
{carrier wipe-off, FFT, multiply by conj(code FFT), IFFT, |.|^2}
(acquisition_core :712-745); here the whole Doppler grid for every PRN is
one batched complex64 tensor op — (C, D, F).  Numerical contracts:

* CFAR statistic (max_to_input_power_statistic :565-596):
  stat = max|corr|^2 / (F^2 * mean|x|^2)   [in numpy-normalized FFT terms]
* Peak ratio (first_vs_second_peak_statistic :599-666): first/second peak
  with a +-1 chip circular exclusion zone, second peak searched in the same
  Doppler bin.
* Threshold from Pfa (gps_l1_ca_pcps_acquisition.cc:262-280):
  thr = Quantile[Exp(rate=F)]((1-pfa)^(1/ncells)), ncells = F * n_bins.
* Doppler grid (init :310-357): bins at -doppler_max + k*doppler_step,
  k in [0, ceil(2*doppler_max/step)); wipe-off = exp(-j*2*pi*f*n/fs).
* bit_transition_flag doubles the correlation window to straddle nav-bit
  edges (set_local_code :239-273).
* Two-step refinement (:745+, acq_conf.h:46-48): a narrow per-PRN grid
  around the coarse Doppler with doppler_step2.
* Non-coherent dwell accumulation (max_dwells): |corr|^2 grids summed.
* Tong sequential detection (pcps_tong_acquisition_cc): a per-PRN counter
  walked up or down by single-dwell threshold tests (`acquire_tong`).
* FDMA (GLONASS, is_fdma() :277-283): each PRN's constant carrier offset
  is folded into its stored replica, so one batched grid searches every
  slot's own band (`freq_offsets_by_prn`).

The grid maxima use torch.argmax, which returns the first maximal index —
the same tie-break as a first-index scan.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import resolve_device

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AcqConfig:
    """Mirror of Acq_Conf (src/algorithms/acquisition/libs/acq_conf.h)."""

    fs_hz: float
    samples_per_code: int          # samples in one PRN period at fs
    samples_per_chip: int = 4
    doppler_max_hz: float = 5000.0
    doppler_step_hz: float = 250.0
    sampled_ms: int = 1            # coherent integration in code periods
    max_dwells: int = 1            # non-coherent accumulations
    bit_transition_flag: bool = False
    use_cfar: bool = True
    threshold: float = 0.0         # 0 -> derive from pfa
    pfa: float = 0.0
    # two-step fine search
    make_two_steps: bool = False
    doppler_step2_hz: float = 125.0
    num_doppler_bins_step2: int = 4

    @property
    def coherent_samples(self) -> int:
        return self.samples_per_code * self.sampled_ms

    @property
    def fft_size(self) -> int:
        n = self.coherent_samples
        return 2 * n if self.bit_transition_flag else n

    @property
    def num_doppler_bins(self) -> int:
        return int(math.ceil(2.0 * self.doppler_max_hz / self.doppler_step_hz))

    @property
    def effective_size(self) -> int:
        """Number of correlation lags kept (one code period span)."""
        return self.coherent_samples

    def doppler_bins_hz(self) -> np.ndarray:
        k = np.arange(self.num_doppler_bins)
        return -self.doppler_max_hz + k * self.doppler_step_hz

    def derived_threshold(self) -> float:
        """Threshold from Pfa via the exponential-quantile rule (CFAR)."""
        if self.pfa <= 0.0:
            return self.threshold
        ncells = self.fft_size * self.num_doppler_bins
        val = (1.0 - self.pfa) ** (1.0 / ncells)
        return float(-math.log1p(-val) / self.fft_size)


@dataclasses.dataclass
class AcqResult:
    """Per-PRN acquisition outcome -> Gnss_Synchro.Acq_* fields."""

    positive: np.ndarray        # bool[C]
    delay_samples: np.ndarray   # float[C]
    doppler_hz: np.ndarray      # float[C]
    test_stat: np.ndarray       # float[C]
    samplestamp: int = 0


def _doppler_wipeoffs(cfg: AcqConfig) -> np.ndarray:
    n = np.arange(cfg.fft_size, dtype=np.float64)
    f = cfg.doppler_bins_hz()[:, None]
    return np.exp(-2j * np.pi * f * n[None, :] / cfg.fs_hz).astype(
        np.complex64)


def pcps_core(x, code_fft_conj, wipeoffs, prev_grid, eff: int, spc: int,
              samples_per_chip: int):
    """One non-coherent dwell over the full (PRN, Doppler) grid.

    x [F] complex64, code_fft_conj [C, F] complex64, wipeoffs [D, F]
    complex64, prev_grid [C, D, eff] f32.  Returns (grid, (stat_cfar,
    stat_ratio, delay, d_idx, input_power))."""
    C = code_fft_conj.shape[0]
    F = x.shape[-1]
    X = torch.fft.fft(x[None, :] * wipeoffs, dim=-1)              # [D, F]
    z = torch.fft.ifft(X[None, :, :] * code_fft_conj[:, None, :], dim=-1)
    zk = z[..., :eff]
    grid = prev_grid + (zk.real ** 2 + zk.imag ** 2)              # [C, D, eff]

    # global peak per PRN over (D, eff): first maximal index
    flat = grid.reshape(C, -1)
    arg = torch.argmax(flat, dim=-1)
    peak = flat.gather(1, arg[:, None])[:, 0]
    d_idx = arg // eff
    t_idx = arg % eff

    input_power = torch.mean(x.real ** 2 + x.imag ** 2)
    stat_cfar = peak / (float(F) * float(F) * input_power)

    # peak ratio: zero a +-1 chip circular window in the peak's Doppler row
    row = grid[torch.arange(C, device=grid.device), d_idx]        # [C, eff]
    lag = torch.arange(eff, device=grid.device)[None, :]
    dist = torch.abs(lag - t_idx[:, None])
    dist = torch.minimum(dist, eff - dist)                        # circular
    excl = dist <= samples_per_chip
    second = torch.max(torch.where(excl, torch.zeros_like(row), row), dim=-1)
    stat_ratio = peak / torch.clamp(second.values,
                                    min=float(torch.finfo(_F32).tiny))
    delay = torch.remainder(t_idx, spc).to(_F32)
    return grid, (stat_cfar, stat_ratio, delay, d_idx, input_power)


def pcps_step2(x, code_fft_conj, doppler_center, prev_grid, step2_hz: float,
               eff: int, spc: int, n_bins2: int, fs_hz: float):
    """Fine-Doppler second pass on a narrow per-PRN grid (d_step_two),
    accumulated non-coherently over dwells like the coarse pass.  Returns
    (grid, (delay, fine_doppler))."""
    dev = x.device
    F = x.shape[-1]
    n = torch.arange(F, dtype=_F32, device=dev)
    k = torch.arange(n_bins2, dtype=_F32, device=dev) - math.floor(
        n_bins2 / 2.0)
    freqs = doppler_center[:, None] + k[None, :] * float(step2_hz)  # [C, D2]
    phase = -2.0 * math.pi * freqs[..., None] * n[None, None, :] \
        / float(fs_hz)
    wipe = torch.complex(torch.cos(phase), torch.sin(phase))
    X = torch.fft.fft(x[None, None, :] * wipe, dim=-1)            # [C, D2, F]
    z = torch.fft.ifft(X * code_fft_conj[:, None, :], dim=-1)
    zk = z[..., :eff]
    grid = prev_grid + zk.real ** 2 + zk.imag ** 2
    C = grid.shape[0]
    arg = torch.argmax(grid.reshape(C, -1), dim=-1)
    d_idx = arg // eff
    fine_doppler = freqs.gather(1, d_idx[:, None])[:, 0]
    delay = torch.remainder(arg % eff, spc).to(_F32)
    return grid, (delay, fine_doppler)


class PcpsAcquisition:
    """Multi-PRN PCPS engine: one instance per (signal, fs) pair.

    Precomputes conj(FFT(code)) for the requested PRNs and the Doppler
    wipe-off grid; `acquire()` runs every PRN x Doppler bin as one batched
    tensor op per dwell, replacing the reference's per-channel worker
    threads (pcps_acquisition.cc:941).  `device`: None runs on the card
    (and raises without one); the CPU only when asked for.
    """

    def __init__(self, cfg: AcqConfig, codes_by_prn: dict[int, np.ndarray],
                 fs_code_rate: tuple[float, int] | None = None,
                 freq_offsets_by_prn: dict[int, float] | None = None,
                 device=None):
        """`codes_by_prn`: PRN -> +-1 chip array (1 sample/chip).
        `fs_code_rate`: (code_rate_chips_s, code_length_chips) used to
        resample chips to fs; if None, codes are pre-sampled at fs with
        exactly cfg.samples_per_code samples.
        `freq_offsets_by_prn`: per-PRN constant carrier offset (GLONASS
        FDMA k * DFRQ) folded into the stored replica as
        exp(+j 2 pi f0 n / fs); the reported Doppler stays the residual
        against the slot's carrier."""
        from ..codes.sampling import resample_code

        self.cfg = cfg
        self.device = resolve_device(device)
        self.prns = sorted(codes_by_prn)
        self.freq_offsets = {
            p: float((freq_offsets_by_prn or {}).get(p, 0.0))
            for p in self.prns}
        F = cfg.fft_size
        sampled = []
        periods = []
        for prn in self.prns:
            chips = codes_by_prn[prn]
            if fs_code_rate is not None:
                rate, _ = fs_code_rate
                one_period = resample_code(chips, cfg.fs_hz, rate,
                                           cfg.samples_per_code)
            else:
                one_period = np.asarray(chips)
                if len(one_period) != cfg.samples_per_code:
                    raise ValueError("pre-sampled code length mismatch")
            rep = np.tile(one_period, cfg.sampled_ms).astype(np.complex128)
            f0 = self.freq_offsets[prn]
            if f0:
                n = np.arange(len(rep), dtype=np.float64)
                rep = rep * np.exp(2j * np.pi * f0 * n / cfg.fs_hz)
            buf = np.zeros(F, dtype=np.complex64)
            buf[: len(rep)] = rep
            sampled.append(np.conj(np.fft.fft(buf)).astype(np.complex64))
            periods.append(np.asarray(one_period, dtype=np.complex64))
        dev = self.device
        # one-period time-domain replica bank (variants.FineDopplerAcquisition
        # reuses it for the code wipe-off)
        self._codes_time = torch.as_tensor(np.stack(periods), device=dev)
        self._code_fft_conj = torch.as_tensor(np.stack(sampled), device=dev)
        self._wipeoffs = torch.as_tensor(_doppler_wipeoffs(cfg), device=dev)
        self._threshold = (cfg.derived_threshold() if cfg.use_cfar
                           else cfg.threshold)
        self._doppler_bins = cfg.doppler_bins_hz()

    def _dwell_block(self, samples, dwell: int):
        cfg = self.cfg
        F = cfg.fft_size
        start = dwell * cfg.coherent_samples
        blk = np.zeros(F, dtype=np.complex64)
        chunk = np.asarray(samples[start:start + F])
        blk[: len(chunk)] = chunk
        return torch.as_tensor(blk, device=self.device)

    def acquire(self, samples: np.ndarray, samplestamp: int = 0) -> AcqResult:
        """Acquire all PRNs from `samples` (>= max_dwells * coherent window,
        complex64 at fs)."""
        # one transfer for the result rows
        return self.result(self.search(samples).cpu().numpy(), samplestamp)

    def search(self, samples: np.ndarray) -> torch.Tensor:
        """The grid search of `acquire` without its readback: the result
        rows [4, C] on the device (CFAR and peak-ratio statistics, delay,
        and the fine Doppler in Hz with two steps, else the Doppler bin
        index), for `result`."""
        cfg = self.cfg
        eff = cfg.effective_size
        C = len(self.prns)
        blocks = [self._dwell_block(samples, d) for d in range(cfg.max_dwells)]
        grid = torch.zeros((C, cfg.num_doppler_bins, eff), dtype=_F32,
                           device=self.device)
        stats = None
        for blk in blocks:
            grid, stats = pcps_core(blk, self._code_fft_conj, self._wipeoffs,
                                    grid, eff, cfg.samples_per_code,
                                    cfg.samples_per_chip)
        stat_cfar, stat_ratio, delay, d_idx, _ = stats
        if not cfg.make_two_steps:
            return torch.stack([stat_cfar, stat_ratio, delay,
                                d_idx.to(_F32)])
        centre = torch.as_tensor(self._doppler_bins, dtype=_F32,
                                 device=self.device)[d_idx]
        grid2 = torch.zeros((C, cfg.num_doppler_bins_step2, eff),
                            dtype=_F32, device=self.device)
        for blk in blocks:
            grid2, (delay, doppler_t) = pcps_step2(
                blk, self._code_fft_conj, centre, grid2,
                cfg.doppler_step2_hz, eff, cfg.samples_per_code,
                cfg.num_doppler_bins_step2, cfg.fs_hz)
        return torch.stack([stat_cfar, stat_ratio, delay, doppler_t])

    def result(self, rows: np.ndarray, samplestamp: int = 0) -> AcqResult:
        """The AcqResult of `search`'s rows on the host."""
        stat_cfar, stat_ratio, delay, dop = rows
        if self.cfg.make_two_steps:
            doppler = dop
        else:
            doppler = self._doppler_bins[dop.astype(np.int64)]
        test_stat = stat_cfar if self.cfg.use_cfar else stat_ratio
        return AcqResult(
            positive=np.asarray(test_stat) > self._threshold,
            delay_samples=np.asarray(delay, dtype=np.float64),
            doppler_hz=np.asarray(doppler, dtype=np.float64),
            test_stat=np.asarray(test_stat, dtype=np.float64),
            samplestamp=samplestamp,
        )

    def acquire_tong(self, samples: np.ndarray, tong_init: int = 2,
                     tong_max: int = 10, max_dwells: int = 30,
                     samplestamp: int = 0) -> AcqResult:
        """Tong sequential detector (pcps_tong_acquisition_cc analogue).

        Per-PRN counter starts at `tong_init`; each single-dwell statistic
        above threshold increments it, below decrements; reaching
        `tong_max` declares the satellite present, reaching 0 absent.  One
        packed [4, C] readback per dwell feeds the host-side counters."""
        cfg = self.cfg
        need = cfg.coherent_samples
        C = len(self.prns)
        counters = np.full(C, tong_init, dtype=np.int64)
        decided = np.zeros(C, dtype=bool)
        positive = np.zeros(C, dtype=bool)
        best = {"delay": np.zeros(C), "doppler": np.zeros(C),
                "stat": np.zeros(C)}
        zero_grid = torch.zeros((C, cfg.num_doppler_bins, cfg.effective_size),
                                dtype=_F32, device=self.device)
        for dwell in range(max_dwells):
            if dwell * need + 1 > len(samples):
                break
            _, stats = pcps_core(self._dwell_block(samples, dwell),
                                 self._code_fft_conj, self._wipeoffs,
                                 zero_grid, cfg.effective_size,
                                 cfg.samples_per_code, cfg.samples_per_chip)
            stat_cfar, stat_ratio, delay, d_idx, _ = stats
            stat_cfar, stat_ratio, delay, didx_f = torch.stack(
                [stat_cfar, stat_ratio, delay, d_idx.to(_F32)]).cpu().numpy()
            stat = stat_cfar if cfg.use_cfar else stat_ratio
            hit = stat > self._threshold
            upd = ~decided
            counters[upd & hit] += 1
            counters[upd & ~hit] -= 1
            better = upd & (stat > best["stat"])
            best["stat"][better] = stat[better]
            best["delay"][better] = delay[better]
            best["doppler"][better] = self._doppler_bins[
                didx_f.astype(np.int64)][better]
            newly_pos = upd & (counters >= tong_max)
            newly_neg = upd & (counters <= 0)
            positive[newly_pos] = True
            decided |= newly_pos | newly_neg
            if decided.all():
                break
        return AcqResult(positive=positive, delay_samples=best["delay"],
                         doppler_hz=best["doppler"], test_stat=best["stat"],
                         samplestamp=samplestamp)

    @property
    def threshold(self) -> float:
        return self._threshold
