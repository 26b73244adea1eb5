"""Acquisition strategy variants: QuickSync, CCCWSR, fine-Doppler, 8 ms,
and E5a noncoherent-IQ CAF, on torch.fft.

Reference parity:
* QuickSync — pcps_quicksync_acquisition_cc.cc: the signal and replica are
  FOLDED by summing `folding_factor` consecutive sub-segments (:187-200),
  the circular correlation runs at samples_per_code / folding_factor lags
  (:95), and the true code phase is disambiguated among the folding_factor
  candidate delays by direct correlation against the unfolded replica
  (d_possible_delay / d_corr_output_f, :101-102).
* CCCWSR — pcps_cccwsr_acquisition_cc.cc: coherent combining of the E1B
  (data) and E1C (pilot) correlations with sign recovery, plus = data +
  j*pilot, minus = data - j*pilot (:344-352); the larger magnitude wins.
* Fine-Doppler — pcps_acquisition_fine_doppler_cc.cc:estimate_Doppler():
  after the coarse grid detection, wipe the code replica (rotated to the
  detected delay, tiled over prn_replicas=10 periods) off the signal and
  take a zero_padding_factor=8 zero-padded FFT; the magnitude peak is the
  fine Doppler, accepted when within 1 kHz of the coarse bin.
* 8 ms — galileo_pcps_8ms_acquisition_cc.cc: coherent integration over two
  E1 code periods with two replica banks, A = [code, code] and
  B = [code, -code]; the larger peak of the two wins.
* CAF — galileo_e5a_noncoherent_iq_acquisition_caf_cc.cc: noncoherent
  combining of the E5a-I and E5a-Q correlation magnitudes, then a
  triangular-weighted moving average of the per-Doppler peaks over
  CAF_window_hz (:676-760) before the Doppler decision.

Each core is one batched torch program over the whole (PRN, Doppler) grid
(the JAX package's `_quicksync_core`, `_cccwsr_core`, `_fine_doppler_core`,
`_pcps_8ms_core` and `_caf_iq_core` in gnss_sdr_1_tpu/acquire/variants.py)
and returns its (stat, delay, Doppler index) rows, read back as one packed
[3, C] array.  Grid maxima use torch.argmax (the first maximal index, the
JAX package's tie-break).  `device`: None runs on the card (and raises
without one); the CPU only when asked for.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from .pcps import AcqConfig, AcqResult, _doppler_wipeoffs

_F32 = torch.float32


def _get3(stat, delay, d_idx):
    """(stat, delay, Doppler index) rows as numpy from one [3, C] f32
    readback."""
    stat, delay, didx = torch.stack(
        [stat.to(_F32), delay.to(_F32), d_idx.to(_F32)]).cpu().numpy()
    return stat, delay, didx.astype(np.int64)


def _flat_argmax(flat):
    """Per-row (max, first argmax)."""
    arg = torch.argmax(flat, dim=-1)
    return flat.gather(-1, arg[..., None])[..., 0], arg


def _power(z):
    return z.real ** 2 + z.imag ** 2


def _input_power(x):
    return torch.mean(x.real ** 2 + x.imag ** 2)


def _fft_bank(codes_by_prn, prns, cfg: AcqConfig, dev):
    """conj(FFT) of each PRN's pre-sampled code, tiled over sampled_ms
    periods and zero-padded to fft_size: [C, F] complex64."""
    F = cfg.fft_size
    rows = []
    for prn in prns:
        rep = np.tile(np.asarray(codes_by_prn[prn], dtype=np.complex128),
                      cfg.sampled_ms)
        buf = np.zeros(F, dtype=np.complex64)
        buf[: len(rep)] = rep
        rows.append(np.conj(np.fft.fft(buf)).astype(np.complex64))
    return torch.as_tensor(np.stack(rows), device=dev)


def _block(samples, n: int, dev):
    """The first n samples, zero-padded to n, as a complex64 tensor."""
    blk = np.zeros(n, dtype=np.complex64)
    chunk = np.asarray(samples[:n])
    blk[: len(chunk)] = chunk
    return torch.as_tensor(blk, device=dev)


# ---------------------------------------------------------------------------
# QuickSync
# ---------------------------------------------------------------------------


def quicksync_core(x, codes, wipeoffs, fold: int, spc: int):
    """Folded PCPS: wipe off each Doppler bin over one code period, fold
    signal and replica by `fold`, correlate at spc/fold lags, then pick the
    true delay among the `fold` candidates by direct correlation against
    the unfolded replica.  x [spc] complex64, codes [C, spc] complex64
    (+-1), wipeoffs [D, spc] complex64.  Returns (stat, delay, d_idx)."""
    C = codes.shape[0]
    D = wipeoffs.shape[0]
    Ff = spc // fold
    dev = x.device
    xw = x[None, :] * wipeoffs                               # [D, spc]
    xf = xw.reshape(D, fold, Ff).sum(dim=1)                  # [D, Ff]
    cf = codes.reshape(C, fold, Ff).sum(dim=1)               # [C, Ff]
    X = torch.fft.fft(xf, dim=-1)
    Cf = torch.conj(torch.fft.fft(cf, dim=-1))
    z = torch.fft.ifft(X[None, :, :] * Cf[:, None, :], dim=-1)   # [C, D, Ff]
    peak, arg = _flat_argmax(_power(z).reshape(C, -1))
    d_idx = arg // Ff
    t_fold = arg % Ff                                        # delay mod Ff
    # CFAR statistic: a noise cell of the folded grid ~ Exp(1) after
    # dividing by fold * spc * sigma^2
    stat = peak / (float(fold) * float(spc) * _input_power(x))
    # disambiguation: candidate delays t_fold + k*Ff, the winning bin's
    # unfolded wiped signal against the replica rolled to each candidate
    xw_c = xw[d_idx]                                         # [C, spc]
    n = torch.arange(spc, device=dev)
    k = torch.arange(fold, device=dev)
    idx = torch.remainder(n[None, None, :] - (t_fold[:, None, None]
                                              + k[None, :, None] * Ff), spc)
    cand = torch.gather(codes[:, None, :].expand(C, fold, spc), 2, idx)
    cc = (xw_c[:, None, :] * cand).sum(dim=-1)               # [C, fold]
    kbest = torch.argmax(_power(cc), dim=-1)
    delay = (t_fold + kbest * Ff).to(_F32)
    return stat, delay, d_idx


class QuickSyncAcquisition:
    """GPS_L1_CA_PCPS_QuickSync_Acquisition /
    Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition analogue."""

    def __init__(self, cfg: AcqConfig, codes_by_prn: dict[int, np.ndarray],
                 folding_factor: int = 2,
                 fs_code_rate: tuple[float, int] | None = None, device=None):
        from ..codes.sampling import resample_code

        if cfg.samples_per_code % folding_factor:
            raise ValueError("samples_per_code must divide by folding_factor")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fold = int(folding_factor)
        self.prns = sorted(codes_by_prn)
        rows = []
        for prn in self.prns:
            chips = codes_by_prn[prn]
            if fs_code_rate is not None:
                rows.append(resample_code(chips, cfg.fs_hz, fs_code_rate[0],
                                          cfg.samples_per_code))
            else:
                rows.append(np.asarray(chips, dtype=np.float32))
        dev = self.device
        self._codes = torch.as_tensor(np.stack(rows).astype(np.complex64),
                                      device=dev)
        wip = _doppler_wipeoffs(cfg)[:, : cfg.samples_per_code]
        self._wipeoffs = torch.as_tensor(np.ascontiguousarray(wip),
                                         device=dev)
        self._doppler_bins = cfg.doppler_bins_hz()
        if cfg.use_cfar and cfg.pfa > 0.0:
            # Exp(1)-normalized cells: the (1-pfa)^(1/ncells) quantile of
            # the unit exponential over the folded grid
            ncells = (cfg.samples_per_code // self.fold) \
                * cfg.num_doppler_bins
            val = (1.0 - cfg.pfa) ** (1.0 / ncells)
            self._threshold = float(-math.log1p(-val))
        else:
            self._threshold = cfg.threshold

    def acquire(self, samples: np.ndarray, samplestamp: int = 0) -> AcqResult:
        spc = self.cfg.samples_per_code
        stat, delay, d_idx = _get3(*quicksync_core(
            _block(samples, spc, self.device), self._codes, self._wipeoffs,
            self.fold, spc))
        return AcqResult(
            positive=np.asarray(stat) > self._threshold,
            delay_samples=np.asarray(delay, dtype=np.float64),
            doppler_hz=self._doppler_bins[d_idx],
            test_stat=np.asarray(stat, dtype=np.float64),
            samplestamp=samplestamp)


# ---------------------------------------------------------------------------
# CCCWSR
# ---------------------------------------------------------------------------


def cccwsr_core(x, data_fft, pilot_fft, wipeoffs, eff: int, spc: int):
    """Coherent data+pilot combining with sign recovery (:297-360).
    x [F], data_fft / pilot_fft [C, F] conj FFTs of the E1B / E1C codes,
    wipeoffs [D, F].  Returns (stat, delay, d_idx)."""
    C = data_fft.shape[0]
    F = x.shape[-1]
    X = torch.fft.fft(x[None, :] * wipeoffs, dim=-1)              # [D, F]
    zd = torch.fft.ifft(X[None] * data_fft[:, None], dim=-1)     # [C, D, F]
    zp = torch.fft.ifft(X[None] * pilot_fft[:, None], dim=-1)
    # plus = data + j*pilot, minus = data - j*pilot (:344-352)
    plus = (zd.real - zp.imag) ** 2 + (zd.imag + zp.real) ** 2
    minus = (zd.real + zp.imag) ** 2 + (zd.imag - zp.real) ** 2
    mag = torch.maximum(plus, minus)[..., :eff]
    peak, arg = _flat_argmax(mag.reshape(C, -1))
    stat = peak / (float(F) * float(F) * _input_power(x))
    delay = torch.remainder(arg % eff, spc).to(_F32)
    return stat, delay, arg // eff


class CccwsrAcquisition:
    """Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition analogue: coherently
    combines the E1B (data) and E1C (pilot) components with sign recovery.
    Codes pre-sampled at fs (cfg.samples_per_code samples per period)."""

    def __init__(self, cfg: AcqConfig,
                 data_codes_by_prn: dict[int, np.ndarray],
                 pilot_codes_by_prn: dict[int, np.ndarray], device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prns = sorted(data_codes_by_prn)
        dev = self.device
        self._data_fft = _fft_bank(data_codes_by_prn, self.prns, cfg, dev)
        self._pilot_fft = _fft_bank(pilot_codes_by_prn, self.prns, cfg, dev)
        self._wipeoffs = torch.as_tensor(_doppler_wipeoffs(cfg), device=dev)
        self._doppler_bins = cfg.doppler_bins_hz()
        self._threshold = (cfg.derived_threshold() if cfg.use_cfar
                           else cfg.threshold)

    def acquire(self, samples: np.ndarray, samplestamp: int = 0) -> AcqResult:
        cfg = self.cfg
        stat, delay, d_idx = _get3(*cccwsr_core(
            _block(samples, cfg.fft_size, self.device), self._data_fft,
            self._pilot_fft, self._wipeoffs, cfg.effective_size,
            cfg.samples_per_code))
        return AcqResult(
            positive=np.asarray(stat) > self._threshold,
            delay_samples=np.asarray(delay, dtype=np.float64),
            doppler_hz=self._doppler_bins[d_idx],
            test_stat=np.asarray(stat, dtype=np.float64),
            samplestamp=samplestamp)


# ---------------------------------------------------------------------------
# fine Doppler
# ---------------------------------------------------------------------------


def fine_doppler_core(wiped, codes, delays, fs: float, n_rep: int, pad: int):
    """Zero-padded FFT of the code-wiped signal (estimate_Doppler):
    wiped [C, n_rep*spc] complex64 (each PRN's samples with its coarse
    Doppler wiped off), codes [C, spc] complex64 (+-1), delays [C] int.
    Returns the residual peak frequency in Hz per PRN (f32)."""
    spc = codes.shape[-1]
    n = torch.arange(spc, device=codes.device)
    # replica rotated so chip 0 lands at the detected delay, tiled n_rep x
    idx = torch.remainder(n[None, :] - delays[:, None], spc)
    rep = torch.gather(codes, 1, idx).repeat(1, n_rep)       # [C, n_rep*spc]
    F = n_rep * spc * pad
    spec = torch.fft.fft(wiped * torch.conj(rep), n=F, dim=-1)
    k = torch.argmax(_power(spec), dim=-1)
    # fftfreq: bins [0, F/2) positive, [F/2, F) negative
    return (torch.where(k < F // 2, k, k - F) * (fs / F)).to(_F32)


class FineDopplerAcquisition:
    """GPS_L1_CA_PCPS_Acquisition_Fine_Doppler analogue: the coarse PCPS
    grid plus the fine-Doppler FFT refinement.  Needs `prn_replicas` code
    periods of samples (10 in the reference)."""

    def __init__(self, pcps, prn_replicas: int = 10,
                 zero_padding_factor: int = 8,
                 accept_window_hz: float = 1000.0):
        """`pcps` is a configured acquire.pcps.PcpsAcquisition; its
        baseband code replicas and device are reused."""
        self.pcps = pcps
        self.cfg = pcps.cfg
        self.device = pcps.device
        self.prns = pcps.prns
        self.n_rep = int(prn_replicas)
        self.pad = int(zero_padding_factor)
        self.accept_hz = float(accept_window_hz)

    def acquire(self, samples: np.ndarray, samplestamp: int = 0) -> AcqResult:
        res = self.pcps.acquire(samples, samplestamp=samplestamp)
        spc = self.cfg.samples_per_code
        need = self.n_rep * spc
        blk = np.zeros(need, dtype=np.complex64)
        chunk = np.asarray(samples[:need])
        blk[: len(chunk)] = chunk
        # wipe off the coarse Doppler so the fine FFT peak lands at
        # (true - coarse); the fine estimate is coarse + peak
        t = np.arange(need) / self.cfg.fs_hz
        coarse = np.asarray(res.doppler_hz, dtype=np.float64)
        delays = np.mod(np.round(res.delay_samples), spc).astype(np.int64)
        wiped = blk[None, :] * np.exp(-2j * np.pi * coarse[:, None]
                                      * t[None, :]).astype(np.complex64)
        dev = self.device
        resid = fine_doppler_core(
            torch.as_tensor(wiped.astype(np.complex64), device=dev),
            self.pcps._codes_time, torch.as_tensor(delays, device=dev),
            self.cfg.fs_hz, self.n_rep, self.pad).cpu().numpy().astype(
                np.float64)
        fine = coarse + resid
        # accept only refinements within the window (estimate_Doppler's
        # 1 kHz sanity gate)
        freqs = np.where(np.abs(fine - coarse) < self.accept_hz, fine, coarse)
        return AcqResult(
            positive=res.positive, delay_samples=res.delay_samples,
            doppler_hz=np.where(res.positive, freqs, res.doppler_hz),
            test_stat=res.test_stat, samplestamp=res.samplestamp)


# ---------------------------------------------------------------------------
# 8 ms
# ---------------------------------------------------------------------------


def pcps_8ms_core(x, fft_a, fft_b, wipeoffs, eff: int, spc: int):
    """Two-replica 8 ms coherent PCPS (galileo_pcps_8ms_acquisition_cc):
    bank A = [code, code], bank B = [code, -code]; the larger peak wins.
    Returns (stat, delay, d_idx)."""
    C = fft_a.shape[0]
    F = x.shape[-1]
    X = torch.fft.fft(x[None, :] * wipeoffs, dim=-1)             # [D, F]
    za = torch.fft.ifft(X[None] * fft_a[:, None], dim=-1)       # [C, D, F]
    zb = torch.fft.ifft(X[None] * fft_b[:, None], dim=-1)
    mag = torch.maximum(_power(za), _power(zb))[..., :eff]
    peak, arg = _flat_argmax(mag.reshape(C, -1))
    stat = peak / (float(F) * float(F) * _input_power(x))
    return stat, torch.remainder(arg % eff, spc).to(_F32), arg // eff


class Pcps8msAcquisition:
    """Galileo_E1_PCPS_8ms_Ambiguous_Acquisition analogue: coherent
    integration over two 4 ms E1 code periods with a sign-flip replica.
    Codes pre-sampled at fs (cfg.samples_per_code per period);
    cfg.sampled_ms must be 2 code periods (8 ms for E1)."""

    def __init__(self, cfg: AcqConfig, codes_by_prn: dict[int, np.ndarray],
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prns = sorted(codes_by_prn)
        F = cfg.fft_size
        spc = cfg.samples_per_code
        rows_a, rows_b = [], []
        for prn in self.prns:
            code = np.asarray(codes_by_prn[prn], dtype=np.complex128)[:spc]
            for rows, sign in ((rows_a, 1.0), (rows_b, -1.0)):
                buf = np.zeros(F, dtype=np.complex64)
                rep = np.concatenate([code, sign * code])
                buf[: len(rep)] = rep
                rows.append(np.conj(np.fft.fft(buf)).astype(np.complex64))
        dev = self.device
        self._fft_a = torch.as_tensor(np.stack(rows_a), device=dev)
        self._fft_b = torch.as_tensor(np.stack(rows_b), device=dev)
        self._wipeoffs = torch.as_tensor(_doppler_wipeoffs(cfg), device=dev)
        self._doppler_bins = cfg.doppler_bins_hz()
        self._threshold = (cfg.derived_threshold() if cfg.use_cfar
                           else cfg.threshold)

    def acquire(self, samples: np.ndarray, samplestamp: int = 0) -> AcqResult:
        cfg = self.cfg
        stat, delay, d_idx = _get3(*pcps_8ms_core(
            _block(samples, cfg.fft_size, self.device), self._fft_a,
            self._fft_b, self._wipeoffs, 2 * cfg.samples_per_code,
            cfg.samples_per_code))
        return AcqResult(
            positive=np.asarray(stat) > self._threshold,
            delay_samples=np.asarray(delay, dtype=np.float64),
            doppler_hz=self._doppler_bins[d_idx],
            test_stat=np.asarray(stat, dtype=np.float64),
            samplestamp=samplestamp)


# ---------------------------------------------------------------------------
# E5a noncoherent I/Q with the CAF filter
# ---------------------------------------------------------------------------


def caf_iq_core(x, fft_i, fft_q, wipeoffs, caf_half: int, eff: int):
    """Noncoherent I/Q grid + CAF Doppler smoothing
    (galileo_e5a_noncoherent_iq_acquisition_caf_cc acquisition_core).
    Returns (stat, delay, d_idx)."""
    D = wipeoffs.shape[0]
    F = x.shape[-1]
    dev = x.device
    X = torch.fft.fft(x[None, :] * wipeoffs, dim=-1)
    zi = torch.fft.ifft(X[None] * fft_i[:, None], dim=-1)
    zq = torch.fft.ifft(X[None] * fft_q[:, None], dim=-1)
    grid = (_power(zi) + _power(zq))[..., :eff]
    # per-Doppler peak magnitude and its delay: the CAF vectors (:538)
    caf, t_at = _flat_argmax(grid)                            # [C, D]
    # triangular-weighted moving average over the Doppler axis (:676-760):
    # weight (1 - wf*|d-i|) over |d-i| <= caf_half, normalized by the sum
    # of in-range weights (edge-truncated), applied when caf_half > 0
    d = torch.arange(D, device=dev)
    dist = (d[:, None] - d[None, :]).abs().to(_F32)           # [D, D]
    half = float(caf_half)
    wf = 0.5 / max(half, 1.0)
    w = torch.where(dist <= half, 1.0 - wf * dist,
                    torch.zeros((), dtype=_F32, device=dev))
    smoothed = (caf @ w.T) / torch.clamp(w.sum(dim=-1)[None, :], min=1e-20)
    sel = smoothed if caf_half > 0 else caf
    d_idx = torch.argmax(sel, dim=-1)                         # [C]
    # delay and peak read from the winning bin of the raw grid
    peak = caf.gather(1, d_idx[:, None])[:, 0]
    t_idx = t_at.gather(1, d_idx[:, None])[:, 0]
    stat = peak / (float(F) * float(F) * _input_power(x))
    return stat, t_idx.to(_F32), d_idx


class CafAcquisition:
    """Galileo_E5a_Noncoherent_IQ_Acquisition_CAF analogue (E5a-I data and
    E5a-Q pilot codes pre-sampled at fs); the E5a receiver's 'caf'
    strategy."""

    def __init__(self, cfg: AcqConfig,
                 data_codes_by_prn: dict[int, np.ndarray],
                 pilot_codes_by_prn: dict[int, np.ndarray],
                 caf_window_hz: float = 0.0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prns = sorted(data_codes_by_prn)
        dev = self.device
        self._fft_i = _fft_bank(data_codes_by_prn, self.prns, cfg, dev)
        self._fft_q = _fft_bank(pilot_codes_by_prn, self.prns, cfg, dev)
        self._wipeoffs = torch.as_tensor(_doppler_wipeoffs(cfg), device=dev)
        self._doppler_bins = cfg.doppler_bins_hz()
        self._caf_half = int(caf_window_hz / (2.0 * cfg.doppler_step_hz))
        self._threshold = (cfg.derived_threshold() if cfg.use_cfar
                           else cfg.threshold)

    def acquire(self, samples: np.ndarray, samplestamp: int = 0) -> AcqResult:
        cfg = self.cfg
        stat, delay, d_idx = _get3(*caf_iq_core(
            _block(samples, cfg.fft_size, self.device), self._fft_i,
            self._fft_q, self._wipeoffs, self._caf_half, cfg.effective_size))
        return AcqResult(
            positive=np.asarray(stat) > self._threshold,
            delay_samples=np.mod(np.asarray(delay, dtype=np.float64),
                                 cfg.samples_per_code),
            doppler_hz=self._doppler_bins[d_idx],
            test_stat=np.asarray(stat, dtype=np.float64),
            samplestamp=samplestamp)
