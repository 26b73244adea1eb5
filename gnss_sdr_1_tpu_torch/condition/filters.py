"""Front-end conditioning in torch on the receiver's device.

Reference parity: Freq_Xlating_Fir_Filter (freq_xlating_fir_filter.cc — gr
firdes low-pass + complex mix + decimation), Direct_Resampler
(direct_resampler_conditioner.cc — nearest-sample), Fir_Filter.  The mixer
and the FIR run as one overlap-save FFT convolution per block (torch.fft and
elementwise ops); the (n_taps - 1)-sample history and the mixer phase carry
between blocks, so the block seams are exact.  The FIR design and the
resamplers are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def to_device(x, device) -> torch.Tensor:
    """Samples (numpy, read-only memory maps included, or a tensor) as a
    complex64 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.complex64)
    x = np.asarray(x, dtype=np.complex64)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x).to(device)


def design_lowpass_fir(num_taps: int, cutoff_hz: float, fs_hz: float) -> np.ndarray:
    """Hamming-windowed sinc low-pass (gr::filter::firdes::low_pass analogue)."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    fc = cutoff_hz / fs_hz
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def direct_resample(x: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    """Nearest-previous-sample rate conversion (direct_resampler_conditioner.cc)."""
    n_out = int(np.floor(len(x) * fs_out / fs_in))
    idx = np.floor(np.arange(n_out) * (fs_in / fs_out)).astype(np.int64)
    return x[idx]


def fractional_resample(x: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    """Fractional (interpolating) rate conversion — the Mmse_Resampler /
    Fractional_Resampler role (mmse_resampler_conditioner.cc): linear
    interpolation, phase-continuous in sub-sample timing."""
    n_out = int(np.floor((len(x) - 1) * fs_out / fs_in))
    pos = np.arange(n_out, dtype=np.float64) * (fs_in / fs_out)
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    return (x[i0] * (1.0 - frac) + x[i0 + 1] * frac).astype(x.dtype)


def _freq_xlating_block(x, h_fft, phase0: float, phase_step: float,
                        decim: int, n_taps: int):
    """Overlap-save: mix to baseband, filter, decimate one block.

    `x` [N + n_taps - 1] complex64 carries (n_taps - 1) history samples at
    its head; the output holds (len - n_taps + 1) / decim samples.  The
    mixer phase is float32: phase0 + phase_step * n."""
    n_total = x.shape[0]
    dev = x.device
    idx = torch.arange(n_total, dtype=torch.float32, device=dev)
    # one rounding, as the reference's compiled mixer (a fused multiply-add)
    ph = torch.addcmul(torch.tensor(np.float32(phase0), device=dev),
                       torch.tensor(np.float32(phase_step), device=dev), idx)
    x = x * torch.complex(torch.cos(ph), torch.sin(ph))
    F = h_fft.shape[0]
    y = torch.fft.ifft(torch.fft.fft(x, n=F) * h_fft)[:n_total]
    return y[n_taps - 1::decim]


class Conditioner:
    """Streaming conditioner: mix IF -> baseband, FIR low-pass, decimate.

    Keeps the (n_taps-1)-sample overlap-save history and the mixer phase
    (a Python float, taken to float32 once per block) across blocks, so
    arbitrarily long streams process block by block with exact seams.
    `device`: None runs on the card (and raises without one); the CPU only
    when asked for."""

    def __init__(self, taps: np.ndarray, fs_hz: float,
                 if_freq_hz: float = 0.0, decim: int = 1,
                 block_size: int = 1 << 17, device=None):
        self.device = resolve_device(device)
        self.taps = np.asarray(taps, dtype=np.float32)
        self.n_taps = len(self.taps)
        self.fs_hz = fs_hz
        self.if_freq_hz = if_freq_hz
        self.decim = int(decim)
        # block_size chosen so block + taps - 1 <= next pow2 F
        self.block = int(block_size)
        total = self.block + self.n_taps - 1
        F = 1 << int(np.ceil(np.log2(total)))
        self._fft_size = F
        h = np.zeros(F, dtype=np.complex64)
        h[: self.n_taps] = self.taps
        self._h_fft = torch.as_tensor(
            np.fft.fft(h).astype(np.complex64), device=self.device)
        self._hist = torch.zeros(self.n_taps - 1, dtype=torch.complex64,
                                 device=self.device)
        self._step = -2.0 * np.pi * if_freq_hz / fs_hz
        # _phase tracks the mixer phase at the first HISTORY sample of the
        # next block; initialized so the stream's first real sample (which
        # sits after the zero history) is mixed with phase 0.
        self._phase = -self._step * (self.n_taps - 1)

    def start_at(self, history, n_blocks: int) -> None:
        """Continue the stream as if `n_blocks` whole blocks had been
        processed already, `history` being their last n_taps - 1 samples:
        the overlap-save history and the mixer phase `process` would hold
        there (the phase stepped block by block, as `process` steps it)."""
        hist = to_device(history, self.device)
        if hist.shape != self._hist.shape:
            raise ValueError(f"history must hold {self.n_taps - 1} samples, "
                             f"got {tuple(hist.shape)}")
        phase = -self._step * (self.n_taps - 1)
        for _ in range(int(n_blocks)):
            phase = float((phase + self._step * self.block) % (2.0 * np.pi))
        self._hist, self._phase = hist, phase

    def process(self, x, flush: bool = False) -> np.ndarray:
        """Feed samples (numpy or a tensor); returns the conditioned output
        at fs/decim as complex64 numpy."""
        return self.process_tensor(x, flush).cpu().numpy()

    def process_tensor(self, x, flush: bool = False) -> torch.Tensor:
        """`process` without the readback: the output stays on the
        device."""
        x = to_device(x, self.device)
        outs = []
        pos = 0
        while pos < len(x):
            chunk = x[pos : pos + self.block]
            if len(chunk) < self.block and not flush:
                break
            pad = self.block - len(chunk)
            buf = torch.cat([self._hist, chunk, torch.zeros(
                pad, dtype=torch.complex64, device=self.device)])
            y = _freq_xlating_block(buf, self._h_fft, self._phase,
                                    self._step, self.decim, self.n_taps)
            if pad:
                y = y[: int(np.ceil(len(chunk) / self.decim))]
            outs.append(y)
            self._hist = buf[len(buf) - pad - (self.n_taps - 1):
                             len(buf) - pad]
            self._phase = float(
                (self._phase + self._step * len(chunk)) % (2.0 * np.pi)
            )
            pos += len(chunk)
        if outs:
            return torch.cat(outs)
        return torch.empty(0, dtype=torch.complex64, device=self.device)


def freq_xlating_fir(x, taps: np.ndarray, fs_hz: float,
                     if_freq_hz: float = 0.0, decim: int = 1,
                     device=None) -> np.ndarray:
    """One-shot frequency-translating FIR + decimation: one Conditioner
    over the whole input, its last block flushed.  `device`: None runs on
    the card (and raises without one); the CPU only when asked for."""
    cond = Conditioner(taps, fs_hz, if_freq_hz, decim, device=device)
    return cond.process(x, flush=True)


# ------------------------------------------------------------- beamformer --

def steering_weights(n_antennas: int, spacing_wavelengths: float = 0.5,
                     steer_deg: float = 0.0) -> np.ndarray:
    """Uniform-linear-array phase weights pointing a beam at `steer_deg`
    from boresight.  With steer_deg=0 this reduces to the reference's
    all-ones weight vector (beamformer.cc:57, weight_vector[i] = (1,0))."""
    k = np.arange(n_antennas)
    phase = -2.0 * np.pi * spacing_wavelengths * k * np.sin(
        np.radians(steer_deg))
    return np.exp(1j * phase).astype(np.complex64)


class Beamformer:
    """Fixed-weight array combiner (Beamformer_Filter adapter,
    beamformer_filter.cc + beamformer.cc work()): y[n] = sum_i w[i]*x_i[n]
    over GNSS_SDR_BEAMFORMER_CHANNELS=8 antenna inputs, as real matmuls per
    I/Q plane on the device.

    Input: [N, A] complex (columns = antenna channels) or a list of A
    equal-length streams.  Weights default to the reference's all-ones
    vector; pass `steering_weights(...)` for a steered beam.
    """

    N_CHANNELS = 8   # GNSS_SDR_BEAMFORMER_CHANNELS

    def __init__(self, weights: np.ndarray | None = None,
                 n_antennas: int | None = None, device=None):
        self.device = resolve_device(device)
        if weights is None:
            weights = np.ones(n_antennas or self.N_CHANNELS, np.complex64)
        self.weights = np.asarray(weights, dtype=np.complex64)

    def process(self, x) -> np.ndarray:
        if isinstance(x, (list, tuple)):
            x = np.stack([np.asarray(c) for c in x], axis=1)
        x = np.asarray(x, dtype=np.complex64)
        if x.ndim != 2 or x.shape[1] != len(self.weights):
            raise ValueError(
                f"expected [N, {len(self.weights)}] array input, "
                f"got {x.shape}")
        y = _beamform_block(to_device(x, self.device),
                            to_device(self.weights, self.device))
        return y.cpu().numpy()


def _beamform_block(x, w):
    """[N, A] complex x [A] complex -> [N] complex, one real matmul pair per
    output plane."""
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    yr = xr @ w.real - xi @ w.imag
    yi = xr @ w.imag + xi @ w.real
    return torch.complex(yr, yi)
