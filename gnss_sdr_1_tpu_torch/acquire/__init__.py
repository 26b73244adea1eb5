"""Acquisition: batched PCPS (Parallel Code Phase Search) on torch.fft.

Reference parity: src/algorithms/acquisition/ pcps_acquisition.cc: a
(channels, doppler_bins, fft_size) tensor pipeline of carrier wipe-off, FFT
circular correlation and CFAR / peak-ratio statistics.
"""

from .pcps import AcqConfig, AcqResult, PcpsAcquisition

__all__ = ["AcqConfig", "AcqResult", "PcpsAcquisition"]
