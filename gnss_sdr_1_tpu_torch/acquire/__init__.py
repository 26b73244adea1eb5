"""Acquisition: batched PCPS (Parallel Code Phase Search) and its strategy
variants on torch.fft.

Reference parity: src/algorithms/acquisition/ pcps_acquisition.cc (and its
Tong, QuickSync, CCCWSR, fine-Doppler, 8 ms and E5a CAF variants): a
(channels, doppler_bins, fft_size) tensor pipeline of carrier wipe-off, FFT
circular correlation and CFAR / peak-ratio statistics.
"""

from .pcps import AcqConfig, AcqResult, PcpsAcquisition
from .variants import (CafAcquisition, CccwsrAcquisition,
                       FineDopplerAcquisition, Pcps8msAcquisition,
                       QuickSyncAcquisition)

__all__ = ["AcqConfig", "AcqResult", "PcpsAcquisition",
           "QuickSyncAcquisition", "CccwsrAcquisition",
           "FineDopplerAcquisition", "Pcps8msAcquisition", "CafAcquisition"]
