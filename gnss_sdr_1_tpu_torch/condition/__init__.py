"""Signal conditioning: IF mixing, FIR filtering, resampling (device).

Reference parity: SignalConditioner chain (src/algorithms/conditioner/ +
data_type_adapter/ + input_filter/ + resampler/, SURVEY.md §2.5):
  * DataTypeAdapter    -> io.formats (conversion happens at ingest)
  * Freq_Xlating_Fir_Filter -> freq-shift + FIR decimate via overlap-save
    FFT block convolution (torch.fft on the device)
  * Direct_Resampler   -> nearest-previous-sample decimation (host)
  * Notch/pulse-blanking -> interference.notch_filter / pulse_blanking
  * Beamformer_Filter  -> fixed-weight array combiner (beamformer.cc)
"""

from .filters import (
    Beamformer,
    Conditioner,
    design_lowpass_fir,
    direct_resample,
    freq_xlating_fir,
    steering_weights,
)

__all__ = [
    "Beamformer", "Conditioner", "design_lowpass_fir", "direct_resample",
    "freq_xlating_fir", "steering_weights",
]
