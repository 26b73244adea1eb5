"""PRN spreading-code generation (host-side, precomputed once per run).

Reference parity: src/algorithms/libs/gps_sdr_signal_processing.{h,cc},
gnss_signal_processing.cc.  GPS L1 C/A only in this package: codes are
generated from the public ICD shift-register definition, emitted as +-1
float arrays, then resampled / FFT'd per sampling rate by the acquisition
and tracking layers.  Pure NumPy — tiny, run once.
"""

from .gps_l1ca import gps_l1ca_code
from .sampling import code_to_baseband, resample_code

__all__ = ["gps_l1ca_code", "resample_code", "code_to_baseband",
           "generate_code", "tracking_replica"]


def tracking_replica(signal_id: str, prn: int):
    """Local replica for acquisition/tracking: returns
    (samples, chip_rate, code_samples_per_chip)."""
    chips = generate_code(signal_id, prn)
    from ..constants import SIGNALS

    return chips, SIGNALS[signal_id].code_rate_chips_s, 1


def generate_code(signal_id: str, prn: int):
    """(signal_id, prn) -> +-1 float32 chip array at 1 sample/chip."""
    if signal_id == "1C":
        return gps_l1ca_code(prn)
    raise NotImplementedError(
        f"signal {signal_id!r} is not ported yet (GPS L1 C/A '1C' only)")
