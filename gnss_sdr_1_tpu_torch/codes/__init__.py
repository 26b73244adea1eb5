"""PRN spreading-code generation (host-side, precomputed once per run).

Reference parity: src/algorithms/libs/gps_sdr_signal_processing.{h,cc},
galileo_e1_signal_processing.cc, gnss_signal_processing.cc.  GPS L1 C/A and
Galileo E1 B/C in this package: codes are generated from the public ICD
definitions (the E1 memory codes from codes/data/icd_tables.npz), emitted
as +-1 float arrays, then resampled / FFT'd per sampling rate by the
acquisition and tracking layers.  Pure NumPy — tiny, run once.
"""

from .galileo_e1 import (E1C_SECONDARY, galileo_e1_sinboc11,
                         galileo_e1b_code, galileo_e1c_code)
from .gps_l1ca import gps_l1ca_code
from .sampling import code_to_baseband, resample_code

__all__ = ["gps_l1ca_code", "galileo_e1b_code", "galileo_e1c_code",
           "galileo_e1_sinboc11", "E1C_SECONDARY", "resample_code",
           "code_to_baseband", "generate_code", "tracking_replica"]


def tracking_replica(signal_id: str, prn: int):
    """Local replica for acquisition/tracking: returns
    (samples, virtual_chip_rate, code_samples_per_chip).

    For BOC signals the replica carries the subcarrier: Galileo E1 uses
    sinBOC(1,1) at 2 samples/chip (the reference's default tracking replica,
    galileo_e1_code_gen_sinboc11_float), so the 'virtual' chip rate doubles.
    """
    chips = generate_code(signal_id, prn)
    if signal_id == "1B":
        return galileo_e1_sinboc11(chips), 2 * 1.023e6, 2
    from ..constants import SIGNALS

    return chips, SIGNALS[signal_id].code_rate_chips_s, 1


def generate_code(signal_id: str, prn: int):
    """(signal_id, prn) -> +-1 float32 chip array at 1 sample/chip."""
    if signal_id == "1C":
        return gps_l1ca_code(prn)
    if signal_id == "1B":
        return galileo_e1b_code(prn)
    raise NotImplementedError(
        f"signal {signal_id!r} is not ported yet (GPS L1 C/A '1C' and "
        f"Galileo E1B '1B' only)")
