"""PRN spreading-code generation (host-side, precomputed once per run).

Reference parity: src/algorithms/libs/gps_sdr_signal_processing.{h,cc},
gps_l2c_signal.cc, gps_l5_signal.cc, galileo_e1_signal_processing.cc,
galileo_e5_signal_processing.cc, glonass_l{1,2}_signal_processing.cc,
beidou_b{1,3}i_signal_processing.cc, gnss_signal_processing.cc.  GPS L1
C/A, L2CM and L5 I/Q, Galileo E1 B/C and E5a I/Q, the GLONASS C/A code and
BeiDou B1I/B3I in this package: codes are generated from the public ICD
definitions (the memory codes and the L2CM/L5/B3I register states from
codes/data/icd_tables.npz), emitted as +-1 float arrays, then resampled /
FFT'd per sampling rate by the acquisition and tracking layers.  Pure
NumPy — tiny, run once.
"""

from .beidou import BEIDOU_NH20, beidou_b1i_code, beidou_b3i_code
from .galileo_e1 import (E1C_SECONDARY, galileo_e1_sinboc11,
                         galileo_e1b_code, galileo_e1c_code)
from .galileo_e5 import galileo_e5ai_code, galileo_e5aq_code
from .glonass import glonass_ca_code
from .gps_l1ca import gps_l1ca_code
from .gps_l2c import gps_l2cm_code
from .gps_l5 import NH10, NH20, gps_l5i_code, gps_l5q_code
from .sampling import code_to_baseband, resample_code

__all__ = ["gps_l1ca_code", "gps_l2cm_code", "gps_l5i_code", "gps_l5q_code",
           "NH10", "NH20", "galileo_e1b_code", "galileo_e1c_code",
           "galileo_e1_sinboc11", "E1C_SECONDARY", "galileo_e5ai_code",
           "galileo_e5aq_code", "glonass_ca_code", "beidou_b1i_code",
           "beidou_b3i_code", "BEIDOU_NH20", "resample_code",
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
    if signal_id == "2S":
        return gps_l2cm_code(prn)
    if signal_id == "L5":
        return gps_l5i_code(prn)
    if signal_id == "1B":
        return galileo_e1b_code(prn)
    if signal_id == "5X":
        return galileo_e5ai_code(prn)
    if signal_id in ("1G", "2G"):
        return glonass_ca_code()
    if signal_id == "B1":
        return beidou_b1i_code(prn)
    if signal_id == "B3":
        return beidou_b3i_code(prn)
    raise ValueError(f"unknown signal id {signal_id!r}")
