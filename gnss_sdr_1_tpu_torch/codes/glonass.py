"""GLONASS L1/L2 C/A code generation (GLONASS ICD 5.1, sec 3.3.2.2).

Reference parity: src/algorithms/libs/glonass_l{1,2}_signal_processing.cc.
All GLONASS satellites share one 511-chip m-sequence (satellites are separated
by FDMA carrier offsets, see constants.glonass_fdma_offset_hz); the sequence
is the output of stage 7 of a 9-stage shift register with feedback from
stages 5 and 9.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=4)
def glonass_ca_code() -> np.ndarray:
    """511-chip GLONASS C/A m-sequence, float32 {+1,-1}.

    Mapping matches the framework convention (binary 1 -> -1).  Note the
    reference (glonass_l1_signal_processing.cc:70) maps 1 -> +1; polarity is
    resolved by the telemetry meander stripping either way.
    """
    reg = [1] * 9              # reg[0] = newest (stage 1) .. reg[8] = stage 9
    out = np.empty(511, dtype=np.int64)
    for i in range(511):
        out[i] = reg[6]            # stage 7 output
        fb = reg[4] ^ reg[8]       # stages 5 and 9
        reg = [fb] + reg[:-1]
    return (1.0 - 2.0 * out).astype(np.float32)
