"""Channel-decoder adapters: a uniform duck-typed interface for the receiver.

The receiver expects every telemetry decoder to expose
  push(prompt_i, start_samples), tow_at_symbol(idx), ephemeris,
  ephemeris_complete
(the Gnss_Synchro TOW-stamping contract of the reference's telemetry
blocks).  LnavDecoder implements it natively; these adapters wrap the other
constellations' decoders.  This package carries the Galileo E1B (I/NAV)
adapter; the others wait for their signals' decoders.
"""

from __future__ import annotations

import numpy as np

from .inav import InavDecoder, to_keplerian


class GalileoChannelDecoder:
    """E1B channel: one prompt per 4 ms epoch = one I/NAV symbol.

    TOW semantics: I/NAV GST TOW anchors at a word-5 page start; Galileo
    system time is steered to GPS time (GGTO < 50 ns), so the Keplerian
    conversion feeds the common solver with a per-system bias absorbed by
    the receiver clock / ISB state.
    """

    def __init__(self, prn: int):
        self.prn = prn
        self._dec = InavDecoder(prn)

    def push(self, prompt_i, start_samples=None) -> None:
        self._dec.push(np.asarray(prompt_i, dtype=np.float64))

    def tow_at_symbol(self, symbol_idx: int):
        return self._dec.tow_at_symbol(symbol_idx)

    @property
    def ephemeris(self):
        return to_keplerian(self._dec.ephemeris)

    @property
    def ephemeris_complete(self) -> bool:
        return self._dec.ephemeris_complete and 5 in self._dec.words

    @property
    def raw(self) -> InavDecoder:
        return self._dec
