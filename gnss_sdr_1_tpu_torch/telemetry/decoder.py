"""GPS L1 C/A LNAV symbol-stream decoder (host, per channel).

Reference parity: gps_l1_ca_telemetry_decoder_gs.cc — preamble correlation
over the symbol history (:373-399), 2-state sync FSM, subframe decode +
parity via Gps_Navigation_Message (:200), TOW propagation into each
Gnss_Synchro (:330-364).  Differences by design: bit sync here uses a
sign-transition histogram over the prompt stream (the reference folds bit
sync into tracking's state 2->3 transition), and decoding is
polarity-invariant — the (32,26) parity code and the d XOR D30* rule make a
globally inverted stream decode identically, so the Costas 180-degree
ambiguity needs no special casing beyond the +-preamble search.

Timebase contract: each tracking epoch advances TRANSMIT time by exactly one
code period (1 ms) because tracking is code-locked; TOW at any epoch is
tow_ref + 1 ms * (epochs since the reference subframe boundary).
"""

from __future__ import annotations

import numpy as np

from .lnav import (GpsAlmanac, GpsEphemeris, GpsIono, GpsUtc, LNAV_PREAMBLE,
                   decode_subframe)

_SYMBOLS_PER_BIT = 20
_BITS_PER_SUBFRAME = 300
_MIN_TRANSITIONS = 10


class SymbolBatch:
    """Per-channel accumulator of (prompt_I, start_sample) epochs.

    Amortized-growth numpy buffers: the decoder re-reads the whole stream
    on every push (bit sums, preamble hunts), so list->array conversion
    per push was O(n^2) across a run."""

    def __init__(self) -> None:
        self._buf_i = np.empty(4096, dtype=np.float64)
        self._buf_s = np.empty(4096, dtype=np.int64)
        self._n = 0

    @property
    def prompt_i(self) -> np.ndarray:
        return self._buf_i[: self._n]

    @property
    def start_samples(self) -> np.ndarray:
        return self._buf_s[: self._n]

    def extend(self, prompt_i, start_samples) -> None:
        p = np.asarray(prompt_i, dtype=np.float64)
        s = np.asarray(start_samples, dtype=np.int64)
        m = len(p)
        while self._n + m > len(self._buf_i):
            self._buf_i = np.concatenate(
                [self._buf_i, np.empty(len(self._buf_i), np.float64)])
            self._buf_s = np.concatenate(
                [self._buf_s, np.empty(len(self._buf_s), np.int64)])
        self._buf_i[self._n : self._n + m] = p
        self._buf_s[self._n : self._n + m] = s
        self._n += m


class LnavDecoder:
    """Incremental LNAV decoder for one channel."""

    def __init__(self, prn: int = 0) -> None:
        self.prn = prn
        self._sym = SymbolBatch()
        self.bit_offset: int | None = None   # epoch index of first full bit
        self.frame_sync: bool = False
        self._frame_bit0: int | None = None  # bit index of first synced subframe
        self.ephemeris = GpsEphemeris(prn=prn)
        self.iono = GpsIono()
        self.utc = GpsUtc()
        self.almanacs: dict[int, "GpsAlmanac"] = {}  # sf4/5 pages, by SV id
        self.have_subframes: set[int] = set()
        # TOW anchored at a symbol index: tow_s at epoch `self._tow_symbol`
        self._tow_symbol: int | None = None
        self._tow_s: float | None = None
        self._decoded_until_bit = 0

    # ------------- feeding -------------

    def push(self, prompt_i, start_samples) -> None:
        self._sym.extend(prompt_i, start_samples)
        self._process()

    @property
    def n_symbols(self) -> int:
        return len(self._sym.prompt_i)

    def tow_at_symbol(self, symbol_idx: int) -> float | None:
        """TOW [s] at the START of epoch `symbol_idx` (code-locked 1 ms/epoch)."""
        if self._tow_s is None:
            return None
        return self._tow_s + 1e-3 * (symbol_idx - self._tow_symbol)

    def sample_at_symbol(self, symbol_idx: int) -> int:
        return self._sym.start_samples[symbol_idx]

    @property
    def ephemeris_complete(self) -> bool:
        return {1, 2, 3}.issubset(self.have_subframes)

    # ------------- processing -------------

    def _process(self) -> None:
        if self.bit_offset is None:
            self._try_bit_sync()
        if self.bit_offset is None:
            return
        bits = self._bits()
        if not self.frame_sync:
            self._try_frame_sync(bits)
        if self.frame_sync:
            self._decode_available(bits)

    def _try_bit_sync(self) -> None:
        p = np.asarray(self._sym.prompt_i)
        if len(p) < 200:
            return
        s = np.sign(p)
        flips = np.nonzero(s[1:] * s[:-1] < 0)[0] + 1   # epoch index of new bit
        if len(flips) < _MIN_TRANSITIONS:
            return
        hist = np.bincount(flips % _SYMBOLS_PER_BIT, minlength=_SYMBOLS_PER_BIT)
        best = int(np.argmax(hist))
        # require a dominant transition phase (tracking settled)
        if hist[best] < max(_MIN_TRANSITIONS, 0.6 * len(flips)):
            return
        self.bit_offset = best

    def _bits(self) -> np.ndarray:
        """0/1 bit stream from 20-symbol sums (bit 1 -> negative amplitude,
        matching the +-1 = 1-2b mapping used by the code/signal layer)."""
        p = np.asarray(self._sym.prompt_i)[self.bit_offset :]
        n_bits = len(p) // _SYMBOLS_PER_BIT
        sums = p[: n_bits * _SYMBOLS_PER_BIT].reshape(n_bits, _SYMBOLS_PER_BIT).sum(axis=1)
        return (sums < 0).astype(np.int64)

    def _try_frame_sync(self, bits: np.ndarray) -> None:
        if len(bits) < _BITS_PER_SUBFRAME + 2:
            return
        pre = LNAV_PREAMBLE
        for i in range(2, len(bits) - _BITS_PER_SUBFRAME):
            w = bits[i : i + 8]
            if not (np.array_equal(w, pre) or np.array_equal(w, 1 - pre)):
                continue
            d29s, d30s = int(bits[i - 2]), int(bits[i - 1])
            trial = GpsEphemeris(prn=self.prn)
            r = decode_subframe(bits[i : i + _BITS_PER_SUBFRAME], d29s, d30s, trial)
            if r is None:
                continue
            sf_id, tow_next = r
            self.frame_sync = True
            self._frame_bit0 = i
            self._decoded_until_bit = i
            # TOW anchor: next subframe starts at bit i+300 == symbol
            # bit_offset + 20*(i+300)
            self._tow_symbol = self.bit_offset + _SYMBOLS_PER_BIT * (i + _BITS_PER_SUBFRAME)
            self._tow_s = tow_next
            return

    def _decode_available(self, bits: np.ndarray) -> None:
        while len(bits) >= self._decoded_until_bit + _BITS_PER_SUBFRAME:
            i = self._decoded_until_bit
            d29s = int(bits[i - 2]) if i >= 2 else 0
            d30s = int(bits[i - 1]) if i >= 1 else 0
            r = decode_subframe(bits[i : i + _BITS_PER_SUBFRAME], d29s, d30s,
                                self.ephemeris, iono=self.iono, utc=self.utc,
                                almanacs=self.almanacs)
            if r is None:
                # parity slip: drop sync, re-search from the next bit
                self.frame_sync = False
                self._decoded_until_bit = 0
                return
            sf_id, tow_next = r
            self.have_subframes.add(sf_id)
            self._tow_symbol = self.bit_offset + _SYMBOLS_PER_BIT * (i + _BITS_PER_SUBFRAME)
            self._tow_s = tow_next
            self._decoded_until_bit += _BITS_PER_SUBFRAME
