"""Channel-decoder adapters: a uniform duck-typed interface for the receiver.

The receiver expects every telemetry decoder to expose
  push(prompt_i, start_samples), tow_at_symbol(idx), ephemeris,
  ephemeris_complete
(the Gnss_Synchro TOW-stamping contract of the reference's telemetry
blocks).  LnavDecoder implements it natively; these adapters wrap the other
signals' decoders: BeiDou B1I/B3I (D1/D2 NAV), GPS L2CM and L5I (CNAV),
GLONASS L1/L2 C/A (GNAV), Galileo E1B (I/NAV) and Galileo E5a-I (F/NAV).
"""

from __future__ import annotations

import numpy as np

from .inav import InavDecoder, to_keplerian


class BeidouChannelDecoder:
    """B1I (D1 NAV) channel: prompts arrive per 1 ms code period, modulated
    by the NH20 secondary code at 20 ms bit period.

    The adapter performs secondary-code sync (correlating prompt signs with
    NH20 over a sliding 20-epoch window), wipes NH, integrates to 20 ms
    bits and feeds DnavDecoder.  (The reference folds NH handling into
    tracking's extended-integration states; host-side wipe keeps the device
    loop branch-light.)
    """

    _NH = np.array([0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1,
                    1, 0], dtype=np.float64)
    _NH_AMP = 1.0 - 2.0 * _NH

    def __init__(self, prn: int):
        from .beidou_dnav import D2Decoder, DnavDecoder

        self.prn = prn
        # GEO satellites (PRN 1-5) broadcast D2 NAV at 500 sps with no NH
        # modulation; MEO/IGSO broadcast D1 at 50 bps under NH20
        # (beidou_b1i_telemetry_decoder_gs.cc:317-345 set_satellite)
        self.is_geo = 1 <= prn <= 5
        self._dec = D2Decoder(prn) if self.is_geo else DnavDecoder(prn)
        # D2 symbol boundary is ambiguous at 1 ms epoch granularity: run
        # both 2-epoch integration phases until one achieves frame sync
        self._d2_alt = D2Decoder(prn) if self.is_geo else None
        self._d2_phase: int | None = None
        self._buf: list[float] = []
        self._nh_offset: int | None = None
        self._bit_symbol0: int | None = None

    def push(self, prompt_i, start_samples=None) -> None:
        self._buf.extend(np.asarray(prompt_i, dtype=np.float64))
        if self.is_geo:
            self._push_d2()
            return
        if self._nh_offset is None:
            self._sync_nh()
        if self._nh_offset is None:
            return
        # consume whole NH periods into bits
        p = np.asarray(self._buf)
        usable = (len(p) - self._nh_offset) // 20
        if usable <= 0:
            return
        seg = p[self._nh_offset : self._nh_offset + usable * 20]
        bits = (seg.reshape(usable, 20) * self._NH_AMP[None, :]).sum(axis=1)
        self._dec.push(bits)
        self._nh_offset += usable * 20

    def _push_d2(self) -> None:
        p = np.asarray(self._buf)
        if self._d2_phase is None:
            # feed both phases from scratch each call until one syncs
            # (cheap: D2Decoder.push is incremental, so re-create lazily)
            for phase, dec in ((0, self._dec), (1, self._d2_alt)):
                n = (len(p) - phase) // 2
                fed = getattr(dec, "_fed", 0)
                if n > fed:
                    seg = p[phase + fed * 2 : phase + n * 2]
                    dec.push(seg.reshape(-1, 2).sum(axis=1))
                    dec._fed = n
            if self._dec.frame_sync:
                self._d2_phase = 0
                self._bit_symbol0 = 0
            elif self._d2_alt.frame_sync:
                self._dec = self._d2_alt
                self._d2_phase = 1
                self._bit_symbol0 = 1
            return
        phase = self._d2_phase
        n = (len(p) - phase) // 2
        fed = getattr(self._dec, "_fed", 0)
        if n > fed:
            seg = p[phase + fed * 2 : phase + n * 2]
            self._dec.push(seg.reshape(-1, 2).sum(axis=1))
            self._dec._fed = n

    def _sync_nh(self) -> None:
        p = np.asarray(self._buf)
        if len(p) < 80:
            return
        s = np.sign(p)
        best, best_off = 0.0, None
        for off in range(20):
            n = (len(p) - off) // 20
            if n < 3:
                continue
            w = s[off : off + n * 20].reshape(n, 20)
            c = np.abs((w * self._NH_AMP[None, :]).sum(axis=1)).mean()
            if c > best:
                best, best_off = c, off
        if best_off is not None and best > 16.0:   # dominant NH alignment
            self._nh_offset = best_off
            self._bit_symbol0 = best_off

    @property
    def sec_sync_offset(self) -> int | None:
        """Epoch index (mod 20) of the NH20 boundary once synced — the
        receiver uses it to align the engine's extended-coherent window and
        in-loop wipe-off phase.  GEO (D2) carries no NH code: always None so
        the receiver keeps the channel in wide tracking."""
        if self.is_geo:
            return None
        return None if self._bit_symbol0 is None else self._bit_symbol0 % 20

    def tow_at_symbol(self, symbol_idx: int):
        """SOW at a 1 ms epoch index (D1 bits advance 20 ms, D2 symbols
        2 ms)."""
        if self._bit_symbol0 is None:
            return None
        per = 2.0 if self.is_geo else 20.0
        bit_idx = (symbol_idx - self._bit_symbol0) / per
        sow = self._dec.sow_at_symbol(int(np.floor(bit_idx)))
        if sow is None:
            return None
        frac = bit_idx - np.floor(bit_idx)
        return sow + per * 1e-3 * frac

    @property
    def ephemeris(self):
        return self._dec.ephemeris

    @property
    def iono(self):
        return self._dec.iono

    @property
    def ephemeris_complete(self) -> bool:
        # subframes 1-3 decoded (beidou_dnav_navigation_message.cc
        # have_new_ephemeris gating)
        return self._dec.ephemeris_complete

    @property
    def raw(self):
        return self._dec


class GpsL2ChannelDecoder:
    """L2CM (CNAV) channel: the 20 ms code period IS the CNAV symbol, so
    prompts feed the Viterbi/message hunter directly
    (gps_l2c_telemetry_decoder_gs.cc symbol path).  Exposes the Keplerian
    conversion so the common PVT plane consumes the CNAV orbit."""

    def __init__(self, prn: int):
        from .cnav import CnavDecoder

        self.prn = prn
        self._dec = CnavDecoder(prn)

    def push(self, prompt_i, start_samples=None) -> None:
        self._dec.push(np.asarray(prompt_i, dtype=np.float64))

    def tow_at_symbol(self, symbol_idx: int):
        return self._dec.tow_at_symbol(symbol_idx)

    @property
    def iono(self):
        return self._dec.iono

    @property
    def ephemeris(self):
        return self._dec.ephemeris.to_keplerian()

    @property
    def ephemeris_complete(self) -> bool:
        return self._dec.ephemeris_complete

    @property
    def raw(self):
        return self._dec


class GlonassChannelDecoder:
    """GLONASS L1/L2 C/A channel: prompts per 1 ms code period; GNAV
    symbols are 10 ms meander half-bits, so 10-epoch sums feed GnavDecoder.
    The 10 ms boundary phase is found by maximizing sign stability."""

    def __init__(self, slot: int):
        self.slot = slot
        from .gnav import GnavDecoder

        self._dec = GnavDecoder(slot)
        self._buf: list[float] = []
        self._phase: int | None = None   # consume pointer (advances by 10s)
        self._phase0: int | None = None  # 10 ms boundary offset at sync

    def push(self, prompt_i, start_samples=None) -> None:
        self._buf.extend(np.asarray(prompt_i, dtype=np.float64))
        if self._phase is None:
            self._sync_phase()
        if self._phase is None:
            return
        p = np.asarray(self._buf)
        usable = (len(p) - self._phase) // 10
        if usable <= 0:
            return
        seg = p[self._phase : self._phase + usable * 10]
        self._dec.push(seg.reshape(usable, 10).sum(axis=1))
        self._phase += usable * 10

    def _sync_phase(self) -> None:
        p = np.asarray(self._buf)
        if len(p) < 200:
            return
        s = np.sign(p)
        flips = np.nonzero(s[1:] * s[:-1] < 0)[0] + 1
        if len(flips) < 8:
            return
        hist = np.bincount(flips % 10, minlength=10)
        best = int(np.argmax(hist))
        if hist[best] >= 0.6 * len(flips):
            self._phase = best
            self._phase0 = best

    def tow_at_symbol(self, symbol_idx: int):
        """GLONASS tod at a 1 ms epoch index.  Uses the sync-time boundary
        offset (_phase0) — _phase itself advances as the consume pointer,
        and the GnavDecoder's symbol counter starts at the first consumed
        10 ms sum."""
        if self._phase0 is None:
            return None
        sym10 = (symbol_idx - self._phase0) / 10.0
        tod = self._dec.tod_at_symbol(int(np.floor(sym10)))
        if tod is None:
            return None
        return tod + 0.01 * (sym10 - np.floor(sym10))

    @property
    def ephemeris(self):
        return self._dec.ephemeris

    @property
    def ephemeris_complete(self) -> bool:
        return self._dec.ephemeris_complete

    @property
    def raw(self):
        return self._dec


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


class GpsL5ChannelDecoder:
    """L5I (CNAV) channel: prompts arrive per 1 ms code period, modulated by
    the NH10 secondary code; one 10 ms CNAV symbol per NH10 period
    (100 sps).  Mirrors gps_l5_telemetry_decoder_gs.cc with the NH sync
    host-side like the BeiDou NH20 adapter."""

    def __init__(self, prn: int):
        from ..codes.gps_l5 import NH10
        from .cnav import CnavDecoder

        self.prn = prn
        self._nh = np.asarray(NH10, dtype=np.float64)
        self._dec = CnavDecoder(prn)
        self._dec.symbol_period_s = 0.01
        self._buf: list[float] = []
        self._offset: int | None = None
        self._sym_epoch0: int | None = None

    def push(self, prompt_i, start_samples=None) -> None:
        self._buf.extend(np.asarray(prompt_i, dtype=np.float64))
        if self._offset is None:
            self._sync_secondary()
        if self._offset is None:
            return
        p = np.asarray(self._buf)
        usable = (len(p) - self._offset) // 10
        if usable <= 0:
            return
        seg = p[self._offset : self._offset + usable * 10]
        syms = (seg.reshape(usable, 10) * self._nh[None, :]).sum(axis=1)
        self._dec.push(syms)
        self._offset += usable * 10

    def _sync_secondary(self) -> None:
        p = np.asarray(self._buf)
        if len(p) < 40:
            return
        s = np.sign(p)
        best, best_off = 0.0, None
        for off in range(10):
            n = (len(p) - off) // 10
            if n < 3:
                continue
            w = s[off : off + n * 10].reshape(n, 10)
            c = np.abs((w * self._nh[None, :]).sum(axis=1)).mean()
            if c > best:
                best, best_off = c, off
        if best_off is not None and best > 8.0:
            self._offset = best_off
            self._sym_epoch0 = best_off

    @property
    def sec_sync_offset(self) -> int | None:
        """Epoch index (mod 10) of the NH10 boundary once synced."""
        return None if self._sym_epoch0 is None else self._sym_epoch0 % 10

    def tow_at_symbol(self, symbol_idx: int):
        """TOW at a 1 ms epoch index (symbols advance 10 ms each)."""
        if self._sym_epoch0 is None:
            return None
        sym_idx = (symbol_idx - self._sym_epoch0) / 10.0
        tow = self._dec.tow_at_symbol(int(np.floor(sym_idx)))
        if tow is None:
            return None
        return tow + 0.01 * (sym_idx - np.floor(sym_idx))

    @property
    def iono(self):
        return self._dec.iono

    @property
    def ephemeris(self):
        return self._dec.ephemeris.to_keplerian()

    @property
    def ephemeris_complete(self) -> bool:
        return self._dec.ephemeris_complete

    @property
    def raw(self):
        return self._dec


class GalileoE5aChannelDecoder:
    """E5a-I (F/NAV) channel: prompts arrive per 1 ms primary-code period,
    modulated by the 20-chip CS20 secondary code (one 20 ms F/NAV symbol
    per CS20 period, 50 symbols/s).

    Mirrors the reference's E5a handling (dll_pll_veml_tracking secondary-
    code sync + galileo_telemetry_decoder_gs F/NAV branch) with the
    secondary wipe done host-side like the BeiDou NH20 adapter.
    """

    def __init__(self, prn: int):
        from ..codes.galileo_e5 import galileo_e5ai_secondary
        from .fnav import FnavDecoder

        self.prn = prn
        self._cs20 = np.asarray(galileo_e5ai_secondary(), dtype=np.float64)
        self._dec = FnavDecoder(prn)
        self._buf: list[float] = []
        self._offset: int | None = None
        self._sym_epoch0: int | None = None

    def push(self, prompt_i, start_samples=None) -> None:
        self._buf.extend(np.asarray(prompt_i, dtype=np.float64))
        if self._offset is None:
            self._sync_secondary()
        if self._offset is None:
            return
        p = np.asarray(self._buf)
        usable = (len(p) - self._offset) // 20
        if usable <= 0:
            return
        seg = p[self._offset : self._offset + usable * 20]
        syms = (seg.reshape(usable, 20) * self._cs20[None, :]).sum(axis=1)
        self._dec.push(syms)
        self._offset += usable * 20

    def _sync_secondary(self) -> None:
        p = np.asarray(self._buf)
        if len(p) < 80:
            return
        s = np.sign(p)
        best, best_off = 0.0, None
        for off in range(20):
            n = (len(p) - off) // 20
            if n < 3:
                continue
            w = s[off : off + n * 20].reshape(n, 20)
            c = np.abs((w * self._cs20[None, :]).sum(axis=1)).mean()
            if c > best:
                best, best_off = c, off
        if best_off is not None and best > 16.0:
            self._offset = best_off
            self._sym_epoch0 = best_off

    @property
    def sec_sync_offset(self) -> int | None:
        """Epoch index (mod 20) of the CS20 boundary once synced."""
        return None if self._sym_epoch0 is None else self._sym_epoch0 % 20

    def tow_at_symbol(self, symbol_idx: int):
        """GST TOW at a 1 ms epoch index (symbols advance 20 ms each)."""
        if self._sym_epoch0 is None:
            return None
        sym_idx = (symbol_idx - self._sym_epoch0) / 20.0
        tow = self._dec.tow_at_symbol(int(np.floor(sym_idx)))
        if tow is None:
            return None
        return tow + 0.02 * (sym_idx - np.floor(sym_idx))

    @property
    def ephemeris(self):
        return to_keplerian(self._dec.ephemeris)

    @property
    def ephemeris_complete(self) -> bool:
        return self._dec.ephemeris_complete

    @property
    def raw(self):
        return self._dec
