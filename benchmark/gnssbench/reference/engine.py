"""The benchmark's plain reference of one tracking segment.

It rebuilds, from the configuration alone, what the port's tracking engine
derives at set-up (the loop-filter constants, the shifted-replica table,
the chunk and gather geometry), activates channels as the port's
`activate_channel` / `enable_extended` do, packs a loop state into the
chain's rows, walks a segment with the frozen plain copies (`corr`,
`chain`, `gather`) and reduces it onto the symbol grid.  It imports nothing
of the port: the expressions are copies of `track/engine.py`,
`track/loop_filter.py` and `track/config.py`.

A state here is the pair of row matrices (fst [SF, C] float32, ist [SI, C]
int32) plus the channels' code slots; `pack` builds it from a dict of
numpy arrays laid out as the port's TrackState fields, so the reference can
start from a state that the program handed over.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import chain as tc
from . import corr as cc
from . import gather as gb

_F32 = torch.float32
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """The tracking constants of one receiver (the port's TrackConfig)."""

    fs_hz: float
    code_length_chips: int
    chip_rate_chips_s: float
    carrier_freq_hz: float
    n_channels: int
    code_samples_per_chip: int
    pll_bw_hz: float
    dll_bw_hz: float
    pll_bw_narrow_hz: float
    dll_bw_narrow_hz: float
    extend_correlation_symbols: int
    early_late_space_chips: float
    very_early_late_space_chips: float
    veml: bool
    correlator: str                     # chunked | gather
    chunk_epochs: int = 16
    pll_filter_order: int = 3
    dll_filter_order: int = 2
    enable_fll_pull_in: bool = False
    fll_bw_hz: float = 35.0
    fll_bw_narrow_hz: float = 8.0
    fll_narrow_windows: int = 20
    pull_in_time_s: float = 0.3
    cn0_samples: int = 20
    cn0_min_dbhz: float = 25.0
    max_lock_fail: int = 50
    carrier_lock_th: float = 0.85
    sec_data: bool = False

    @property
    def samples_per_code(self) -> float:
        return self.fs_hz * self.code_length_chips / self.chip_rate_chips_s

    @property
    def epoch_samples_max(self) -> int:
        return int(math.floor(self.samples_per_code * (1.0 + 1e-4))) + 2

    @property
    def code_period_s(self) -> float:
        return self.code_length_chips / self.chip_rate_chips_s

    @property
    def n_taps(self) -> int:
        return 5 if self.veml else 3

    def tap_shifts_chips(self) -> list[float]:
        el = self.early_late_space_chips
        if self.veml:
            vl = self.very_early_late_space_chips
            return [-vl, -el, 0.0, el, vl]
        return [-el, 0.0, el]

    @property
    def prompt_index(self) -> int:
        return 2 if self.veml else 1


def iir_coefficients(bn: float, t: float, order: int):
    """The DLL's bilinear IIR constants (no last integrator), float32."""
    zeta = 1.0 / math.sqrt(2.0)
    b_in = np.zeros(4, dtype=np.float64)
    b_out = np.zeros(3, dtype=np.float64)
    if order == 1:
        b_in[0] = bn * 4.0
    elif order == 2:
        wn = bn * (8.0 * zeta) / (4.0 * zeta * zeta + 1.0)
        g1, g2 = wn * wn, wn * 2.0 * zeta
        b_in[0] = g1 * t / 2.0 + g2
        b_in[1] = g1 * t / 2.0 - g2
        b_out[0] = 1.0
    else:
        wn = bn / 0.7845
        g1, g2, g3 = wn ** 3, 1.1 * wn * wn, 2.4 * wn
        b_in[0] = g3 + t / 2.0 * (g2 + t / 2.0 * g1)
        b_in[1] = g1 * t * t / 2.0 - 2.0 * g3
        b_in[2] = g3 + t / 2.0 * (-g2 + t / 2.0 * g1)
        b_out[0] = 2.0
        b_out[1] = -1.0
    return b_in.astype(np.float32), b_out.astype(np.float32)


def fll_pll_coefficients(fll_bw_hz: float, pll_bw_hz: float, order: int):
    """(order, w0p, w0p2, w0p3, w0f, w0f2, a2, a3, b3) of the FLL-assisted
    PLL (Tracking_FLL_PLL_filter::set_params)."""
    if order == 3:
        w0p, w0f = pll_bw_hz / 0.7845, fll_bw_hz / 0.53
        return (3, w0p, w0p * w0p, w0p ** 3, w0f, w0f * w0f, 1.414, 1.100,
                2.400)
    w0p, w0f = pll_bw_hz / 0.53, fll_bw_hz / 0.25
    return (2, w0p, w0p * w0p, 0.0, w0f, 0.0, 1.414, 0.0, 0.0)


def _f32(v) -> float:
    return float(np.float32(v))


class ReferenceEngine:
    """The plain walk of one receiver's tracking, on any device."""

    def __init__(self, cfg: TrackConfig, codes: np.ndarray, device="cpu"):
        self.cfg = cfg
        dev = self.device = torch.device(device)
        self.codes_np = np.asarray(codes, np.float32)
        self.sec = torch.ones((1, cfg.n_channels), dtype=_F32, device=dev)
        w = fll_pll_coefficients(cfg.fll_bw_hz, cfg.pll_bw_hz,
                                 cfg.pll_filter_order)
        n = fll_pll_coefficients(cfg.fll_bw_narrow_hz, cfg.pll_bw_narrow_hz,
                                 cfg.pll_filter_order)
        self.order = w[0]
        b_in, b_out = iir_coefficients(cfg.dll_bw_hz, cfg.code_period_s,
                                       cfg.dll_filter_order)
        b_in_n, b_out_n = iir_coefficients(
            cfg.dll_bw_narrow_hz,
            cfg.code_period_s * cfg.extend_correlation_symbols,
            cfg.dll_filter_order)
        t0 = float(cfg.samples_per_code)
        self.t0_int = int(np.floor(t0))
        self.t0_frac = float(t0 - self.t0_int)
        lag_margin = 16
        E = self.E = cfg.chunk_epochs if cfg.correlator == "chunked" else 4
        self.grid_pad = E + 4
        drift = 2 * E + 10
        self.corr_win = cfg.epoch_samples_max + drift
        a0 = cfg.chip_rate_chips_s * cfg.code_samples_per_chip / cfg.fs_hz
        lv = self.codes_np.shape[1]
        spc_samples = cfg.fs_hz / cfg.chip_rate_chips_s
        max_shift = max(abs(s) for s in cfg.tap_shifts_chips())
        LW = self.lag_window = int(np.ceil(lag_margin + drift + 4
                                           + max_shift * spc_samples)) + 4
        NW = self.corr_win
        if cfg.correlator == "chunked":
            m = np.arange(-(LW - 1), NW)
            chip_idx = np.floor(a0 * (m + lag_margin)).astype(np.int64)
            rows = np.zeros((self.codes_np.shape[0],
                             -(-(LW - 1 + NW) // 4) * 4), np.float32)
            rows[:, :LW - 1 + NW] = self.codes_np[:, np.mod(chip_idx, lv)]
            self.rows = torch.as_tensor(rows, device=dev)
            self.corr_spec = cc.CorrSpec(
                E=E, LW=LW, NW=NW, C=cfg.n_channels, t0_int=self.t0_int,
                t0_frac=self.t0_frac, grid_pad=self.grid_pad,
                chip_rate=float(cfg.chip_rate_chips_s), fs=float(cfg.fs_hz),
                passes=2)
        else:
            self.codes = torch.as_tensor(self.codes_np, device=dev)
            self.win = cfg.epoch_samples_max + self.t0_int + 66
        self.fll_epochs = int(round(cfg.pull_in_time_s / cfg.code_period_s))
        self.chain_spec = tc.ChainSpec(
            E=E, LW=LW, K=cfg.n_taps, C=cfg.n_channels, sec_len=1,
            prompt_index=cfg.prompt_index, veml=cfg.veml,
            sec_data=cfg.sec_data, lag_margin=float(lag_margin),
            spc_samples=float(spc_samples),
            shifts_chips=tuple(float(s) for s in cfg.tap_shifts_chips()),
            fs=float(cfg.fs_hz), chip_rate=float(cfg.chip_rate_chips_s),
            carrier_freq=float(cfg.carrier_freq_hz),
            t0_int=self.t0_int, t0_frac=self.t0_frac,
            code_period_s=float(cfg.code_period_s),
            ext_n=int(cfg.extend_correlation_symbols),
            cn0_samples=int(cfg.cn0_samples),
            cn0_min_dbhz=float(cfg.cn0_min_dbhz),
            carrier_lock_th=float(cfg.carrier_lock_th),
            max_lock_fail=int(cfg.max_lock_fail),
            fll_narrow_windows=int(cfg.fll_narrow_windows),
            fll_epochs=self.fll_epochs, order=int(w[0]),
            wide=tuple(w[1:]), narrow=tuple(n[1:]),
            dll_b_in=tuple(float(v) for v in b_in),
            dll_b_in_n=tuple(float(v) for v in b_in_n),
            dll_b_out=tuple(float(v) for v in b_out),
            dll_b_out_n=tuple(float(v) for v in b_out_n))
        if cfg.correlator == "gather":
            spc = cfg.code_samples_per_chip
            self.gather_spec = gb.GatherSpec(
                loop=self.chain_spec, n_max=cfg.epoch_samples_max,
                win=self.win, code_len=self.codes_np.shape[1],
                shifts=tuple(float(np.float32(s) * np.float32(spc))
                             for s in cfg.tap_shifts_chips()),
                spc=float(spc))

    # ------------------------------------------------------------ state

    def fields(self) -> dict:
        """A fresh state as a dict of numpy arrays (TrackState's fields)."""
        C, K = self.cfg.n_channels, self.cfg.n_taps
        z = np.zeros(C, np.float32)
        zi = np.zeros(C, np.int32)
        zb = np.zeros(C, bool)
        zc = np.zeros(C, np.complex64)
        return dict(
            active=zb.copy(), prn_slot=zi.copy(), start=zi.copy(),
            cur_len=np.full(C, self.t0_int, np.int32),
            rem_code_phase_samples=z.copy(), code_freq_delta=z.copy(),
            carrier_doppler_hz=z.copy(), rem_carr_phase_rad=z.copy(),
            carr_w=z.copy(), carr_x=z.copy(),
            dll_inputs=np.zeros((C, 3), np.float32),
            dll_outputs=np.zeros((C, 3), np.float32),
            prev_prompt=zc.copy(), s_absi=z.copy(), s_i2=z.copy(),
            s_q2=z.copy(), cn0_last=z.copy(), push_count=zi.copy(),
            lock_fail=zi.copy(), epochs_in_track=zi.copy(), fll_on=zb.copy(),
            mode=zi.copy(), ext_cnt=zi.copy(),
            acc_corr=np.zeros((C, K), np.complex64), acc_half=zc.copy(),
            sec_on=zb.copy(), sec_idx=zi.copy(), carr_offset_hz=z.copy())

    def activate(self, s: dict, ch: int, slot: int, delay_samples: float,
                 doppler_hz: float) -> None:
        """Pull-in at sample 0 from a delay and a Doppler (the port's
        activate_channel with acq_samplestamp = block_start_abs = 0)."""
        cfg = self.cfg
        code_freq = (1.0 + doppler_hz / cfg.carrier_freq_hz) \
            * cfg.chip_rate_chips_s
        t_prn = cfg.fs_hz * cfg.code_length_chips / code_freq
        boundary = float(delay_samples)
        k = max(0.0, np.ceil((0.0 - boundary) / t_prn))
        start_rel = boundary + k * t_prn
        start_i = int(np.floor(start_rel))
        rem = float(start_rel - start_i)
        w0, x0 = ((0.0, 2.0 * doppler_hz) if self.order == 3
                  else (doppler_hz, 0.0))
        for name in s:
            s[name][ch] = 0
        s["active"][ch] = True
        s["prn_slot"][ch] = slot
        s["start"][ch] = start_i
        s["cur_len"][ch] = int(np.floor(t_prn + rem))
        s["rem_code_phase_samples"][ch] = rem
        s["code_freq_delta"][ch] = code_freq - cfg.chip_rate_chips_s
        s["carrier_doppler_hz"][ch] = doppler_hz
        s["carr_w"][ch], s["carr_x"][ch] = w0, x0
        s["fll_on"][ch] = bool(cfg.enable_fll_pull_in)

    def enable_extended(self, s: dict, ch: int,
                        epochs_to_boundary: int) -> None:
        """States 3/4 (the port's enable_extended, no secondary wipe)."""
        n = self.cfg.extend_correlation_symbols
        e = int(epochs_to_boundary) % n or n
        d = np.float32(s["carrier_doppler_hz"][ch])
        w0, x0 = ((0.0, np.float32(2.0) * d) if self.order == 3
                  else (d, 0.0))
        s["mode"][ch] = 1
        s["ext_cnt"][ch] = n - e
        for name in ("acc_corr", "acc_half", "s_absi", "s_i2", "s_q2",
                     "push_count", "lock_fail", "dll_inputs"):
            s[name][ch] = 0
        s["fll_on"][ch] = self.cfg.fll_narrow_windows > 0
        s["carr_w"][ch], s["carr_x"][ch] = w0, x0

    def pack(self, s: dict, limit: int):
        """A state dict -> (fst, ist, slot) in the chain's row order."""
        K = self.cfg.n_taps
        f = lambda v: np.asarray(v, np.float32)     # noqa: E731
        pp, ah = np.asarray(s["prev_prompt"]), np.asarray(s["acc_half"])
        acc = np.asarray(s["acc_corr"])
        rows = [s["rem_code_phase_samples"], s["code_freq_delta"],
                s["carrier_doppler_hz"], s["rem_carr_phase_rad"],
                s["carr_w"], s["carr_x"], pp.real, pp.imag, s["s_absi"],
                s["s_i2"], s["s_q2"], s["cn0_last"], ah.real, ah.imag,
                s["carr_offset_hz"]]
        rows += [np.asarray(s["dll_inputs"])[:, j] for j in range(3)]
        rows += [np.asarray(s["dll_outputs"])[:, j] for j in range(3)]
        rows += [acc[:, k].real for k in range(K)]
        rows += [acc[:, k].imag for k in range(K)]
        fst = np.stack([f(r) for r in rows])
        irows = [s["active"], s["start"], s["cur_len"], s["push_count"],
                 s["lock_fail"], s["epochs_in_track"], s["fll_on"],
                 s["mode"], s["ext_cnt"], s["sec_on"], s["sec_idx"],
                 np.full(self.cfg.n_channels, limit)]
        ist = np.stack([np.asarray(r).astype(np.int32) for r in irows])
        dev = self.device
        return (torch.as_tensor(fst, device=dev),
                torch.as_tensor(ist, device=dev),
                torch.as_tensor(np.asarray(s["prn_slot"], np.int32),
                                device=dev))

    # ------------------------------------------------------------ walk

    def n_epochs(self, span: int) -> int:
        """Epochs a segment call walks (the port's _check_capture)."""
        return -(-(span // (self.t0_int - 2) + 2) // self.E) * self.E

    def walk(self, samples: torch.Tensor, fst, ist, slot, span: int,
             lowp=None):
        """Every epoch that starts in [0, span) of a segment whose limit row
        is already `span`: (out_f [n, 7, C], out_i [n, 2, C],
        out_corr [n, 2K, C], fst', ist')."""
        n_ep = self.n_epochs(span)
        samples = samples.to(self.device, torch.complex64)
        if self.cfg.correlator == "gather":
            return gb.gather_block_plain(
                self.gather_spec, samples, self.codes[slot.long()],
                self.sec, fst, ist, n_ep, lowp=lowp)
        E = self.E
        seg_len = (E - 1) * self.t0_int + self.corr_win
        pad = max(0, seg_len + self.grid_pad - self.cfg.epoch_samples_max,
                  seg_len - samples.shape[0])
        if pad:
            samples = torch.cat([samples, torch.zeros(
                pad, dtype=samples.dtype, device=samples.device)])
        cspec, hspec = self.corr_spec, self.chain_spec
        C, K = cspec.C, hspec.K
        n_chunks = n_ep // E
        out_f = torch.empty((n_ep, tc.N_OROWS, C), dtype=_F32,
                            device=self.device)
        out_i = torch.empty((n_ep, 2, C), dtype=_I32, device=self.device)
        out_corr = torch.empty((n_ep, 2 * K, C), dtype=_F32,
                               device=self.device)
        bank_t = cc.replica_bank(cspec, self.rows, slot)
        for i in range(n_chunks):
            zr, zi, s_reg, step0 = cc.correlate_plain(
                cspec, samples, bank_t, fst, ist, lowp=lowp)
            of, oi, oc, fst, ist = tc.chain_plain(
                hspec, zr, zi, s_reg, step0, self.sec, fst, ist)
            out_f[i * E:(i + 1) * E] = of
            out_i[i * E:(i + 1) * E] = oi
            out_corr[i * E:(i + 1) * E] = oc
        return out_f, out_i, out_corr, fst, ist

    # ------------------------------------------------------------ symbols

    def symbol_outputs(self, out_f, out_i, out_corr, entering_rem, sym_off,
                       N: int) -> dict:
        """The symbol-grid reduction of a segment's rows (the port's
        _symbol_outputs): slot sums of the prompt and the valid count, the
        loop-state picks entering each slot, numpy [S, C] each."""
        dev = out_f.device
        cap, _, C = out_f.shape
        S = cap // N + 2
        p, K = self.cfg.prompt_index, self.cfg.n_taps
        v = out_f[:, tc.O_VALID]
        fields = torch.stack([out_corr[:, p] * v, out_corr[:, K + p] * v, v],
                             dim=-1)
        P = S * N
        fields = torch.cat([fields, torch.zeros((P - cap, C, 3), dtype=_F32,
                                                device=dev)])
        b0 = torch.as_tensor(np.asarray(sym_off, np.int64), device=dev)
        rows = torch.arange(P, device=dev)[:, None]
        src = torch.remainder(rows - (N - b0)[None, :], P)
        rolled = torch.gather(fields, 0, src[..., None].expand(P, C, 3))
        slots = rolled.reshape(S, N, C, 3)
        sums = slots[:, 0]
        for k in range(1, N):
            sums = sums + slots[:, k]
        sl = torch.arange(S, device=dev)[:, None]
        e_s = torch.clamp(b0[None, :] - N + sl * N, 0, cap - 1)
        em1 = torch.clamp(e_s - 1, 0, cap - 1)
        rem = out_f[:, tc.O_REM_CODE]
        prev = torch.cat([entering_rem.to(dev)[None], rem[:-1]])
        fracs = rem - torch.round(rem - prev)
        nv = v.sum(dim=0).to(torch.int64)
        last = torch.clamp(nv - 1, 0, cap - 1)

        def take(a, idx):
            return torch.gather(a, 0, idx).cpu().numpy()

        return dict(
            start=take(out_i[:, 0], e_s),
            mean_i=(sums[..., 0] * (1.0 / N)).cpu().numpy(),
            mean_q=(sums[..., 1] * (1.0 / N)).cpu().numpy(),
            frac=take(fracs, em1),
            rem_carr_phase_rad=take(out_f[:, tc.O_REM_CARR], em1),
            carrier_doppler_hz=take(out_f[:, tc.O_DOPPLER], em1),
            cn0_dbhz=take(out_f[:, tc.O_CN0], em1),
            code_freq_delta=take(out_f[:, tc.O_DELTA], em1),
            vcount=sums[..., 2].to(_I32).cpu().numpy(),
            n_valid=nv.to(_I32).cpu().numpy(),
            active=(out_f[:, tc.O_ACTIVE].gather(0, last[None])[0]
                    > 0.5).cpu().numpy())
