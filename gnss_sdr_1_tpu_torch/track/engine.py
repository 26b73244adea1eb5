"""Channel-batched DLL/PLL tracking engine (PyTorch), chunked or gather.

Reference parity: dll_pll_veml_tracking.cc (src/algorithms/tracking/
gnuradio_blocks/).  Every channel advances in lock-step through integration
epochs; the channel lifecycle FSM (acquisition -> pull-in -> track -> drop)
lives on the host between capture segments, the device carries the
branch-light per-channel loop state.

Tracking states (reference general_work :1544-1900):
  state 1 pull-in       -> activate_channel (host)
  state 2 wide          -> mode 0: per-epoch loop closure, wide bandwidths
  state 3/4 narrow ext. -> mode 1 via enable_extended (host, after bit
                           sync): coherent accumulation over
                           extend_correlation_symbols epochs aligned to the
                           channel's bit grid, loop closed once per window
                           with the narrow bandwidths.

Two correlators (`TrackConfig.correlator`, its names mapped by
`tracking_correlator`).  Chunked (the default, the accelerator path):
`chunk_epochs` (E) epochs of every channel are sliced on the regular epoch
grid with the chunk-entry (frozen) NCO rates, wiped off, and correlated
against the per-slot shifted-replica bank, giving a lag window of LW lags
per epoch (ops.chunk_corr).  The tracking chain
(ops.track_chain) then runs the exact sequential per-epoch loop closure for
the chunk: it reads each epoch's taps from the lag window at the TRUE code
phase and rotates them by the known frozen-vs-true carrier phase
difference.  The chain's state crosses chunks as row-stacked matrices
(fst [SF, C] f32, ist [SI, C] i32).  On the card one C call enqueues both
kernels for every chunk of a capture segment (ops.track_capture); on the
CPU the same chunk loop runs in Python with the plain versions.

Gather (the JAX package's exact path off the TPU): every epoch slices its
window at the channel's own start and runs the per-sample floor code
resampler (A.2) before the same loop closure; on the card one gather_block
launch walks every epoch of a capture segment (ops.gather_block), on the
CPU its plain version walks them in Python.  It skips the capture padding
and the shifted-replica table.

Numerical contracts (SURVEY.md Appendix A): A.2 code resampling (on the lag
grid when chunked, exact when gathering), A.3 discriminators, A.4
carrier-aided code NCO, A.5 loop filters, A.6 split-precision NCO stepping
and variable block length, A.7 CN0 SNV estimator + carrier lock detector +
max_lock_fail.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import chunk_corr as cc
from ..ops import gather_block as gb
from ..ops import track_capture as tcap
from ..ops import track_chain as tc
from .config import TrackConfig
from .loop_filter import fll_pll_coefficients, iir_coefficients

_F32 = torch.float32
_I32 = torch.int32


class TrackState(NamedTuple):
    """Per-channel loop state carried across epochs and segments ([C])."""

    active: torch.Tensor            # bool — channel is tracking
    prn_slot: torch.Tensor          # int32 index into the code table
    start: torch.Tensor             # int32 next epoch start (segment-relative)
    cur_len: torch.Tensor           # int32 current integration length
    rem_code_phase_samples: torch.Tensor  # f32
    code_freq_delta: torch.Tensor   # f32 code_freq - chip_rate [chips/s]
    carrier_doppler_hz: torch.Tensor  # f32
    rem_carr_phase_rad: torch.Tensor  # f32
    carr_w: torch.Tensor            # f32 FLL-assisted PLL integrator w
    carr_x: torch.Tensor            # f32 FLL-assisted PLL integrator x
    dll_inputs: torch.Tensor        # f32 [C, 3] IIR input history
    dll_outputs: torch.Tensor       # f32 [C, 3] IIR output history
    prev_prompt: torch.Tensor       # complex64 — previous prompt (FLL)
    s_absi: torch.Tensor            # f32 sum |Re P| this CN0 window
    s_i2: torch.Tensor              # f32 sum Re^2 this window
    s_q2: torch.Tensor              # f32 sum Im^2 this window
    cn0_last: torch.Tensor          # f32 latest completed-window CN0 [dB-Hz]
    push_count: torch.Tensor        # int32 loop-closure prompts pushed
    lock_fail: torch.Tensor         # int32 consecutive lock failures
    epochs_in_track: torch.Tensor   # int32 epochs since pull-in
    fll_on: torch.Tensor            # bool — FLL pull-in transitory active
    mode: torch.Tensor              # int32 0=wide (state 2), 1=narrow
    ext_cnt: torch.Tensor           # int32 epochs in the current ext. window
    acc_corr: torch.Tensor          # complex64 [C, K] coherent accumulator
    acc_half: torch.Tensor          # complex64 prompt acc at mid-window
    sec_on: torch.Tensor            # bool — in-loop secondary wipe active
    sec_idx: torch.Tensor           # int32 secondary-code chip index
    carr_offset_hz: torch.Tensor    # f32 constant NCO carrier bias


class TrackOutputs(NamedTuple):
    """Per-epoch capture outputs (numpy, [n, C, ...]): the Gnss_Synchro
    tracking fields.  The loop-state fields rem_carr_phase_rad,
    carrier_doppler_hz, cn0_dbhz and code_freq_delta are exact only at
    epochs k % capture_decim == capture_decim - 1 (held in between)."""

    valid: np.ndarray               # bool — epoch processed
    start: np.ndarray               # int32 epoch start (segment-relative)
    cur_len: np.ndarray             # int32 samples integrated
    correlators: np.ndarray         # complex64 [n, C, K]
    carrier_doppler_hz: np.ndarray
    code_freq_delta: np.ndarray     # chips/s above nominal
    rem_code_phase_samples: np.ndarray   # code phase at NEXT epoch start
    rem_carr_phase_rad: np.ndarray       # carrier phase at NEXT epoch start
    cn0_dbhz: np.ndarray
    active: np.ndarray              # bool — still tracking after this epoch


class CaptureReadback(NamedTuple):
    """A launched capture segment's per-epoch rows on their way to the
    host (launch_capture -> harvest_capture).  On the card: pinned host
    tensors that a non_blocking copy fills, and the event recorded after
    that copy; on the CPU the rows themselves and no event."""

    out_f: torch.Tensor             # f32 [n, 7, C]
    out_i: torch.Tensor             # i32 [n, 2, C]
    correlators: torch.Tensor       # complex64 [n, C, K]
    event: torch.cuda.Event | None


class SymbolOutputs(NamedTuple):
    """Symbol-grid capture outputs ([S, C] each, numpy; S slots of `sym_n`
    epochs).  Slot 0 is the partial head finishing the previous segment's
    symbol; slots with vcount == sym_n are complete symbols."""

    start: np.ndarray        # i32 start sample of the slot's first epoch
    mean_i: np.ndarray       # f32 mean prompt I over the slot's epochs
    mean_q: np.ndarray       # f32 mean prompt Q
    frac: np.ndarray         # f32 pre-wrap rem_code fraction entering slot
    rem_carr_phase_rad: np.ndarray  # f32 NCO ledger entering the slot
    carrier_doppler_hz: np.ndarray
    cn0_dbhz: np.ndarray
    code_freq_delta: np.ndarray
    vcount: np.ndarray       # i32 valid epochs in the slot (<= sym_n)
    n_valid: np.ndarray      # i32 [C] total valid epochs this segment
    active: np.ndarray       # bool [C] channel still tracking at the end


def _set(t: torch.Tensor, ch: int, value) -> torch.Tensor:
    """Functional per-channel update (the state is never mutated in place,
    so a caller may keep an older state and replay from it)."""
    t = t.clone()
    t[ch] = value
    return t


# JAX TrackState leaf layout (planar [..., 2] complex) <-> port fields
_COMPLEX_FIELDS = ("prev_prompt", "acc_corr", "acc_half")


def state_from_numpy(arrays: dict, device) -> TrackState:
    """Build a TrackState from numpy arrays laid out as the JAX package's
    TrackState leaves: complex fields planar float32 [..., 2], `carr_filter`
    a (w, x) pair and `code_filter` an (inputs [C,3], outputs [C,3]) pair."""
    dev = torch.device(device)
    a = dict(arrays)
    w, x = a.pop("carr_filter")
    ins, outs = a.pop("code_filter")
    fields = {"carr_w": w, "carr_x": x, "dll_inputs": ins,
              "dll_outputs": outs}
    for name, v in a.items():
        v = np.asarray(v)
        if name in _COMPLEX_FIELDS:
            v = (v[..., 0].astype(np.float32)
                 + 1j * v[..., 1].astype(np.float32)).astype(np.complex64)
        fields[name] = v

    def conv(v):
        v = np.array(v)                 # own, writable copy
        if v.dtype == np.bool_:
            return torch.as_tensor(v, device=dev)
        if np.issubdtype(v.dtype, np.integer):
            return torch.as_tensor(v.astype(np.int32), device=dev)
        if np.iscomplexobj(v):
            return torch.as_tensor(v.astype(np.complex64), device=dev)
        return torch.as_tensor(v.astype(np.float32), device=dev)

    return TrackState(**{f: conv(fields[f]) for f in TrackState._fields})


def state_to_numpy(state: TrackState) -> dict:
    """Inverse of state_from_numpy: the JAX TrackState leaf layout."""
    out = {}
    for name, t in state._asdict().items():
        v = t.detach().cpu().numpy()
        if name in _COMPLEX_FIELDS:
            v = np.stack([v.real, v.imag], axis=-1).astype(np.float32)
        out[name] = v
    out["carr_filter"] = (out.pop("carr_w"), out.pop("carr_x"))
    out["code_filter"] = (out.pop("dll_inputs"), out.pop("dll_outputs"))
    return out


def tracking_correlator(name: str) -> str:
    """The engine correlator a ReceiverConfig.correlator or
    TrackConfig.correlator value runs: 'auto', 'chunked' and the JAX
    package's chunked names 'pallas' and 'mxu' -> 'chunked'; 'gather' ->
    'gather'.  The JAX package's legacy 'fft' correlator is refused."""
    if name in ("auto", "chunked", "pallas", "mxu"):
        return "chunked"
    if name == "gather":
        return name
    if name == "fft":
        raise ValueError(
            "correlator='fft' does not carry over to the port (ROADMAP.md, "
            "North star, 'Does not carry over': the legacy 'fft' "
            "correlator); use 'chunked' or 'gather'")
    raise ValueError(f"unknown correlator {name!r} (auto | chunked | "
                     f"gather)")


class TrackingEngine:
    """One engine per (signal type, sampling rate).

    `codes` is a [n_slots, code_len * code_samples_per_chip] table of +-1
    replicas (one row per trackable PRN); channels reference rows via
    `prn_slot`, so host-side satellite reassignment is an int update.
    `sec_codes` (optional [n_slots, sec_len] +-1) are per-slot secondary
    codes for in-loop wipe-off once `enable_extended` gets a phase.
    `device`: None runs on the card (and raises without one); the CPU only
    when asked for.
    """

    def __init__(self, cfg: TrackConfig, codes: np.ndarray,
                 sec_codes: np.ndarray | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.correlator = tracking_correlator(cfg.correlator)
        if codes.ndim != 2:
            raise ValueError("codes must be [n_slots, code_samples]")
        if sec_codes is None:
            sec_codes = np.ones((codes.shape[0], 1), dtype=np.float32)
        if sec_codes.ndim != 2 or sec_codes.shape[0] != codes.shape[0]:
            raise ValueError("sec_codes must be [n_slots, sec_len]")
        self._sec = torch.as_tensor(np.asarray(sec_codes, np.float32),
                                    device=dev)
        self._sec_len = int(sec_codes.shape[1])
        # loop filter constants — wide (state 2) and narrow (states 3/4)
        self._fllpll = fll_pll_coefficients(
            cfg.fll_bw_hz, cfg.pll_bw_hz, cfg.pll_filter_order)
        self._fllpll_n = fll_pll_coefficients(
            cfg.fll_bw_narrow_hz, cfg.pll_bw_narrow_hz, cfg.pll_filter_order)
        b_in, b_out = iir_coefficients(
            cfg.dll_bw_hz, cfg.code_period_s, cfg.dll_filter_order, False)
        t_ext = cfg.code_period_s * cfg.extend_correlation_symbols
        b_in_n, b_out_n = iir_coefficients(
            cfg.dll_bw_narrow_hz, t_ext, cfg.dll_filter_order, False)
        # split-precision code period constants (A.6)
        t0 = float(cfg.samples_per_code)
        self._t0_int = int(np.floor(t0))
        self._t0_frac = float(t0 - self._t0_int)
        self._lag_margin = 16
        # the gather path steps its epochs in fours, as the JAX package's
        # gather loop does (capture outputs: ceil(n_epochs / 4) * 4 rows)
        E = self._chunk_epochs = (cfg.chunk_epochs if self.correlator ==
                                  "chunked" else 4)
        # regular-grid chunk windows: each chunk slices ONE segment per
        # channel at s_reg = start - grid_pad, then E static windows at
        # stride t0_int; the per-epoch drift d' = s_pred - s_reg is folded
        # into the lag axis.  The pad covers the largest negative drift of
        # the true epoch grid vs the regular stride.
        self._grid_pad = E + 4
        drift = 2 * E + 10                       # max d' = s_pred - s_reg
        self._corr_win = cfg.epoch_samples_max + drift      # NW
        a0 = cfg.chip_rate_chips_s * cfg.code_samples_per_chip / cfg.fs_hz
        lv = codes.shape[1]
        spc_samples = cfg.fs_hz / cfg.chip_rate_chips_s
        max_shift = max(abs(s) for s in cfg.tap_shifts_chips())
        # static lag read window: pos = margin + d'(<drift) + rem(<2)
        # + |shift|*samples/chip
        self._lag_window = int(np.ceil(self._lag_margin + drift + 4
                                       + max_shift * spc_samples)) + 4
        # shifted-replica bank R[s, l, n] = code((n - l + margin)*a0 mod L):
        # the true lv-periodic code at every (lag, sample) pair, so window
        # samples below the lag index correlate against the correctly
        # phased previous code period.  R depends on n - l only: the
        # Toeplitz row table holds rows[s, m + LW - 1] = R[s, l, l + m] for
        # m = n - l in [-(LW-1), NW-1], from the same expression
        LW, NW = self._lag_window, self._corr_win
        self._codes_np = np.asarray(codes)
        self._a0 = a0
        if self.correlator == "chunked":
            m = np.arange(-(LW - 1), NW)
            chip_idx = np.floor(a0 * (m + self._lag_margin)).astype(np.int64)
            rows = np.zeros((codes.shape[0], cc.row_width(LW, NW)),
                            np.float32)
            rows[:, :LW - 1 + NW] = self._codes_np[:, np.mod(chip_idx, lv)]
            self._rows = torch.as_tensor(rows, device=dev)   # [slots, QW]
            self.corr_spec = cc.CorrSpec(
                E=E, LW=LW, NW=NW, C=cfg.n_channels, t0_int=self._t0_int,
                t0_frac=self._t0_frac, grid_pad=self._grid_pad,
                chip_rate=float(cfg.chip_rate_chips_s), fs=float(cfg.fs_hz),
                passes=cc.table_passes(rows))
        else:
            # the +-1 code rows, one per slot (the card's kernel keeps them
            # as bits), and the gather walk's window: the per-channel start
            # spread (< one code period) plus one max-length epoch
            if dev.type == "cuda" and not np.all(
                    np.abs(self._codes_np) == 1.0):
                raise ValueError("the gather kernel takes +-1 code tables")
            self._codes = torch.as_tensor(
                self._codes_np.astype(np.float32), device=dev)
            self._win = cfg.epoch_samples_max + self._t0_int + 66
        self._fll_epochs = int(round(cfg.pull_in_time_s / cfg.code_period_s))
        w, n = self._fllpll, self._fllpll_n
        self.chain_spec = tc.ChainSpec(
            E=E, LW=LW, K=cfg.n_taps, C=cfg.n_channels,
            sec_len=self._sec_len, prompt_index=cfg.prompt_index,
            veml=cfg.veml, sec_data=cfg.sec_data,
            lag_margin=float(self._lag_margin),
            spc_samples=float(spc_samples),
            shifts_chips=tuple(float(s) for s in cfg.tap_shifts_chips()),
            fs=float(cfg.fs_hz), chip_rate=float(cfg.chip_rate_chips_s),
            carrier_freq=float(cfg.carrier_freq_hz),
            t0_int=self._t0_int, t0_frac=self._t0_frac,
            code_period_s=float(cfg.code_period_s),
            ext_n=int(cfg.extend_correlation_symbols),
            cn0_samples=int(cfg.cn0_samples),
            cn0_min_dbhz=float(cfg.cn0_min_dbhz),
            carrier_lock_th=float(cfg.carrier_lock_th),
            max_lock_fail=int(cfg.max_lock_fail),
            fll_narrow_windows=int(cfg.fll_narrow_windows),
            fll_epochs=self._fll_epochs, order=int(w.order),
            wide=(w.w0p, w.w0p2, w.w0p3, w.w0f, w.w0f2, w.a2, w.a3, w.b3),
            narrow=(n.w0p, n.w0p2, n.w0p3, n.w0f, n.w0f2, n.a2, n.a3, n.b3),
            dll_b_in=tuple(float(v) for v in b_in),
            dll_b_in_n=tuple(float(v) for v in b_in_n),
            dll_b_out=tuple(float(v) for v in b_out),
            dll_b_out_n=tuple(float(v) for v in b_out_n),
        )
        if self.correlator == "gather":
            spc = cfg.code_samples_per_chip
            self.gather_spec = gb.GatherSpec(
                loop=self.chain_spec, n_max=cfg.epoch_samples_max,
                win=self._win, code_len=codes.shape[1],
                shifts=tuple(float(np.float32(s) * np.float32(spc))
                             for s in cfg.tap_shifts_chips()),
                spc=float(spc))

    @functools.cached_property
    def rep_rows_np(self) -> np.ndarray:
        """The full shifted-replica bank [slots, LW, NW] (the JAX package's
        `_rep_rows`), built from its own expression."""
        ngrid = (np.arange(self._corr_win)[None, :]
                 - np.arange(self._lag_window)[:, None])
        chip_idx = np.floor(self._a0 * (ngrid + self._lag_margin)).astype(
            np.int64)
        lv = self._codes_np.shape[1]
        return self._codes_np[:, np.mod(chip_idx, lv)].astype(np.float32)

    # ---------------- state management (host) ----------------

    def init_state(self) -> TrackState:
        C, K, dev = self.cfg.n_channels, self.cfg.n_taps, self.device
        zf = torch.zeros(C, dtype=_F32, device=dev)
        zi = torch.zeros(C, dtype=_I32, device=dev)
        zb = torch.zeros(C, dtype=torch.bool, device=dev)
        zc = torch.zeros(C, dtype=torch.complex64, device=dev)
        return TrackState(
            active=zb, prn_slot=zi, start=zi,
            cur_len=torch.full((C,), self._t0_int, dtype=_I32, device=dev),
            rem_code_phase_samples=zf, code_freq_delta=zf,
            carrier_doppler_hz=zf, rem_carr_phase_rad=zf,
            carr_w=zf, carr_x=zf,
            dll_inputs=torch.zeros((C, 3), dtype=_F32, device=dev),
            dll_outputs=torch.zeros((C, 3), dtype=_F32, device=dev),
            prev_prompt=zc, s_absi=zf, s_i2=zf, s_q2=zf, cn0_last=zf,
            push_count=zi, lock_fail=zi, epochs_in_track=zi, fll_on=zb,
            mode=zi, ext_cnt=zi,
            acc_corr=torch.zeros((C, K), dtype=torch.complex64, device=dev),
            acc_half=zc, sec_on=zb, sec_idx=zi, carr_offset_hz=zf,
        )

    def activate_channel(self, state: TrackState, ch: int, prn_slot: int,
                         acq_delay_samples: float, acq_doppler_hz: float,
                         acq_samplestamp: int, block_start_abs: int,
                         carr_offset_hz: float = 0.0) -> TrackState:
        """Host-side pull-in (reference state 1, dll_pll_veml_tracking.cc
        :1568-1591): align the channel's first epoch to the next code-period
        boundary implied by the acquisition result, seed NCOs and filters
        from Acq_delay/Acq_doppler."""
        cfg = self.cfg
        code_freq = (1.0 + acq_doppler_hz / cfg.carrier_freq_hz) \
            * cfg.chip_rate_chips_s
        t_prn = cfg.fs_hz * cfg.code_length_chips / code_freq
        boundary_abs = float(acq_samplestamp) + float(acq_delay_samples)
        k = max(0.0, np.ceil((block_start_abs - boundary_abs) / t_prn))
        start_abs = boundary_abs + k * t_prn
        start_rel = start_abs - block_start_abs
        start_i = int(np.floor(start_rel))
        rem = float(start_rel - start_i)
        cur_len = int(np.floor(t_prn + rem))
        if self._fllpll.order == 3:
            w0, x0 = 0.0, 2.0 * acq_doppler_hz
        else:
            w0, x0 = acq_doppler_hz, 0.0
        s = state
        return s._replace(
            active=_set(s.active, ch, True),
            prn_slot=_set(s.prn_slot, ch, prn_slot),
            start=_set(s.start, ch, start_i),
            cur_len=_set(s.cur_len, ch, cur_len),
            rem_code_phase_samples=_set(s.rem_code_phase_samples, ch, rem),
            code_freq_delta=_set(s.code_freq_delta, ch,
                                 code_freq - cfg.chip_rate_chips_s),
            carrier_doppler_hz=_set(s.carrier_doppler_hz, ch,
                                    acq_doppler_hz),
            rem_carr_phase_rad=_set(s.rem_carr_phase_rad, ch, 0.0),
            carr_w=_set(s.carr_w, ch, w0), carr_x=_set(s.carr_x, ch, x0),
            dll_inputs=_set(s.dll_inputs, ch, 0.0),
            dll_outputs=_set(s.dll_outputs, ch, 0.0),
            prev_prompt=_set(s.prev_prompt, ch, 0.0),
            s_absi=_set(s.s_absi, ch, 0.0), s_i2=_set(s.s_i2, ch, 0.0),
            s_q2=_set(s.s_q2, ch, 0.0), cn0_last=_set(s.cn0_last, ch, 0.0),
            push_count=_set(s.push_count, ch, 0),
            lock_fail=_set(s.lock_fail, ch, 0),
            epochs_in_track=_set(s.epochs_in_track, ch, 0),
            fll_on=_set(s.fll_on, ch, bool(cfg.enable_fll_pull_in)),
            mode=_set(s.mode, ch, 0), ext_cnt=_set(s.ext_cnt, ch, 0),
            acc_corr=_set(s.acc_corr, ch, 0.0),
            acc_half=_set(s.acc_half, ch, 0.0),
            sec_on=_set(s.sec_on, ch, False), sec_idx=_set(s.sec_idx, ch, 0),
            carr_offset_hz=_set(s.carr_offset_hz, ch, float(carr_offset_hz)),
        )

    def enable_extended(self, state: TrackState, ch: int,
                        epochs_to_boundary: int,
                        sec_phase: int | None = None) -> TrackState:
        """Switch a channel to states 3/4 (narrow bandwidths + coherent
        extension over extend_correlation_symbols epochs), reference
        dll_pll_veml_tracking.cc:1774-1900.  The first (possibly partial)
        window closes `epochs_to_boundary` epochs from now, so every later
        window is aligned to the channel's bit grid; `sec_phase` enables the
        in-loop secondary wipe-off at that code index."""
        n = self.cfg.extend_correlation_symbols
        e = int(epochs_to_boundary) % n
        if e == 0:
            e = n
        # re-seed the carrier integrators for the narrow coefficients from
        # the current Doppler estimate (the wide loop's rate-integrator
        # residue would drag the 9x-slower narrow loop off the signal)
        d = state.carrier_doppler_hz[ch]
        if self._fllpll.order == 3:
            w0, x0 = torch.zeros_like(d), 2.0 * d
        else:
            w0, x0 = d, torch.zeros_like(d)
        s = state
        st = s._replace(
            mode=_set(s.mode, ch, 1), ext_cnt=_set(s.ext_cnt, ch, n - e),
            acc_corr=_set(s.acc_corr, ch, 0.0),
            acc_half=_set(s.acc_half, ch, 0.0),
            s_absi=_set(s.s_absi, ch, 0.0), s_i2=_set(s.s_i2, ch, 0.0),
            s_q2=_set(s.s_q2, ch, 0.0),
            push_count=_set(s.push_count, ch, 0),
            lock_fail=_set(s.lock_fail, ch, 0),
            fll_on=_set(s.fll_on, ch, self.cfg.fll_narrow_windows > 0),
            carr_w=_set(s.carr_w, ch, w0), carr_x=_set(s.carr_x, ch, x0),
            dll_inputs=_set(s.dll_inputs, ch, 0.0),
        )
        if sec_phase is not None:
            st = st._replace(
                sec_on=_set(st.sec_on, ch, True),
                sec_idx=_set(st.sec_idx, ch, int(sec_phase) % self._sec_len))
        return st

    def deactivate_channel(self, state: TrackState, ch: int) -> TrackState:
        return state._replace(active=_set(state.active, ch, False))

    def rebase(self, state: TrackState, base: int) -> TrackState:
        """Shift segment-relative start indices after a segment is consumed
        (epoch starts stay int32, relative to the segment)."""
        return state._replace(start=state.start - int(base))

    # ---------------- row packing (chain kernel state) ----------------

    def _pack_rows(self, state: TrackState, limit: int):
        """TrackState -> (fst [SF, C] f32, ist [SI, C] i32) in the chain's
        row order (ops.track_chain F_* / I_*)."""
        K = self.cfg.n_taps
        rows = [state.rem_code_phase_samples, state.code_freq_delta,
                state.carrier_doppler_hz, state.rem_carr_phase_rad,
                state.carr_w, state.carr_x,
                state.prev_prompt.real, state.prev_prompt.imag,
                state.s_absi, state.s_i2, state.s_q2, state.cn0_last,
                state.acc_half.real, state.acc_half.imag,
                state.carr_offset_hz]
        rows += [state.dll_inputs[:, j] for j in range(3)]
        rows += [state.dll_outputs[:, j] for j in range(3)]
        rows += [state.acc_corr[:, k].real for k in range(K)]
        rows += [state.acc_corr[:, k].imag for k in range(K)]
        fst = torch.stack(rows).to(_F32).contiguous()
        irows = [state.active.to(_I32), state.start, state.cur_len,
                 state.push_count, state.lock_fail, state.epochs_in_track,
                 state.fll_on.to(_I32), state.mode, state.ext_cnt,
                 state.sec_on.to(_I32), state.sec_idx,
                 torch.full_like(state.start, int(limit))]
        ist = torch.stack([r.to(_I32) for r in irows]).contiguous()
        return fst, ist

    def _unpack_rows(self, state: TrackState, fst, ist) -> TrackState:
        """Inverse of _pack_rows (the rows become views of fst / ist)."""
        K = self.cfg.n_taps
        return TrackState(
            active=ist[tc.I_ACTIVE] > 0,
            prn_slot=state.prn_slot,
            start=ist[tc.I_START],
            cur_len=ist[tc.I_CURLEN],
            rem_code_phase_samples=fst[tc.F_REM_CODE],
            code_freq_delta=fst[tc.F_DELTA],
            carrier_doppler_hz=fst[tc.F_DOPPLER],
            rem_carr_phase_rad=fst[tc.F_REM_CARR],
            carr_w=fst[tc.F_CARR_W], carr_x=fst[tc.F_CARR_X],
            dll_inputs=fst[tc.F_DLL_IN0:tc.F_DLL_IN0 + 3].T,
            dll_outputs=fst[tc.F_DLL_OUT0:tc.F_DLL_OUT0 + 3].T,
            prev_prompt=torch.complex(fst[tc.F_PREV_R], fst[tc.F_PREV_I]),
            s_absi=fst[tc.F_SABSI], s_i2=fst[tc.F_SI2], s_q2=fst[tc.F_SQ2],
            cn0_last=fst[tc.F_CN0],
            push_count=ist[tc.I_PUSH],
            lock_fail=ist[tc.I_LOCKFAIL],
            epochs_in_track=ist[tc.I_EPOCHS],
            fll_on=ist[tc.I_FLL_ON] > 0,
            mode=ist[tc.I_MODE],
            ext_cnt=ist[tc.I_EXTCNT],
            acc_corr=torch.complex(
                fst[tc.F_ACC_R0:tc.F_ACC_R0 + K],
                fst[tc.F_ACC_R0 + K:tc.F_ACC_R0 + 2 * K]).T,
            acc_half=torch.complex(fst[tc.F_ACCH_R], fst[tc.F_ACCH_I]),
            sec_on=ist[tc.I_SEC_ON] > 0,
            sec_idx=ist[tc.I_SEC_IDX],
            carr_offset_hz=fst[tc.F_CARR_OFF],
        )

    # ---------------- device path: the chunk loop ----------------

    def _pad_for_chunks(self, samples):
        """Zero-pad the capture tail ONCE per call so every chunk's segment
        slice fits for every valid epoch (valid => start < limit <= n_samp -
        epoch_samples_max): the padded region is either masked or belongs to
        invalid epochs whose state never merges."""
        E = self._chunk_epochs
        seg_len = (E - 1) * self._t0_int + self._corr_win
        n_samp = samples.shape[0]
        pad_tail = max(0, seg_len + self._grid_pad
                       - self.cfg.epoch_samples_max, seg_len - n_samp)
        if pad_tail:
            samples = torch.cat([samples, torch.zeros(
                pad_tail, dtype=samples.dtype, device=samples.device)])
        return samples

    def _run_capture(self, samples, state: TrackState, limit: int,
                     n_epochs: int):
        """The epoch walk over a device-resident capture.  Chunked: a loop
        of ceil(n_epochs / E) chunks, each one correlator and one chain
        launch, all enqueued by one call on the card.  Gather: n_epochs
        epochs in one gather_block launch.  Returns the final state and the
        per-epoch rows (out_f [n, 7, C], out_i [n, 2, C], out_corr [n, 2K,
        C], n = the epochs walked) still on the device."""
        if samples.device.type != self.device.type:
            raise ValueError(f"capture lies on {samples.device}, engine on "
                             f"{self.device}")
        samples = samples.to(torch.complex64).contiguous()
        fst, ist = self._pack_rows(state, limit)
        slot = state.prn_slot.to(_I32).contiguous()
        sec_rows = self._sec[slot.long()].T.contiguous()
        if self.correlator == "gather":
            out_f, out_i, out_corr, fst, ist = gb.gather_block(
                self.gather_spec, samples,
                self._codes[slot.long()].contiguous(), sec_rows, fst, ist,
                n_epochs)
        else:
            E = self._chunk_epochs
            n_chunks = (n_epochs + E - 1) // E
            out_f, out_i, out_corr, fst, ist = tcap.track_capture(
                self.chain_spec, self.corr_spec, n_chunks,
                self._pad_for_chunks(samples), self._rows, slot, sec_rows,
                fst, ist)
        return self._unpack_rows(state, fst, ist), out_f, out_i, out_corr

    # ---------------- output reductions ----------------

    @property
    def capture_decim(self) -> int:
        """Decimation of the loop-state rows in capture outputs: 4 epochs
        (~4 ms at 1 ms codes) keeps the observables grid fresh through mode
        transitions while the receiver harvests on that grid."""
        d = 4
        while self._chunk_epochs % d and d > 1:
            d //= 2
        return d

    @staticmethod
    def n_symbol_slots(n_epochs_cap: int, sym_n: int) -> int:
        return n_epochs_cap // sym_n + 2

    def _read_back(self, out_f, out_i, out_corr) -> CaptureReadback:
        """Queue the per-epoch rows' copy to the host: on the card into
        pinned host tensors with non_blocking=True, then an event; nothing
        waits here.  On the CPU the rows stay as they are."""
        K = self.cfg.n_taps
        corr = torch.complex(out_corr[:, :K], out_corr[:, K:]).permute(
            0, 2, 1)                                                 # [cap,C,K]
        if out_f.device.type != "cuda":
            return CaptureReadback(out_f, out_i, corr, None)
        host = []
        for t in (out_f, out_i, corr):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if not h.is_pinned():
                raise RuntimeError("the readback buffer could not be pinned")
            h.copy_(t, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record()
        return CaptureReadback(*host, event)

    def harvest_capture(self, rb: CaptureReadback,
                        decim: int | None = None) -> TrackOutputs:
        """The harvest half of track_capture: wait for that segment's
        readback only (its own event, not the stream) and build its
        TrackOutputs.  Full-rate valid/start/len/correlators/rem_code; the
        loop-state rows sampled at epochs k % D == D-1 and held (repeated)
        between (D = `decim`, capture_decim by default; 1 keeps every
        row)."""
        D = self.capture_decim if decim is None else decim
        if rb.event is not None:
            rb.event.synchronize()
        f = rb.out_f.numpy()
        i = rb.out_i.numpy()
        d = np.repeat(f[D - 1::D], D, axis=0)
        return TrackOutputs(
            valid=f[:, tc.O_VALID] > 0.5,
            start=i[:, 0],
            cur_len=i[:, 1],
            correlators=rb.correlators.numpy(),
            carrier_doppler_hz=d[:, tc.O_DOPPLER],
            code_freq_delta=d[:, tc.O_DELTA],
            rem_code_phase_samples=f[:, tc.O_REM_CODE],
            rem_carr_phase_rad=d[:, tc.O_REM_CARR],
            cn0_dbhz=d[:, tc.O_CN0],
            active=f[:, tc.O_ACTIVE] > 0.5,
        )

    def _symbol_outputs(self, out_f, out_i, out_corr, entering_rem, sym_off,
                        N: int) -> SymbolOutputs:
        """Reduce per-epoch rows onto each channel's symbol grid on the
        device: slot 0 = the partial head [0, b0); slot s >= 1 covers
        [b0 + (s-1)N, b0 + sN).  Prompt means and valid counts are slot
        sums; the loop-state rows are the picks entering each slot."""
        dev = out_f.device
        cap, _, C = out_f.shape
        S = self.n_symbol_slots(cap, N)
        p = self.cfg.prompt_index
        K = self.cfg.n_taps
        v = out_f[:, tc.O_VALID]                                   # [cap, C]
        fields = torch.stack([out_corr[:, p] * v, out_corr[:, K + p] * v, v],
                             dim=-1)                               # [cap,C,3]
        P = S * N
        fields = torch.cat([fields, torch.zeros(
            (P - cap, C, 3), dtype=_F32, device=dev)])
        # per-channel roll forward by N - b0 puts epoch b0 at row N, so an
        # [S, N] reshape sums each slot
        b0 = torch.as_tensor(np.asarray(sym_off, np.int64), device=dev)
        rows = torch.arange(P, device=dev)[:, None]
        src = torch.remainder(rows - (N - b0)[None, :], P)         # [P, C]
        rolled = torch.gather(fields, 0, src[..., None].expand(P, C, 3))
        sums = rolled.reshape(S, N, C, 3).sum(dim=1)               # [S, C, 3]
        mi = sums[..., 0] * (1.0 / N)
        mq = sums[..., 1] * (1.0 / N)
        vcount = sums[..., 2].to(_I32)
        sl = torch.arange(S, device=dev)[:, None]
        e_s = torch.clamp(b0[None, :] - N + sl * N, 0, cap - 1)    # [S, C]
        em1 = torch.clamp(e_s - 1, 0, cap - 1)
        rem = out_f[:, tc.O_REM_CODE]
        prev = torch.cat([entering_rem[None], rem[:-1]])
        # pre-floor code-phase fraction (receiver._harvest wrap note)
        fracs = rem - torch.round(rem - prev)
        nv = v.sum(dim=0).to(torch.int64)                          # [C]
        last = torch.clamp(nv - 1, 0, cap - 1)
        active_last = out_f[:, tc.O_ACTIVE].gather(0, last[None])[0] > 0.5

        def take(a, idx):
            return torch.gather(a, 0, idx).cpu().numpy()

        return SymbolOutputs(
            start=take(out_i[:, 0], e_s),
            mean_i=mi.cpu().numpy(), mean_q=mq.cpu().numpy(),
            frac=take(fracs, em1),
            rem_carr_phase_rad=take(out_f[:, tc.O_REM_CARR], em1),
            carrier_doppler_hz=take(out_f[:, tc.O_DOPPLER], em1),
            cn0_dbhz=take(out_f[:, tc.O_CN0], em1),
            code_freq_delta=take(out_f[:, tc.O_DELTA], em1),
            vcount=vcount.cpu().numpy(),
            n_valid=nv.to(_I32).cpu().numpy(),
            active=active_last.cpu().numpy())

    # ---------------- host API ----------------

    def _check_capture(self, samples, span: int) -> int:
        """The epochs a capture call walks: every epoch that can start in
        [0, span), rounded up to whole chunks (the gather path's fours)."""
        need = span + self.cfg.epoch_samples_max
        if samples.shape[0] < need:
            raise ValueError(f"capture must hold >= {need} samples")
        E = self._chunk_epochs
        return -(-(span // (self._t0_int - 2) + 2) // E) * E

    def track_block(self, samples, state: TrackState, base: int):
        """Process one sample block (JAX engine.py:1512-1532).

        `samples`: complex64 (numpy or a tensor) holding at least `base +
        epoch_samples_max` samples; the tail overlaps the next block.  Every
        active channel advances through all epochs that start within [0,
        base).  Returns (state rebased by base, TrackOutputs at full rate:
        base // (t0_int - 2) + 2 epochs on the gather path, whole chunks of
        them on the chunked path)."""
        x = (samples if torch.is_tensor(samples)
             else torch.from_numpy(np.asarray(samples))).to(
                 self.device, torch.complex64)
        need = base + self.cfg.epoch_samples_max
        if x.shape[0] < need:
            raise ValueError(f"block must be >= base+epoch_samples_max = "
                             f"{need}, got {x.shape[0]}")
        n_epochs = base // (self._t0_int - 2) + 2
        st, out_f, out_i, out_corr = self._run_capture(x, state, base,
                                                       n_epochs)
        return self.rebase(st, base), self.harvest_capture(
            self._read_back(out_f, out_i, out_corr), decim=1)

    def track_capture(self, samples, state: TrackState, span: int):
        """Process a whole device-resident capture segment (complex64
        tensor with >= span + epoch_samples_max samples): every active
        channel consumes all epochs starting within [0, span).  Returns
        (state rebased by span, TrackOutputs with segment-relative starts,
        the loop-state rows decimated at capture_decim): launch_capture
        then harvest_capture."""
        st, rb = self.launch_capture(samples, state, span)
        return st, self.harvest_capture(rb)

    def launch_capture(self, samples, state: TrackState, span: int):
        """The launch half of track_capture: enqueue the segment's kernels,
        rebase the state and queue the rows' copy to the host, without
        waiting for any of it.  Returns (state rebased by span,
        CaptureReadback for harvest_capture)."""
        n_epochs = self._check_capture(samples, span)
        st, out_f, out_i, out_corr = self._run_capture(samples, state, span,
                                                       n_epochs)
        return self.rebase(st, span), self._read_back(out_f, out_i,
                                                      out_corr)

    def track_capture_symbols(self, samples, state: TrackState, span: int,
                              sym_off, sym_n: int):
        """Whole-segment tracking with the symbol-grid reduction: `sym_off`
        [C] gives each channel's next symbol boundary as an epoch index in
        [1, sym_n] (host bit sync supplies it).  Returns (state rebased by
        span, SymbolOutputs)."""
        n_epochs = self._check_capture(samples, span)
        entering_rem = state.rem_code_phase_samples
        st, out_f, out_i, out_corr = self._run_capture(samples, state, span,
                                                       n_epochs)
        return self.rebase(st, span), self._symbol_outputs(
            out_f, out_i, out_corr, entering_rem, sym_off, int(sym_n))
