"""Fused per-epoch tracking chain: the CUDA kernel, its plain torch version
and the wrapper that picks between them by the device of its inputs.

The chunked tracking engine correlates `E` epochs of every channel in one
batched matmul (the lag window of each epoch, frozen-NCO frame); this chain
then runs the EXACT sequential per-epoch loop closure for the chunk: tap
reads at the true code phase, rotation into the true-NCO frame, secondary
wipe, extended coherent accumulation, Costas / four-quadrant PLL and FLL
discriminators, the FLL-assisted PLL of order 2/3 with its wide/narrow
select, the EPL/VEML DLL with its IIR filter, the A.6 split-precision NCO
step, the SNV CN0 estimator with the carrier-lock supervision, FLL turn-off
seeding and the frozen-vs-true phase ledger.

It replaces the Pallas kernel of the JAX package
(gnss_sdr_1_tpu/ops/pallas_chain.py `_make_kernel`).  State crosses the
call as row-stacked matrices (`n_frows(K)` x C float32 + `N_IROWS` x C
int32) in the same row order (F_* / I_* / O_* below, and csrc/rows.cuh
for the kernels), so the engine's pack/unpack matches the JAX package's.

Numerics differ from the Pallas kernel in one documented place: the
arctangents are the platform's `atan2` (Cephes' rational on the TPU side,
<= 4e-7 rad apart), and the interpolated tap read sums two lags instead of
all LW (the others carry zero weight).

The lag windows come channel-major from the chunk correlator
(ops.chunk_corr), so each channel's chunk is one contiguous block; the
Pallas kernel takes them as [E, LW, C] for the TPU's lanes.

Signature of `chain` / `chain_plain`:
    (spec, zr [C,E,LW] f32, zi [C,E,LW] f32, s_reg [C,E] i32,
     step0 [C] f32, sec_rows [sec_len,C] f32, fst [SF,C] f32,
     ist [SI,C] i32)
 -> (out_f [E,7,C] f32, out_i [E,2,C] i32, out_corr [E,2K,C] f32,
     fst' [SF,C] f32, ist' [SI,C] i32)
`s_reg` is the regular-grid slice origin of each epoch window.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

_TWO_PI = float(2.0 * np.pi)
_PI = float(np.pi)
_TINY = float(np.finfo(np.float32).tiny)

# float32 state rows (before the trailing dll/acc blocks)
F_REM_CODE, F_DELTA, F_DOPPLER, F_REM_CARR = 0, 1, 2, 3
F_CARR_W, F_CARR_X, F_PREV_R, F_PREV_I = 4, 5, 6, 7
F_SABSI, F_SI2, F_SQ2, F_CN0 = 8, 9, 10, 11
F_ACCH_R, F_ACCH_I, F_CARR_OFF = 12, 13, 14
F_DLL_IN0 = 15          # 3 rows
F_DLL_OUT0 = 18         # 3 rows
F_ACC_R0 = 21           # K rows, then K rows of acc_i


def n_frows(K: int) -> int:
    return F_ACC_R0 + 2 * K


# int32 state rows
I_ACTIVE, I_START, I_CURLEN, I_PUSH, I_LOCKFAIL = 0, 1, 2, 3, 4
I_EPOCHS, I_FLL_ON, I_MODE, I_EXTCNT, I_SEC_ON, I_SEC_IDX, I_LIMIT = \
    5, 6, 7, 8, 9, 10, 11
N_IROWS = 12

# per-epoch float32 output rows
O_DOPPLER, O_DELTA, O_REM_CODE, O_REM_CARR, O_CN0, O_VALID, O_ACTIVE = \
    0, 1, 2, 3, 4, 5, 6
N_OROWS = 7

# kernel launches made by `chain` on CUDA tensors (never by chain_plain)
launches = 0


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static configuration of one tracking chain."""

    E: int                  # epochs per chunk
    LW: int                 # lag-window length
    K: int                  # correlator taps
    C: int                  # channels
    sec_len: int
    prompt_index: int
    veml: bool
    sec_data: bool
    lag_margin: float
    spc_samples: float      # samples per chip
    shifts_chips: tuple     # [K]
    fs: float
    chip_rate: float
    carrier_freq: float
    t0_int: int
    t0_frac: float
    code_period_s: float
    ext_n: int
    cn0_samples: int
    cn0_min_dbhz: float
    carrier_lock_th: float
    max_lock_fail: int
    fll_narrow_windows: int
    fll_epochs: int
    order: int              # PLL filter order (2 or 3)
    wide: tuple             # (w0p, w0p2, w0p3, w0f, w0f2, a2, a3, b3)
    narrow: tuple
    dll_b_in: tuple         # [4]
    dll_b_in_n: tuple
    dll_b_out: tuple        # [3]
    dll_b_out_n: tuple


def _f32(v) -> float:
    """Round a Python float to the nearest float32 value."""
    return float(np.float32(v))


def _sel_pair(wide_v, narrow_v) -> tuple[float, float]:
    """(base, slope) of the per-channel wide/narrow select
    base + narrow_f * slope, both rounded to float32."""
    return _f32(wide_v), _f32(float(narrow_v) - float(wide_v))


def mod_floor(x, m: float):
    """Floating modulo with the sign of the divisor (numpy/JAX `mod`):
    the exact fmod, then + m where the remainder's sign differs from m's."""
    r = torch.fmod(x, m)
    fix = (r != 0.0) & ((r < 0.0) != (m < 0.0))
    return torch.where(fix, r + m, r)


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def loop_consts_plain(spec: ChainSpec, ist):
    """The wide/narrow select of the loop constants for each channel's mode
    (fixed while a walk runs: only the host switches it), as
    csrc/loop_close.cuh `loop_consts`: (pll [8], bi [4], bo [3]) lists of
    [C] rows."""
    narrow_f = (ist[I_MODE] >= 1).to(torch.float32)

    def sel(w, n):
        base, slope = _sel_pair(w, n)
        return base + narrow_f * slope

    return ([sel(spec.wide[j], spec.narrow[j]) for j in range(8)],
            [sel(spec.dll_b_in[j], spec.dll_b_in_n[j]) for j in range(4)],
            [sel(spec.dll_b_out[j], spec.dll_b_out_n[j]) for j in range(3)])


def loop_close_plain(spec: ChainSpec, consts, f, i, corr_r, corr_i,
                     sec_rows):
    """One epoch's loop closure of every channel, JAX `_loop_update`
    (gnss_sdr_1_tpu/track/engine.py:548-782): the secondary wipe, the
    extended coherent accumulation, the Costas / four-quadrant PLL and FLL
    discriminators, the FLL-assisted PLL of order 2/3 with its wide/narrow
    select, the EPL/VEML DLL with its IIR filter, the A.6 split-precision
    NCO step, the SNV CN0 estimator with the carrier-lock supervision and
    the FLL turn-off seeding, merged by `valid`.

    `consts` comes from `loop_consts_plain`, `f` [SF, C] / `i` [SI, C]
    are the state rows entering the epoch, `corr_r` / `corr_i` the K taps
    (lists of [C], true-NCO frame) and `sec_rows` [sec_len, C] the
    channels' secondary codes.  Returns (f', i',
    out_f rows [N_OROWS, C], out_i rows [2, C], out_corr rows [2K, C],
    valid [C]).  The chain (`chain_plain`) and the gather walk
    (ops.gather_block) both close their epochs here."""
    K, P = spec.K, spec.prompt_index
    half_n = spec.ext_n // 2
    f32 = torch.float32
    i32 = torch.int32
    zero = torch.zeros_like(f[0])
    (w0p, w0p2, w0p3, w0f, w0f2, a2, a3, b3), bi, bo = consts

    carr_off = f[F_CARR_OFF]
    limit = i[I_LIMIT]
    mode0 = i[I_MODE]
    sec_on = i[I_SEC_ON] > 0
    rem_code, delta, doppler = f[F_REM_CODE], f[F_DELTA], f[F_DOPPLER]
    rem_carr, cw, cx = f[F_REM_CARR], f[F_CARR_W], f[F_CARR_X]
    prev_r, prev_i = f[F_PREV_R], f[F_PREV_I]
    sabsi0, si20, sq20, cn0_old = f[F_SABSI], f[F_SI2], f[F_SQ2], f[F_CN0]
    acch_r, acch_i = f[F_ACCH_R], f[F_ACCH_I]
    din = [f[F_DLL_IN0 + j] for j in range(3)]
    dout = [f[F_DLL_OUT0 + j] for j in range(3)]
    accr0 = [f[F_ACC_R0 + k] for k in range(K)]
    acci0 = [f[F_ACC_R0 + K + k] for k in range(K)]
    active_i, start, cur_len = i[I_ACTIVE], i[I_START], i[I_CURLEN]
    push_count0, lockfail0, epochs0 = i[I_PUSH], i[I_LOCKFAIL], i[I_EPOCHS]
    fllon_i, extcnt0, sec_idx = i[I_FLL_ON], i[I_EXTCNT], i[I_SEC_IDX]

    active = active_i > 0
    valid = active & (start < limit)
    validf = valid.to(f32)

    t_epoch = cur_len.to(f32) / _f32(spec.fs)
    if spec.sec_len > 1:
        idx_c = torch.clamp(sec_idx, max=spec.sec_len - 1).long()
        sec_chip = torch.gather(sec_rows, 0, idx_c[None, :])[0]
    else:
        sec_chip = sec_rows[0]
    s = torch.where(sec_on, sec_chip, torch.ones_like(sec_chip))
    cw_r = [corr_r[k] * s for k in range(K)]
    cw_i = [corr_i[k] * s for k in range(K)]
    pw_r, pw_i = cw_r[P], cw_i[P]

    narrow = mode0 >= 1
    acc_r = [accr0[k] + cw_r[k] for k in range(K)]
    acc_i = [acci0[k] + cw_i[k] for k in range(K)]
    cnt = extcnt0 + 1
    boundary = narrow & (cnt >= spec.ext_n)
    upd = (~narrow) | boundary
    disc_r = [torch.where(narrow, acc_r[k], cw_r[k]) for k in range(K)]
    disc_i = [torch.where(narrow, acc_i[k], cw_i[k]) for k in range(K)]
    dp_r, dp_i = disc_r[P], disc_i[P]
    t_int = torch.where(narrow, cnt.to(f32) * _f32(spec.code_period_s),
                        t_epoch)

    # --- carrier discriminators (A.3) ---
    costas = torch.where(
        dp_r != 0.0,
        torch.atan2(dp_i * torch.sign(dp_r), torch.abs(dp_r)),
        zero) / _TWO_PI
    fourq = torch.atan2(dp_i, dp_r) / _TWO_PI
    if spec.sec_data:
        carr_err_cyc = costas
    else:
        carr_err_cyc = torch.where(sec_on, fourq, costas)
    dot = prev_r * pw_r + prev_i * pw_i
    cross = prev_r * pw_i - pw_r * prev_i
    freq_err_hz = torch.atan2(cross, dot) / t_epoch / _TWO_PI
    t_half = max(_f32(half_n * spec.code_period_s), _f32(1e-6))
    p2_r = acc_r[P] - acch_r
    p2_i = acc_i[P] - acch_i
    dot_h = acch_r * p2_r + acch_i * p2_i
    cross_h = acch_r * p2_i - p2_r * acch_i
    h_mag = acch_r * acch_r + acch_i * acch_i
    freq_err_ext = torch.where(
        (h_mag > 0.0) & boundary,
        torch.atan2(cross_h, dot_h) / t_half / _TWO_PI, zero)

    fll_on = fllon_i > 0
    pll_in = carr_err_cyc
    fll_in = torch.where(fll_on & ~narrow & (push_count0 > 0),
                         freq_err_hz, zero)
    fll_in = torch.where(narrow & fll_on, freq_err_ext, fll_in)

    # --- FLL-assisted PLL cascade (A.5), the wide/narrow constants ---
    if spec.order == 3:
        w_new = cw + t_int * (w0p3 * pll_in + w0f2 * fll_in)
        x_new = cx + t_int * (0.5 * w_new + a2 * w0f * fll_in
                              + a3 * w0p2 * pll_in)
        doppler_new = 0.5 * x_new + b3 * w0p * pll_in
    else:
        w_new = cw + t_int * (w0p2 * pll_in + w0f * fll_in)
        doppler_new = 0.5 * (w_new + cw) + a2 * w0p * pll_in
        x_new = cx

    # --- DLL (A.3/A.5) ---
    if spec.veml:
        pe = torch.sqrt(disc_r[0] ** 2 + disc_i[0] ** 2
                        + disc_r[1] ** 2 + disc_i[1] ** 2)
        pl_ = torch.sqrt(disc_r[3] ** 2 + disc_i[3] ** 2
                         + disc_r[4] ** 2 + disc_i[4] ** 2)
        ssum = pe + pl_
        code_err = torch.where(ssum > 0.0, (pe - pl_) / ssum, zero)
    else:
        e = torch.sqrt(disc_r[0] ** 2 + disc_i[0] ** 2)
        l_ = torch.sqrt(disc_r[2] ** 2 + disc_i[2] ** 2)
        ssum = e + l_
        code_err = torch.where(ssum > 0.0, 0.5 * (e - l_) / ssum, zero)
    code_err_filt = (bo[0] * dout[0] + bo[1] * dout[1]
                     + bo[2] * dout[2] + bi[0] * code_err
                     + bi[1] * din[0] + bi[2] * din[1]
                     + bi[3] * din[2])
    din_new = (code_err, din[0], din[1])
    dout_new = (code_err_filt, dout[0], dout[1])

    app = valid & upd
    appf = app.to(f32)

    def mrg(n, o):
        return torch.where(app, n, o)

    cw_m = mrg(w_new, cw)
    cx_m = mrg(x_new, cx)
    din_m = [mrg(din_new[j], din[j]) for j in range(3)]
    dout_m = [mrg(dout_new[j], dout[j]) for j in range(3)]
    doppler_m = mrg(doppler_new, doppler)
    cr_fc = _f32(np.float32(spec.chip_rate) / np.float32(spec.carrier_freq))
    delta_m = mrg(cr_fc * doppler_new - code_err_filt, delta)

    # --- NCO stepping / next length (A.6 split precision) ---
    ncf = _f32(spec.chip_rate) + delta_m
    d_t = (-_f32(spec.t0_int) * delta_m / ncf
           - _f32(spec.t0_frac) * delta_m / ncf)
    frac = _f32(spec.t0_frac) + d_t + rem_code
    frac_floor = torch.floor(frac)
    next_len = spec.t0_int + frac_floor.to(i32)
    rem_code_new = frac - frac_floor
    carr_step_new = _TWO_PI * (doppler_m + carr_off) / _f32(spec.fs)
    rem_carr_new = mod_floor(
        rem_carr + carr_step_new * next_len.to(f32), _TWO_PI)

    # --- CN0 / lock supervision on window accumulators (A.7) ---
    s_absi = sabsi0 + appf * torch.abs(dp_r)
    s_i2 = si20 + appf * dp_r * dp_r
    s_q2 = sq20 + appf * dp_i * dp_i
    push_count = push_count0 + app.to(i32)
    window_done = app & (torch.remainder(push_count,
                                         spec.cn0_samples) == 0)
    t_cn0 = torch.where(narrow,
                        torch.full_like(t_epoch, _f32(
                            spec.ext_n * spec.code_period_s)),
                        t_epoch)
    m = _f32(spec.cn0_samples)
    psig = (s_absi / m) ** 2
    ptot = (s_i2 + s_q2) / m
    noise = torch.clamp(ptot - psig, min=_TINY)
    cn0 = (10.0 * torch.log10(torch.clamp(psig / noise, min=_f32(1e-10)))
           - 10.0 * torch.log10(t_cn0))
    carrier_lock = (s_i2 - s_q2) / torch.clamp(s_i2 + s_q2, min=_TINY)
    cn0_last = torch.where(window_done, cn0, cn0_old)
    hist_full = push_count >= spec.cn0_samples
    s_absi = torch.where(window_done, zero, s_absi)
    s_i2 = torch.where(window_done, zero, s_i2)
    s_q2 = torch.where(window_done, zero, s_q2)
    check_now = window_done & ~fll_on
    fail = check_now & ((cn0 < spec.cn0_min_dbhz)
                        | (carrier_lock < spec.carrier_lock_th))
    ok = check_now & ~fail
    lock_fail = torch.where(
        fail, lockfail0 + 1,
        torch.where(ok, torch.clamp(lockfail0 - 1, min=0), lockfail0))
    still_active = active & (lock_fail <= spec.max_lock_fail)

    epochs_in_track = epochs0 + 1
    fll_still_on = fll_on & torch.where(
        narrow, push_count < spec.fll_narrow_windows,
        epochs_in_track < spec.fll_epochs)
    turnoff = narrow & fll_on & ~fll_still_on
    if spec.order == 3:
        seed_w = torch.zeros_like(doppler_m)
        seed_x = 2.0 * doppler_m
    else:
        seed_w = doppler_m
        seed_x = torch.zeros_like(doppler_m)
    tv = turnoff & valid
    cw_m = torch.where(tv, seed_w, cw_m)
    cx_m = torch.where(tv, seed_x, cx_m)

    reset_acc = boundary | ~narrow
    racf = (~reset_acc).to(f32)
    acc_r_new = [acc_r[k] * racf for k in range(K)]
    acc_i_new = [acc_i[k] * racf for k in range(K)]
    at_half = narrow & (cnt == half_n)
    acch_r_new = racf * torch.where(at_half, acc_r[P], acch_r)
    acch_i_new = racf * torch.where(at_half, acc_i[P], acch_i)

    # --- merge by valid: a dead channel never takes new state ---
    def mv(n, o):
        return torch.where(valid, n, o)

    merged_dopp = mv(doppler_m, doppler)
    merged_active = mv(still_active.to(i32), active_i)
    merged_cn0 = mv(cn0_last, cn0_old)
    merged_delta = mv(delta_m, delta)
    merged_rem_code = mv(rem_code_new, rem_code)
    merged_rem_carr = mv(rem_carr_new, rem_carr)
    new_cur = mv(next_len, cur_len)

    # --- per-epoch outputs ---
    out_f = torch.stack([
        merged_dopp, merged_delta, merged_rem_code, merged_rem_carr,
        torch.where(valid & hist_full, merged_cn0, zero), validf,
        merged_active.to(f32)])
    out_i = torch.stack([start, cur_len])
    out_corr = torch.stack([validf * corr_r[k] for k in range(K)]
                           + [validf * corr_i[k] for k in range(K)])

    f_new = torch.stack(
        [merged_rem_code, merged_delta, merged_dopp, merged_rem_carr,
         mv(cw_m, cw), mv(cx_m, cx), mv(pw_r, prev_r), mv(pw_i, prev_i),
         mv(s_absi, sabsi0), mv(s_i2, si20), mv(s_q2, sq20), merged_cn0,
         mv(acch_r_new, acch_r), mv(acch_i_new, acch_i), carr_off]
        + din_m + dout_m
        + [mv(acc_r_new[k], accr0[k]) for k in range(K)]
        + [mv(acc_i_new[k], acci0[k]) for k in range(K)])
    i_new = torch.stack(
        [merged_active, mv(start + cur_len, start), new_cur,
         mv(push_count, push_count0), mv(lock_fail, lockfail0),
         mv(epochs_in_track, epochs0), mv(fll_still_on.to(i32), fllon_i),
         mode0, mv(torch.where(reset_acc, torch.zeros_like(cnt), cnt),
                   extcnt0),
         i[I_SEC_ON], mv(torch.remainder(sec_idx + 1, spec.sec_len),
                         sec_idx), limit]).to(i32)
    return f_new, i_new, out_f, out_i, out_corr, valid


def chain_plain(spec: ChainSpec, zr, zi, s_reg, step0, sec_rows, fst, ist):
    """The chain in plain torch ops (any device); same rows as the kernel:
    per epoch the tap read and the rotation into the true-NCO frame, then
    `loop_close_plain`, then the frozen-vs-true phase ledger."""
    E, LW, K = spec.E, spec.LW, spec.K
    dev = zr.device
    f32 = torch.float32
    C = fst.shape[1]
    step0 = step0.reshape(C)
    lag = torch.arange(LW, dtype=f32, device=dev)[None, :]       # [1, LW]
    carr_off = fst[F_CARR_OFF]
    consts = loop_consts_plain(spec, ist)
    f, i = fst, ist
    dphi = torch.zeros(C, dtype=f32, device=dev)

    out_f = torch.empty((E, N_OROWS, C), dtype=f32, device=dev)
    out_i = torch.empty((E, 2, C), dtype=torch.int32, device=dev)
    out_corr = torch.empty((E, 2 * K, C), dtype=f32, device=dev)

    for kk in range(E):
        rem_code, delta, doppler = f[F_REM_CODE], f[F_DELTA], f[F_DOPPLER]
        start, cur_len = i[I_START], i[I_CURLEN]

        # ---- tap read at the TRUE code phase ----
        d_s = (start - s_reg[:, kk]).to(f32)
        rem_eff = (d_s + rem_code) * (1.0 + delta / _f32(spec.chip_rate))
        taps_r, taps_i = [], []
        for k in range(K):
            pos = (_f32(spec.lag_margin) + rem_eff
                   - _f32(spec.shifts_chips[k] * spec.spc_samples))
            w = torch.clamp(1.0 - torch.abs(pos[:, None] - lag), min=0.0)
            taps_r.append(torch.sum(zr[:, kk] * w, dim=1))
            taps_i.append(torch.sum(zi[:, kk] * w, dim=1))

        # ---- rotate into the true-NCO frame ----
        step_true = _TWO_PI * (doppler + carr_off) / _f32(spec.fs)
        dphi_mid = dphi + (step_true - step0) * 0.5 * cur_len.to(f32)
        rc = torch.cos(dphi_mid)
        rs = torch.sin(dphi_mid)
        corr_r = [taps_r[k] * rc + taps_i[k] * rs for k in range(K)]
        corr_i = [taps_i[k] * rc - taps_r[k] * rs for k in range(K)]

        f, i, out_f[kk], out_i[kk], out_corr[kk], valid = loop_close_plain(
            spec, consts, f, i, corr_r, corr_i, sec_rows)

        # --- frozen-vs-true phase ledger ---
        step_new = _TWO_PI * (f[F_DOPPLER] + carr_off) / _f32(spec.fs)
        dphi_next = (dphi + step_new * i[I_CURLEN].to(f32)
                     - step0 * cur_len.to(f32))
        dphi = torch.where(valid,
                           mod_floor(dphi_next + _PI, _TWO_PI) - _PI, dphi)
    return out_f, out_i, out_corr, f, i


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/track_chain.cu)
# ---------------------------------------------------------------------------

MAX_K = 5          # tap arrays in ChainParams


class ChainParams(ctypes.Structure):
    """Mirror of `ChainParams` in csrc/track_chain.cu (passed by value to the
    kernel; every float is the float32 value the plain version uses)."""

    _fields_ = [
        ("E", ctypes.c_int), ("LW", ctypes.c_int), ("K", ctypes.c_int),
        ("C", ctypes.c_int), ("sec_len", ctypes.c_int), ("P", ctypes.c_int),
        ("order", ctypes.c_int), ("sec_data", ctypes.c_int),
        ("ext_n", ctypes.c_int), ("half_n", ctypes.c_int),
        ("cn0_samples", ctypes.c_int), ("max_lock_fail", ctypes.c_int),
        ("fll_narrow_windows", ctypes.c_int), ("fll_epochs", ctypes.c_int),
        ("t0_int", ctypes.c_int),
        ("lag_margin", ctypes.c_float),
        ("shift_samp", ctypes.c_float * MAX_K),
        ("chip_rate", ctypes.c_float), ("fs", ctypes.c_float),
        ("cr_over_fc", ctypes.c_float), ("t0_int_f", ctypes.c_float),
        ("t0_frac", ctypes.c_float), ("code_period_s", ctypes.c_float),
        ("t_half", ctypes.c_float), ("t_ext", ctypes.c_float),
        ("cn0_samples_f", ctypes.c_float), ("cn0_min_dbhz", ctypes.c_float),
        ("carrier_lock_th", ctypes.c_float),
        ("pll_base", ctypes.c_float * 8), ("pll_slope", ctypes.c_float * 8),
        ("bin_base", ctypes.c_float * 4), ("bin_slope", ctypes.c_float * 4),
        ("bout_base", ctypes.c_float * 3), ("bout_slope", ctypes.c_float * 3),
    ]


@functools.lru_cache(maxsize=32)
def chain_params(spec: ChainSpec) -> ChainParams:
    """The kernel's by-value constants for one spec (built once per spec;
    the C entry copies the struct before it launches)."""
    if spec.K not in (3, 5) or spec.veml != (spec.K == 5):
        raise ValueError("the chain kernel takes K=3 (EPL) or K=5 (VEML)")
    if spec.prompt_index != spec.K // 2 or spec.order not in (2, 3):
        raise ValueError("the chain kernel takes the prompt at K // 2 and "
                         "PLL order 2 or 3")
    p = ChainParams()
    p.E, p.LW, p.K, p.C = spec.E, spec.LW, spec.K, spec.C
    p.sec_len, p.P = spec.sec_len, spec.prompt_index
    p.order, p.sec_data = spec.order, int(spec.sec_data)
    p.ext_n, p.half_n = spec.ext_n, spec.ext_n // 2
    p.cn0_samples, p.max_lock_fail = spec.cn0_samples, spec.max_lock_fail
    p.fll_narrow_windows, p.fll_epochs = (spec.fll_narrow_windows,
                                          spec.fll_epochs)
    p.t0_int = spec.t0_int
    p.lag_margin = _f32(spec.lag_margin)
    for k in range(spec.K):
        p.shift_samp[k] = _f32(spec.shifts_chips[k] * spec.spc_samples)
    p.chip_rate, p.fs = _f32(spec.chip_rate), _f32(spec.fs)
    p.cr_over_fc = _f32(np.float32(spec.chip_rate)
                        / np.float32(spec.carrier_freq))
    p.t0_int_f, p.t0_frac = _f32(spec.t0_int), _f32(spec.t0_frac)
    p.code_period_s = _f32(spec.code_period_s)
    p.t_half = max(_f32((spec.ext_n // 2) * spec.code_period_s), _f32(1e-6))
    p.t_ext = _f32(spec.ext_n * spec.code_period_s)
    p.cn0_samples_f = _f32(spec.cn0_samples)
    p.cn0_min_dbhz = _f32(spec.cn0_min_dbhz)
    p.carrier_lock_th = _f32(spec.carrier_lock_th)
    for j in range(8):
        p.pll_base[j], p.pll_slope[j] = _sel_pair(spec.wide[j],
                                                  spec.narrow[j])
    for j in range(4):
        p.bin_base[j], p.bin_slope[j] = _sel_pair(spec.dll_b_in[j],
                                                  spec.dll_b_in_n[j])
    for j in range(3):
        p.bout_base[j], p.bout_slope[j] = _sel_pair(spec.dll_b_out[j],
                                                    spec.dll_b_out_n[j])
    return p


def check_tensor(t, name, shape, dtype):
    """Raise unless `t` is a contiguous CUDA tensor of this shape and type."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_inputs(spec: ChainSpec, zr, zi, s_reg, step0, sec_rows, fst, ist):
    """Device, dtype, shape and contiguity of the kernel's inputs."""
    E, LW, C = spec.E, spec.LW, spec.C
    f32, i32 = torch.float32, torch.int32
    check_tensor(zr, "zr", (C, E, LW), f32)
    check_tensor(zi, "zi", (C, E, LW), f32)
    check_tensor(s_reg, "s_reg", (C, E), i32)
    check_tensor(step0, "step0", (C,), f32)
    check_tensor(sec_rows, "sec_rows", (spec.sec_len, C), f32)
    check_tensor(fst, "fst", (n_frows(spec.K), C), f32)
    check_tensor(ist, "ist", (N_IROWS, C), i32)


def chain_cuda(spec: ChainSpec, zr, zi, s_reg, step0, sec_rows, fst, ist):
    """Launch the CUDA kernel once (one warp per channel, E epochs each)."""
    global launches
    from ._build import library

    check_inputs(spec, zr, zi, s_reg, step0, sec_rows, fst, ist)
    E, K, C = spec.E, spec.K, spec.C
    f32, i32 = torch.float32, torch.int32
    dev = zr.device
    out_f = torch.empty((E, N_OROWS, C), dtype=f32, device=dev)
    out_i = torch.empty((E, 2, C), dtype=i32, device=dev)
    out_corr = torch.empty((E, 2 * K, C), dtype=f32, device=dev)
    fst_out = torch.empty_like(fst)
    ist_out = torch.empty_like(ist)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().track_chain_launch(
        zr.data_ptr(), zi.data_ptr(), s_reg.data_ptr(), step0.data_ptr(),
        sec_rows.data_ptr(), fst.data_ptr(), ist.data_ptr(),
        out_f.data_ptr(), out_i.data_ptr(), out_corr.data_ptr(),
        fst_out.data_ptr(), ist_out.data_ptr(),
        ctypes.addressof(chain_params(spec)), stream)
    if err != 0:
        raise RuntimeError(f"track_chain kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out_f, out_i, out_corr, fst_out, ist_out


def chain(spec: ChainSpec, zr, zi, s_reg, step0, sec_rows, fst, ist):
    """Run the chain where its inputs lie: the CUDA kernel for CUDA
    tensors, the plain torch version for CPU tensors."""
    devs = {t.device.type for t in (zr, zi, s_reg, step0, sec_rows, fst,
                                    ist)}
    if devs == {"cuda"}:
        return chain_cuda(spec, zr, zi, s_reg, step0, sec_rows, fst, ist)
    if devs == {"cpu"}:
        return chain_plain(spec, zr, zi, s_reg, step0, sec_rows, fst, ist)
    raise ValueError(f"chain inputs must all lie on one device type, got "
                     f"{sorted(devs)}")
