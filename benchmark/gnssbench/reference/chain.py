"""Frozen copy of the port's plain tracking chain (its per-epoch loop
closure, the chunked tap read and the phase ledger), as the port's
`ops/track_chain.py` defines it in plain torch.  The benchmark's reference
runs this copy and never the port's code, so a later change to the port
cannot move the yardstick.  Rows: the port's F_* / I_* / O_* layout."""

from __future__ import annotations

import dataclasses

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


def loop_pre_plain(spec: ChainSpec, consts, f, i, sec_rows) -> dict:
    """The closure's state-only part: what it computes before the epoch's
    taps are in (csrc/loop_close.cuh `loop_pre`).  Every quantity is
    rounded as the whole closure rounds it."""
    f32, i32 = torch.float32, torch.int32
    _, bi, bo = consts
    active = i[I_ACTIVE] > 0
    valid = active & (i[I_START] < i[I_LIMIT])
    narrow = i[I_MODE] >= 1
    sec_on = i[I_SEC_ON] > 0
    cur_len = i[I_CURLEN]
    t_epoch = cur_len.to(f32) / _f32(spec.fs)
    if spec.sec_len > 1:
        idx_c = torch.clamp(i[I_SEC_IDX], max=spec.sec_len - 1).long()
        sec_chip = torch.gather(sec_rows, 0, idx_c[None, :])[0]
    else:
        sec_chip = sec_rows[0]
    cnt = i[I_EXTCNT] + 1
    boundary = narrow & (cnt >= spec.ext_n)
    upd = (~narrow) | boundary
    app = valid & upd
    push_count = i[I_PUSH] + app.to(i32)
    fll_on = i[I_FLL_ON] > 0
    epochs_in_track = i[I_EPOCHS] + 1
    fll_still_on = fll_on & torch.where(
        narrow, push_count < spec.fll_narrow_windows,
        epochs_in_track < spec.fll_epochs)
    reset_acc = boundary | ~narrow
    t_cn0 = torch.where(narrow,
                        torch.full_like(t_epoch, _f32(
                            spec.ext_n * spec.code_period_s)),
                        t_epoch)
    din = [f[F_DLL_IN0 + j] for j in range(3)]
    dout = [f[F_DLL_OUT0 + j] for j in range(3)]
    return {
        "active": active, "valid": valid, "validf": valid.to(f32),
        "narrow": narrow, "sec_on": sec_on, "t_epoch": t_epoch,
        "s": torch.where(sec_on, sec_chip, torch.ones_like(sec_chip)),
        "cnt": cnt, "boundary": boundary,
        "t_int": torch.where(narrow, cnt.to(f32) * _f32(spec.code_period_s),
                             t_epoch),
        "t_half": max(_f32(spec.ext_n // 2 * spec.code_period_s),
                      _f32(1e-6)),
        "fll_on": fll_on, "app": app, "appf": app.to(f32),
        "push_count": push_count,
        "window_done": app & (torch.remainder(push_count,
                                              spec.cn0_samples) == 0),
        "hist_full": push_count >= spec.cn0_samples,
        "cn0_t": 10.0 * torch.log10(t_cn0),
        "epochs_in_track": epochs_in_track, "fll_still_on": fll_still_on,
        "turnoff": narrow & fll_on & ~fll_still_on, "reset_acc": reset_acc,
        "racf": (~reset_acc).to(f32),
        "at_half": narrow & (cnt == spec.ext_n // 2),
        # the DLL filter's terms that do not read the discriminator: its
        # left-to-right sum up to it, and the products after it
        "dll_head": bo[0] * dout[0] + bo[1] * dout[1] + bo[2] * dout[2],
        "dll_tail": [bi[1] * din[0], bi[2] * din[1], bi[3] * din[2]],
    }


def loop_post_plain(spec: ChainSpec, consts, pre, f, i, corr_r, corr_i):
    """The closure once the epoch's taps are in: the secondary wipe and the
    extended accumulation, the discriminators, the PLL cascade, the DLL
    filter, the NCO step, the lock supervision, the merge by `valid`, the
    epoch's output rows and the carried state (csrc/loop_close.cuh
    `loop_post`).  Returns what loop_close_plain returns."""
    K, P = spec.K, spec.prompt_index
    i32 = torch.int32
    zero = torch.zeros_like(f[0])
    (w0p, w0p2, w0p3, w0f, w0f2, a2, a3, b3), bi, _ = consts
    valid, app, narrow = pre["valid"], pre["app"], pre["narrow"]
    fll_on, t_int = pre["fll_on"], pre["t_int"]
    carr_off = f[F_CARR_OFF]
    rem_code, delta, doppler = f[F_REM_CODE], f[F_DELTA], f[F_DOPPLER]
    rem_carr, cw, cx = f[F_REM_CARR], f[F_CARR_W], f[F_CARR_X]
    prev_r, prev_i = f[F_PREV_R], f[F_PREV_I]
    acch_r, acch_i = f[F_ACCH_R], f[F_ACCH_I]
    din = [f[F_DLL_IN0 + j] for j in range(3)]
    dout = [f[F_DLL_OUT0 + j] for j in range(3)]
    s = pre["s"]
    cw_r = [corr_r[k] * s for k in range(K)]
    cw_i = [corr_i[k] * s for k in range(K)]
    acc_r = [f[F_ACC_R0 + k] + cw_r[k] for k in range(K)]
    acc_i = [f[F_ACC_R0 + K + k] + cw_i[k] for k in range(K)]
    disc_r = [torch.where(narrow, acc_r[k], cw_r[k]) for k in range(K)]
    disc_i = [torch.where(narrow, acc_i[k], cw_i[k]) for k in range(K)]
    pw_r, pw_i = cw_r[P], cw_i[P]
    dp_r, dp_i = disc_r[P], disc_i[P]

    # --- carrier discriminators (A.3) ---
    costas = torch.where(
        dp_r != 0.0,
        torch.atan2(dp_i * torch.sign(dp_r), torch.abs(dp_r)),
        zero) / _TWO_PI
    if spec.sec_data:
        carr_err_cyc = costas
    else:
        carr_err_cyc = torch.where(pre["sec_on"],
                                   torch.atan2(dp_i, dp_r) / _TWO_PI, costas)
    dot = prev_r * pw_r + prev_i * pw_i
    cross = prev_r * pw_i - pw_r * prev_i
    freq_err_hz = torch.atan2(cross, dot) / pre["t_epoch"] / _TWO_PI
    p2_r = acc_r[P] - acch_r
    p2_i = acc_i[P] - acch_i
    dot_h = acch_r * p2_r + acch_i * p2_i
    cross_h = acch_r * p2_i - p2_r * acch_i
    h_mag = acch_r * acch_r + acch_i * acch_i
    freq_err_ext = torch.where(
        (h_mag > 0.0) & pre["boundary"],
        torch.atan2(cross_h, dot_h) / pre["t_half"] / _TWO_PI, zero)
    pll_in = carr_err_cyc
    fll_in = torch.where(fll_on & ~narrow & (i[I_PUSH] > 0), freq_err_hz,
                         zero)
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
    tail = pre["dll_tail"]
    code_err_filt = (pre["dll_head"] + bi[0] * code_err + tail[0] + tail[1]
                     + tail[2])
    din_new = (code_err, din[0], din[1])
    dout_new = (code_err_filt, dout[0], dout[1])

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
        rem_carr + carr_step_new * next_len.to(torch.float32), _TWO_PI)

    # --- CN0 / lock supervision on window accumulators (A.7) ---
    appf = pre["appf"]
    s_absi = f[F_SABSI] + appf * torch.abs(dp_r)
    s_i2 = f[F_SI2] + appf * dp_r * dp_r
    s_q2 = f[F_SQ2] + appf * dp_i * dp_i
    window_done = pre["window_done"]
    m = _f32(spec.cn0_samples)
    psig = (s_absi / m) ** 2
    ptot = (s_i2 + s_q2) / m
    noise = torch.clamp(ptot - psig, min=_TINY)
    cn0 = (10.0 * torch.log10(torch.clamp(psig / noise, min=_f32(1e-10)))
           - pre["cn0_t"])
    carrier_lock = (s_i2 - s_q2) / torch.clamp(s_i2 + s_q2, min=_TINY)
    cn0_last = torch.where(window_done, cn0, f[F_CN0])
    s_absi = torch.where(window_done, zero, s_absi)
    s_i2 = torch.where(window_done, zero, s_i2)
    s_q2 = torch.where(window_done, zero, s_q2)
    check_now = window_done & ~fll_on
    fail = check_now & ((cn0 < spec.cn0_min_dbhz)
                        | (carrier_lock < spec.carrier_lock_th))
    ok = check_now & ~fail
    lockfail0 = i[I_LOCKFAIL]
    lock_fail = torch.where(
        fail, lockfail0 + 1,
        torch.where(ok, torch.clamp(lockfail0 - 1, min=0), lockfail0))
    still_active = pre["active"] & (lock_fail <= spec.max_lock_fail)

    if spec.order == 3:
        seed_w = torch.zeros_like(doppler_m)
        seed_x = 2.0 * doppler_m
    else:
        seed_w = doppler_m
        seed_x = torch.zeros_like(doppler_m)
    tv = pre["turnoff"] & valid
    cw_m = torch.where(tv, seed_w, cw_m)
    cx_m = torch.where(tv, seed_x, cx_m)

    racf = pre["racf"]
    acc_r_new = [acc_r[k] * racf for k in range(K)]
    acc_i_new = [acc_i[k] * racf for k in range(K)]
    at_half = pre["at_half"]
    acch_r_new = racf * torch.where(at_half, acc_r[P], acch_r)
    acch_i_new = racf * torch.where(at_half, acc_i[P], acch_i)

    # --- merge by valid: a dead channel never takes new state ---
    def mv(n, o):
        return torch.where(valid, n, o)

    active_i, start, cur_len = i[I_ACTIVE], i[I_START], i[I_CURLEN]
    validf = pre["validf"]
    merged_dopp = mv(doppler_m, doppler)
    merged_active = mv(still_active.to(i32), active_i)
    merged_cn0 = mv(cn0_last, f[F_CN0])
    merged_delta = mv(delta_m, delta)
    merged_rem_code = mv(rem_code_new, rem_code)
    merged_rem_carr = mv(rem_carr_new, rem_carr)
    new_cur = mv(next_len, cur_len)

    # --- per-epoch outputs ---
    out_f = torch.stack([
        merged_dopp, merged_delta, merged_rem_code, merged_rem_carr,
        torch.where(valid & pre["hist_full"], merged_cn0, zero), validf,
        merged_active.to(torch.float32)])
    out_i = torch.stack([start, cur_len])
    out_corr = torch.stack([validf * corr_r[k] for k in range(K)]
                           + [validf * corr_i[k] for k in range(K)])

    cnt, reset_acc = pre["cnt"], pre["reset_acc"]
    f_new = torch.stack(
        [merged_rem_code, merged_delta, merged_dopp, merged_rem_carr,
         mv(cw_m, cw), mv(cx_m, cx), mv(pw_r, f[F_PREV_R]),
         mv(pw_i, f[F_PREV_I]), mv(s_absi, f[F_SABSI]), mv(s_i2, f[F_SI2]),
         mv(s_q2, f[F_SQ2]), merged_cn0, mv(acch_r_new, acch_r),
         mv(acch_i_new, acch_i), carr_off]
        + din_m + dout_m
        + [mv(acc_r_new[k], f[F_ACC_R0 + k]) for k in range(K)]
        + [mv(acc_i_new[k], f[F_ACC_R0 + K + k]) for k in range(K)])
    sec_idx = i[I_SEC_IDX]
    i_new = torch.stack(
        [merged_active, mv(start + cur_len, start), new_cur,
         mv(pre["push_count"], i[I_PUSH]), mv(lock_fail, lockfail0),
         mv(pre["epochs_in_track"], i[I_EPOCHS]),
         mv(pre["fll_still_on"].to(i32), i[I_FLL_ON]), i[I_MODE],
         mv(torch.where(reset_acc, torch.zeros_like(cnt), cnt),
            i[I_EXTCNT]),
         i[I_SEC_ON], mv(torch.remainder(sec_idx + 1, spec.sec_len),
                         sec_idx), i[I_LIMIT]]).to(i32)
    return f_new, i_new, out_f, out_i, out_corr, valid


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
    (ops.gather_block) both close their epochs here.

    It is the composition of two parts, as csrc/loop_close.cuh splits it:
    the state-only part (`loop_pre_plain`) and the rest, from the taps on
    (`loop_post_plain`)."""
    pre = loop_pre_plain(spec, consts, f, i, sec_rows)
    return loop_post_plain(spec, consts, pre, f, i, corr_r, corr_i)


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
