// One epoch's loop closure of one channel, shared by the tracking chain
// (track_chain.cu) and the gather walk (gather_block.cu): the JAX
// package's `_loop_update` (gnss_sdr_1_tpu/track/engine.py:548-782), as
// gnss_sdr_1_tpu_torch/ops/track_chain.py:loop_close_plain computes it.
//
// From the epoch's K taps (true-NCO frame) and the channel's state: the
// secondary wipe, the extended coherent accumulation, the Costas /
// four-quadrant PLL and the FLL discriminators, the FLL-assisted PLL of
// order 2/3 with its wide/narrow select, the EPL/VEML DLL with its IIR
// filter, the A.6 split-precision NCO step, the SNV CN0 estimator with the
// carrier-lock supervision and the FLL turn-off seeding, merged by
// `valid`; writes the epoch's output rows and carries the state.
//
// It is split around the correlation as the plain version is: the
// state-only part (`loop_pre`) and the rest, from the taps on
// (`loop_post`); `loop_close` composes them on one thread (the chain), the
// gather walk runs the first beside its correlation.
//
// The state is a struct the caller keeps where it likes (the chain in
// registers over its chunk, the gather walk in shared memory between
// epochs); everything is indexed by constants, so with the function
// inlined the struct lives in registers and takes no stack frame.  Every
// operation rounds as the plain version's does (build with --fmad=false,
// without --use_fast_math).

#pragma once

#include "rows.cuh"

#define MAX_K 5
#define TINY_F 1.17549435e-38f

// Mirror of ops/track_chain.py ChainParams: the loop constants (and the
// chain's lag geometry, which the closure does not read).
struct ChainParams {
    int E, LW, K, C, sec_len, P, order, sec_data;
    int ext_n, half_n, cn0_samples, max_lock_fail;
    int fll_narrow_windows, fll_epochs, t0_int;
    float lag_margin;
    float shift_samp[MAX_K];
    float chip_rate, fs, cr_over_fc, t0_int_f, t0_frac, code_period_s;
    float t_half, t_ext, cn0_samples_f, cn0_min_dbhz, carrier_lock_th;
    float pll_base[8], pll_slope[8];
    float bin_base[4], bin_slope[4];
    float bout_base[3], bout_slope[3];
};

// numpy/JAX `sign`: sign(0) == 0 (copysignf would give +-1).
__device__ __forceinline__ float sign0(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// One channel's loop state: the columns of the state rows (F_* / I_*).
template <int K>
struct LoopState {
    float rem_code, delta, doppler, rem_carr, cw, cx, prev_r, prev_i;
    float sabsi, si2, sq2, cn0_old, acch_r, acch_i, carr_off;
    float din[3], dout[3], accr[K], acci[K];
    int active_i, start, cur_len, push, lockfail, epochs, fllon_i, mode0;
    int extcnt, sec_on_i, sec_idx, limit;
};

// Column c of rows laid out [row][ld].
template <int K>
__device__ __forceinline__ void load_state(LoopState<K>& st, const float* f,
                                           const int* i, int ld, int c) {
    st.rem_code = f[F_REM_CODE * ld + c];
    st.delta = f[F_DELTA * ld + c];
    st.doppler = f[F_DOPPLER * ld + c];
    st.rem_carr = f[F_REM_CARR * ld + c];
    st.cw = f[F_CARR_W * ld + c];
    st.cx = f[F_CARR_X * ld + c];
    st.prev_r = f[F_PREV_R * ld + c];
    st.prev_i = f[F_PREV_I * ld + c];
    st.sabsi = f[F_SABSI * ld + c];
    st.si2 = f[F_SI2 * ld + c];
    st.sq2 = f[F_SQ2 * ld + c];
    st.cn0_old = f[F_CN0 * ld + c];
    st.acch_r = f[F_ACCH_R * ld + c];
    st.acch_i = f[F_ACCH_I * ld + c];
    st.carr_off = f[F_CARR_OFF * ld + c];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        st.din[j] = f[(F_DLL_IN0 + j) * ld + c];
        st.dout[j] = f[(F_DLL_OUT0 + j) * ld + c];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        st.accr[k] = f[(F_ACC_R0 + k) * ld + c];
        st.acci[k] = f[(F_ACC_R0 + K + k) * ld + c];
    }
    st.active_i = i[I_ACTIVE * ld + c];
    st.start = i[I_START * ld + c];
    st.cur_len = i[I_CURLEN * ld + c];
    st.push = i[I_PUSH * ld + c];
    st.lockfail = i[I_LOCKFAIL * ld + c];
    st.epochs = i[I_EPOCHS * ld + c];
    st.fllon_i = i[I_FLL_ON * ld + c];
    st.mode0 = i[I_MODE * ld + c];
    st.extcnt = i[I_EXTCNT * ld + c];
    st.sec_on_i = i[I_SEC_ON * ld + c];
    st.sec_idx = i[I_SEC_IDX * ld + c];
    st.limit = i[I_LIMIT * ld + c];
}

template <int K>
__device__ __forceinline__ void store_state(const LoopState<K>& st, float* f,
                                            int* i, int ld, int c) {
    f[F_REM_CODE * ld + c] = st.rem_code;
    f[F_DELTA * ld + c] = st.delta;
    f[F_DOPPLER * ld + c] = st.doppler;
    f[F_REM_CARR * ld + c] = st.rem_carr;
    f[F_CARR_W * ld + c] = st.cw;
    f[F_CARR_X * ld + c] = st.cx;
    f[F_PREV_R * ld + c] = st.prev_r;
    f[F_PREV_I * ld + c] = st.prev_i;
    f[F_SABSI * ld + c] = st.sabsi;
    f[F_SI2 * ld + c] = st.si2;
    f[F_SQ2 * ld + c] = st.sq2;
    f[F_CN0 * ld + c] = st.cn0_old;
    f[F_ACCH_R * ld + c] = st.acch_r;
    f[F_ACCH_I * ld + c] = st.acch_i;
    f[F_CARR_OFF * ld + c] = st.carr_off;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        f[(F_DLL_IN0 + j) * ld + c] = st.din[j];
        f[(F_DLL_OUT0 + j) * ld + c] = st.dout[j];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        f[(F_ACC_R0 + k) * ld + c] = st.accr[k];
        f[(F_ACC_R0 + K + k) * ld + c] = st.acci[k];
    }
    i[I_ACTIVE * ld + c] = st.active_i;
    i[I_START * ld + c] = st.start;
    i[I_CURLEN * ld + c] = st.cur_len;
    i[I_PUSH * ld + c] = st.push;
    i[I_LOCKFAIL * ld + c] = st.lockfail;
    i[I_EPOCHS * ld + c] = st.epochs;
    i[I_FLL_ON * ld + c] = st.fllon_i;
    i[I_MODE * ld + c] = st.mode0;
    i[I_EXTCNT * ld + c] = st.extcnt;
    i[I_SEC_ON * ld + c] = st.sec_on_i;
    i[I_SEC_IDX * ld + c] = st.sec_idx;
    i[I_LIMIT * ld + c] = st.limit;
}

// The wide/narrow constant select of a channel in mode `mode0` (fixed
// while a launch runs: only the host switches a channel's mode).
struct LoopConsts {
    float pll[8], bi[4], bo[3];
};

__device__ __forceinline__ LoopConsts loop_consts(const ChainParams& p,
                                                  int mode0) {
    const float narrow_f = mode0 >= 1 ? 1.0f : 0.0f;
    LoopConsts lc;
#pragma unroll
    for (int j = 0; j < 8; ++j)
        lc.pll[j] = p.pll_base[j] + narrow_f * p.pll_slope[j];
#pragma unroll
    for (int j = 0; j < 4; ++j)
        lc.bi[j] = p.bin_base[j] + narrow_f * p.bin_slope[j];
#pragma unroll
    for (int j = 0; j < 3; ++j)
        lc.bo[j] = p.bout_base[j] + narrow_f * p.bout_slope[j];
    return lc;
}

// The closure's state-only part: what it computes before the epoch's taps
// are in (ops/track_chain.py loop_pre_plain).  `s`: the secondary chip the
// wipe multiplies by (1 where the wipe is off).
struct LoopPre {
    float t_epoch, s, t_int, appf, validf, cn0_t, racf, dll_head;
    float dll_tail[3];
    int cnt, push_count, epochs_in_track;
    bool active, valid, narrow, sec_on, boundary, fll_on, app, window_done,
        hist_full, fll_still_on, turnoff, reset_acc, at_half;
};

template <int K>
__device__ __forceinline__ LoopPre loop_pre(const ChainParams& p,
                                            const LoopConsts& lc,
                                            const LoopState<K>& st,
                                            float s) {
    LoopPre q;
    q.active = st.active_i > 0;
    q.valid = q.active && (st.start < st.limit);
    q.validf = q.valid ? 1.0f : 0.0f;
    q.narrow = st.mode0 >= 1;
    q.sec_on = st.sec_on_i > 0;
    q.t_epoch = (float)st.cur_len / p.fs;
    q.s = s;
    q.cnt = st.extcnt + 1;
    q.boundary = q.narrow && (q.cnt >= p.ext_n);
    const bool upd = (!q.narrow) || q.boundary;
    q.t_int = q.narrow ? (float)q.cnt * p.code_period_s : q.t_epoch;
    q.fll_on = st.fllon_i > 0;
    q.app = q.valid && upd;
    q.appf = q.app ? 1.0f : 0.0f;
    q.push_count = st.push + (q.app ? 1 : 0);
    q.window_done = q.app && (q.push_count % p.cn0_samples == 0);
    q.hist_full = q.push_count >= p.cn0_samples;
    const float t_cn0 = q.narrow ? p.t_ext : q.t_epoch;
    q.cn0_t = 10.0f * log10f(t_cn0);
    q.epochs_in_track = st.epochs + 1;
    q.fll_still_on = q.fll_on && (q.narrow
        ? (q.push_count < p.fll_narrow_windows)
        : (q.epochs_in_track < p.fll_epochs));
    q.turnoff = q.narrow && q.fll_on && !q.fll_still_on;
    q.reset_acc = q.boundary || !q.narrow;
    q.racf = q.reset_acc ? 0.0f : 1.0f;
    q.at_half = q.narrow && (q.cnt == p.half_n);
    // the DLL filter's terms that do not read the discriminator: its
    // left-to-right sum up to it, and the products after it
    q.dll_head = lc.bo[0] * st.dout[0] + lc.bo[1] * st.dout[1]
        + lc.bo[2] * st.dout[2];
    q.dll_tail[0] = lc.bi[1] * st.din[0];
    q.dll_tail[1] = lc.bi[2] * st.din[1];
    q.dll_tail[2] = lc.bi[3] * st.din[2];
    return q;
}

// The closure once the epoch's taps are in: the secondary wipe and the
// extended accumulation, the discriminators, the PLL cascade, the DLL
// filter, the NCO step, the lock supervision, the merge by `valid`, the
// epoch's output rows and the carry (ops/track_chain.py loop_post_plain).
// `corr_r` / `corr_i`: the K taps; `of` / `oi` / `oc`: the channel's column
// of the epoch's output rows (row stride C).  Carries `st` where the epoch
// is valid and returns whether it was.
template <int K, int ORDER, bool SEC_DATA>
__device__ __forceinline__ bool loop_post(const ChainParams& p,
                                          const LoopConsts& lc,
                                          LoopState<K>& st, const LoopPre& q,
                                          const float corr_r[K],
                                          const float corr_i[K], float* of,
                                          int* oi, float* oc, int C) {
    constexpr int P = K / 2;
    const bool valid = q.valid;
    const float w0p = lc.pll[0], w0p2 = lc.pll[1], w0p3 = lc.pll[2];
    const float w0f = lc.pll[3], w0f2 = lc.pll[4], a2 = lc.pll[5];
    const float a3 = lc.pll[6], b3 = lc.pll[7];
    const float* bi = lc.bi;
    float cw_r[K], cw_i[K], acc_r[K], acc_i[K], disc_r[K], disc_i[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        cw_r[k] = corr_r[k] * q.s;
        cw_i[k] = corr_i[k] * q.s;
        acc_r[k] = st.accr[k] + cw_r[k];
        acc_i[k] = st.acci[k] + cw_i[k];
        disc_r[k] = q.narrow ? acc_r[k] : cw_r[k];
        disc_i[k] = q.narrow ? acc_i[k] : cw_i[k];
    }
    const float dp_r = disc_r[P], dp_i = disc_i[P];
    const float pw_r = cw_r[P], pw_i = cw_i[P];

    // --- carrier discriminators (A.3) ---
    const float costas = (dp_r != 0.0f
        ? atan2f(dp_i * sign0(dp_r), fabsf(dp_r)) : 0.0f) / TWO_PI_F;
    float carr_err_cyc;
    if (SEC_DATA || !q.sec_on) {
        carr_err_cyc = costas;
    } else {
        carr_err_cyc = atan2f(dp_i, dp_r) / TWO_PI_F;
    }
    const float dot = st.prev_r * pw_r + st.prev_i * pw_i;
    const float cross = st.prev_r * pw_i - pw_r * st.prev_i;
    const float freq_err_hz = atan2f(cross, dot) / q.t_epoch / TWO_PI_F;
    const float p2_r = acc_r[P] - st.acch_r;
    const float p2_i = acc_i[P] - st.acch_i;
    const float dot_h = st.acch_r * p2_r + st.acch_i * p2_i;
    const float cross_h = st.acch_r * p2_i - p2_r * st.acch_i;
    const float h_mag = st.acch_r * st.acch_r + st.acch_i * st.acch_i;
    const float freq_err_ext = (h_mag > 0.0f && q.boundary)
        ? atan2f(cross_h, dot_h) / p.t_half / TWO_PI_F : 0.0f;
    const float pll_in = carr_err_cyc;
    float fll_in = (q.fll_on && !q.narrow && st.push > 0) ? freq_err_hz
                                                          : 0.0f;
    if (q.narrow && q.fll_on) fll_in = freq_err_ext;
    const float t_int = q.t_int;

    // --- FLL-assisted PLL cascade (A.5) ---
    float w_new, x_new, doppler_new;
    if (ORDER == 3) {
        w_new = st.cw + t_int * (w0p3 * pll_in + w0f2 * fll_in);
        x_new = st.cx + t_int * (0.5f * w_new + a2 * w0f * fll_in
                                 + a3 * w0p2 * pll_in);
        doppler_new = 0.5f * x_new + b3 * w0p * pll_in;
    } else {
        w_new = st.cw + t_int * (w0p2 * pll_in + w0f * fll_in);
        doppler_new = 0.5f * (w_new + st.cw) + a2 * w0p * pll_in;
        x_new = st.cx;
    }

    // --- DLL (A.3/A.5) ---
    float code_err;
    if (K == 5) {
        const float pe = sqrtf(disc_r[0] * disc_r[0] + disc_i[0] * disc_i[0]
                               + disc_r[1] * disc_r[1] + disc_i[1] * disc_i[1]);
        const float pl = sqrtf(disc_r[K - 2] * disc_r[K - 2]
                               + disc_i[K - 2] * disc_i[K - 2]
                               + disc_r[K - 1] * disc_r[K - 1]
                               + disc_i[K - 1] * disc_i[K - 1]);
        const float ssum = pe + pl;
        code_err = ssum > 0.0f ? (pe - pl) / ssum : 0.0f;
    } else {
        const float e = sqrtf(disc_r[0] * disc_r[0] + disc_i[0] * disc_i[0]);
        const float l = sqrtf(disc_r[K - 1] * disc_r[K - 1]
                              + disc_i[K - 1] * disc_i[K - 1]);
        const float ssum = e + l;
        code_err = ssum > 0.0f ? 0.5f * (e - l) / ssum : 0.0f;
    }
    const float code_err_filt = q.dll_head + bi[0] * code_err
        + q.dll_tail[0] + q.dll_tail[1] + q.dll_tail[2];

    const bool app = q.app;
    float cw_m = app ? w_new : st.cw;
    float cx_m = app ? x_new : st.cx;
    float din_m[3], dout_m[3];
    din_m[0] = app ? code_err : st.din[0];
    din_m[1] = app ? st.din[0] : st.din[1];
    din_m[2] = app ? st.din[1] : st.din[2];
    dout_m[0] = app ? code_err_filt : st.dout[0];
    dout_m[1] = app ? st.dout[0] : st.dout[1];
    dout_m[2] = app ? st.dout[1] : st.dout[2];
    const float doppler_m = app ? doppler_new : st.doppler;
    const float delta_m = app ? (p.cr_over_fc * doppler_new - code_err_filt)
                              : st.delta;

    // --- NCO stepping / next length (A.6 split precision) ---
    const float ncf = p.chip_rate + delta_m;
    const float d_t = (-p.t0_int_f) * delta_m / ncf - p.t0_frac * delta_m / ncf;
    const float frac = (p.t0_frac + d_t) + st.rem_code;
    const float frac_floor = floorf(frac);
    const int next_len = p.t0_int + (int)frac_floor;
    const float rem_code_new = frac - frac_floor;
    const float carr_step_new = TWO_PI_F * (doppler_m + st.carr_off) / p.fs;
    const float rem_carr_new =
        mod_floor(st.rem_carr + carr_step_new * (float)next_len, TWO_PI_F);

    // --- CN0 / lock supervision on window accumulators (A.7) ---
    const float appf = q.appf;
    float s_absi = st.sabsi + appf * fabsf(dp_r);
    float s_i2 = st.si2 + appf * dp_r * dp_r;
    float s_q2 = st.sq2 + appf * dp_i * dp_i;
    const bool window_done = q.window_done;
    const float m = p.cn0_samples_f;
    const float am = s_absi / m;
    const float psig = am * am;
    const float ptot = (s_i2 + s_q2) / m;
    const float noise = fmaxf(ptot - psig, TINY_F);
    const float cn0 = 10.0f * log10f(fmaxf(psig / noise, 1e-10f)) - q.cn0_t;
    const float carrier_lock = (s_i2 - s_q2) / fmaxf(s_i2 + s_q2, TINY_F);
    const float cn0_last = window_done ? cn0 : st.cn0_old;
    if (window_done) { s_absi = 0.0f; s_i2 = 0.0f; s_q2 = 0.0f; }
    const bool check_now = window_done && !q.fll_on;
    const bool fail = check_now && ((cn0 < p.cn0_min_dbhz)
                                    || (carrier_lock < p.carrier_lock_th));
    const bool ok = check_now && !fail;
    const int lock_fail = fail ? st.lockfail + 1
                               : (ok ? max(st.lockfail - 1, 0) : st.lockfail);
    const bool still_active = q.active && (lock_fail <= p.max_lock_fail);

    if (q.turnoff && valid) {
        if (ORDER == 3) { cw_m = 0.0f; cx_m = 2.0f * doppler_m; }
        else { cw_m = doppler_m; cx_m = 0.0f; }
    }

    const float racf = q.racf;
    const float acch_r_new = racf * (q.at_half ? acc_r[P] : st.acch_r);
    const float acch_i_new = racf * (q.at_half ? acc_i[P] : st.acch_i);

    // --- merge by valid: a dead channel never takes new state ---
    const float merged_dopp = valid ? doppler_m : st.doppler;
    const int merged_active = valid ? (still_active ? 1 : 0) : st.active_i;
    const float merged_cn0 = valid ? cn0_last : st.cn0_old;
    const float merged_delta = valid ? delta_m : st.delta;
    const float merged_rem_code = valid ? rem_code_new : st.rem_code;
    const float merged_rem_carr = valid ? rem_carr_new : st.rem_carr;
    const int new_cur = valid ? next_len : st.cur_len;

    // --- per-epoch outputs ---
    const float validf = q.validf;
    of[O_DOPPLER * C] = merged_dopp;
    of[O_DELTA * C] = merged_delta;
    of[O_REM_CODE * C] = merged_rem_code;
    of[O_REM_CARR * C] = merged_rem_carr;
    of[O_CN0 * C] = (valid && q.hist_full) ? merged_cn0 : 0.0f;
    of[O_VALID * C] = validf;
    of[O_ACTIVE * C] = (float)merged_active;
    oi[0] = st.start;
    oi[C] = st.cur_len;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        oc[k * C] = validf * corr_r[k];
        oc[(K + k) * C] = validf * corr_i[k];
    }

    // --- carry ---
    if (valid) {
        st.rem_code = merged_rem_code;
        st.delta = merged_delta;
        st.doppler = merged_dopp;
        st.rem_carr = merged_rem_carr;
        st.cw = cw_m;
        st.cx = cx_m;
        st.prev_r = pw_r;
        st.prev_i = pw_i;
        st.sabsi = s_absi;
        st.si2 = s_i2;
        st.sq2 = s_q2;
        st.cn0_old = merged_cn0;
        st.acch_r = acch_r_new;
        st.acch_i = acch_i_new;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            st.din[j] = din_m[j];
            st.dout[j] = dout_m[j];
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
            st.accr[k] = acc_r[k] * racf;
            st.acci[k] = acc_i[k] * racf;
        }
        st.active_i = merged_active;
        st.start = st.start + st.cur_len;
        st.cur_len = new_cur;
        st.push = q.push_count;
        st.lockfail = lock_fail;
        st.epochs = q.epochs_in_track;
        st.fllon_i = q.fll_still_on ? 1 : 0;
        st.extcnt = q.reset_acc ? 0 : q.cnt;
        st.sec_idx = (st.sec_idx + 1) % p.sec_len;
    }
    return valid;
}

// Close the loops of one channel for one epoch on one thread: the state-
// only part and the rest, composed.  `corr_r` /
// `corr_i`: the K taps; `s`: the secondary chip the wipe multiplies by (1
// where the wipe is off); `of` / `oi` / `oc`: the channel's column of the
// epoch's output rows (row stride C).  Carries `st` where the epoch is
// valid and returns whether it was.
template <int K, int ORDER, bool SEC_DATA>
__device__ __forceinline__ bool loop_close(const ChainParams& p,
                                           const LoopConsts& lc,
                                           LoopState<K>& st,
                                           const float corr_r[K],
                                           const float corr_i[K], float s,
                                           float* of, int* oi, float* oc,
                                           int C) {
    const LoopPre q = loop_pre<K>(p, lc, st, s);
    return loop_post<K, ORDER, SEC_DATA>(p, lc, st, q, corr_r, corr_i, of,
                                         oi, oc, C);
}
