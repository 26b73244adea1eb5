// Fused per-epoch tracking chain for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gnss_sdr_1_tpu/ops/pallas_chain.py
// (`_make_kernel`, built by `make_chain_call`).  Computes exactly what the
// plain torch version gnss_sdr_1_tpu_torch/ops/track_chain.py:chain_plain
// computes: for E epochs x C channels, the sequential per-epoch loop closure
// of the chunked DLL/PLL tracking engine, with the loop state carried from
// epoch to epoch.
//
// Design: one thread per channel, each thread loops over the E epochs with
// the whole state in registers.  The only device-memory traffic is the lag
// window of each epoch (two interpolation lags per tap) and the per-epoch
// output rows.  Layout stays [E, LW, C] / [ROWS, C] with the channel index
// innermost, so neighbouring threads read neighbouring addresses.
//
// What bounds it: per 16-epoch chunk at C = 12 channels it reads about
// 104 KB (zr + zi = 2 x 16 x 68 x 12 x 4 B; the kernel itself touches only
// 2 lags x K taps of each window) and writes about 12 KB, a few hundred
// flops per epoch and channel.  Neither bytes nor flops bound it: the time
// is the serial chain of E dependent epochs in one thread (transcendentals
// and divisions on the critical path) plus the launch cost.  Making it fast
// waits for a later change: a persistent kernel that walks the whole chunk
// loop, or a CUDA graph over the chunk loop, are the candidates.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, WITHOUT
// --use_fast_math, so atan2f / sincosf / log10f keep full float32 accuracy
// (the phase discriminators are held to ~4e-7 rad against the reference).

#include <cuda_runtime.h>
#include <math.h>

#define MAX_K 5

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

// row indices (ops/track_chain.py F_* / I_* / O_*)
enum {
    F_REM_CODE = 0, F_DELTA, F_DOPPLER, F_REM_CARR, F_CARR_W, F_CARR_X,
    F_PREV_R, F_PREV_I, F_SABSI, F_SI2, F_SQ2, F_CN0, F_ACCH_R, F_ACCH_I,
    F_CARR_OFF, F_DLL_IN0 = 15, F_DLL_OUT0 = 18, F_ACC_R0 = 21
};
enum {
    I_ACTIVE = 0, I_START, I_CURLEN, I_PUSH, I_LOCKFAIL, I_EPOCHS, I_FLL_ON,
    I_MODE, I_EXTCNT, I_SEC_ON, I_SEC_IDX, I_LIMIT, N_IROWS
};
enum {
    O_DOPPLER = 0, O_DELTA, O_REM_CODE, O_REM_CARR, O_CN0, O_VALID,
    O_ACTIVE, N_OROWS
};

#define TWO_PI_F 6.283185307179586f
#define PI_F 3.141592653589793f
#define TINY_F 1.17549435e-38f

// numpy/JAX `mod`: result takes the sign of the divisor (exact fmod, then
// + m where the signs differ).  fmodf alone would keep the dividend's sign.
__device__ __forceinline__ float mod_floor(float x, float m) {
    float r = fmodf(x, m);
    if (r != 0.0f && ((r < 0.0f) != (m < 0.0f))) r += m;
    return r;
}

// numpy/JAX `sign`: sign(0) == 0 (copysignf would give +-1).
__device__ __forceinline__ float sign0(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

template <int K>
__global__ void __launch_bounds__(128)
track_chain_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                   const int* __restrict__ s_pred,
                   const float* __restrict__ step0_p,
                   const float* __restrict__ sec_rows,
                   const float* __restrict__ fst, const int* __restrict__ ist,
                   float* __restrict__ out_f, int* __restrict__ out_i,
                   float* __restrict__ out_corr, float* __restrict__ fst_out,
                   int* __restrict__ ist_out, const ChainParams p) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int C = p.C;
    if (c >= C) return;
    const int P = p.P;

    // ---- load state (rows of [ROWS, C]) ----
    float rem_code = fst[F_REM_CODE * C + c];
    float delta = fst[F_DELTA * C + c];
    float doppler = fst[F_DOPPLER * C + c];
    float rem_carr = fst[F_REM_CARR * C + c];
    float cw = fst[F_CARR_W * C + c];
    float cx = fst[F_CARR_X * C + c];
    float prev_r = fst[F_PREV_R * C + c];
    float prev_i = fst[F_PREV_I * C + c];
    float sabsi = fst[F_SABSI * C + c];
    float si2 = fst[F_SI2 * C + c];
    float sq2 = fst[F_SQ2 * C + c];
    float cn0_old = fst[F_CN0 * C + c];
    float acch_r = fst[F_ACCH_R * C + c];
    float acch_i = fst[F_ACCH_I * C + c];
    const float carr_off = fst[F_CARR_OFF * C + c];
    float din[3], dout[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        din[j] = fst[(F_DLL_IN0 + j) * C + c];
        dout[j] = fst[(F_DLL_OUT0 + j) * C + c];
    }
    float accr[K], acci[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        accr[k] = fst[(F_ACC_R0 + k) * C + c];
        acci[k] = fst[(F_ACC_R0 + K + k) * C + c];
    }
    int active_i = ist[I_ACTIVE * C + c];
    int start = ist[I_START * C + c];
    int cur_len = ist[I_CURLEN * C + c];
    int push = ist[I_PUSH * C + c];
    int lockfail = ist[I_LOCKFAIL * C + c];
    int epochs = ist[I_EPOCHS * C + c];
    int fllon_i = ist[I_FLL_ON * C + c];
    const int mode0 = ist[I_MODE * C + c];
    int extcnt = ist[I_EXTCNT * C + c];
    const int sec_on_i = ist[I_SEC_ON * C + c];
    int sec_idx = ist[I_SEC_IDX * C + c];
    const int limit = ist[I_LIMIT * C + c];
    const float step0 = step0_p[c];

    const bool narrow = mode0 >= 1;
    const float narrow_f = narrow ? 1.0f : 0.0f;
    const bool sec_on = sec_on_i > 0;
    // wide/narrow constant select, fixed per channel for the chunk
    float pll[8], bi[4], bo[3];
#pragma unroll
    for (int j = 0; j < 8; ++j) pll[j] = p.pll_base[j] + narrow_f * p.pll_slope[j];
#pragma unroll
    for (int j = 0; j < 4; ++j) bi[j] = p.bin_base[j] + narrow_f * p.bin_slope[j];
#pragma unroll
    for (int j = 0; j < 3; ++j) bo[j] = p.bout_base[j] + narrow_f * p.bout_slope[j];
    const float w0p = pll[0], w0p2 = pll[1], w0p3 = pll[2], w0f = pll[3];
    const float w0f2 = pll[4], a2 = pll[5], a3 = pll[6], b3 = pll[7];

    float dphi = 0.0f;
    const int LW = p.LW;

    for (int kk = 0; kk < p.E; ++kk) {
        const bool active = active_i > 0;
        const bool valid = active && (start < limit);
        const float validf = valid ? 1.0f : 0.0f;

        // ---- tap read at the TRUE code phase: linear interpolation
        //      weight max(0, 1-|pos-l|) is non-zero on floor(pos) and
        //      floor(pos)+1 only ----
        const float d_s = (float)(start - s_pred[kk * C + c]);
        const float rem_eff = (d_s + rem_code) * (1.0f + delta / p.chip_rate);
        const float* zr_k = zr + (size_t)kk * LW * C + c;
        const float* zi_k = zi + (size_t)kk * LW * C + c;
        float taps_r[K], taps_i[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float pos = (p.lag_margin + rem_eff) - p.shift_samp[k];
            const float fl = floorf(pos);
            const int l0 = (int)fl;
            float tr = 0.0f, ti = 0.0f;
            if (l0 >= 0 && l0 < LW) {
                const float w = 1.0f - (pos - fl);
                tr += zr_k[(size_t)l0 * C] * w;
                ti += zi_k[(size_t)l0 * C] * w;
            }
            if (l0 + 1 >= 0 && l0 + 1 < LW) {
                const float w = 1.0f - ((fl + 1.0f) - pos);
                tr += zr_k[(size_t)(l0 + 1) * C] * w;
                ti += zi_k[(size_t)(l0 + 1) * C] * w;
            }
            taps_r[k] = tr;
            taps_i[k] = ti;
        }

        // ---- rotate into the true-NCO frame ----
        const float step_true = TWO_PI_F * (doppler + carr_off) / p.fs;
        const float dphi_mid = dphi + (step_true - step0) * 0.5f * (float)cur_len;
        float rs, rc;
        sincosf(dphi_mid, &rs, &rc);
        float corr_r[K], corr_i[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            corr_r[k] = taps_r[k] * rc + taps_i[k] * rs;
            corr_i[k] = taps_i[k] * rc - taps_r[k] * rs;
        }

        // ---- loop closure ----
        const float t_epoch = (float)cur_len / p.fs;
        float sec_chip;
        if (p.sec_len > 1) {
            const int idx_c = min(sec_idx, p.sec_len - 1);
            sec_chip = sec_rows[idx_c * C + c];
        } else {
            sec_chip = sec_rows[c];
        }
        const float s = sec_on ? sec_chip : 1.0f;
        float cw_r[K], cw_i[K], acc_r[K], acc_i[K], disc_r[K], disc_i[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            cw_r[k] = corr_r[k] * s;
            cw_i[k] = corr_i[k] * s;
            acc_r[k] = accr[k] + cw_r[k];
            acc_i[k] = acci[k] + cw_i[k];
            disc_r[k] = narrow ? acc_r[k] : cw_r[k];
            disc_i[k] = narrow ? acc_i[k] : cw_i[k];
        }
        const float pw_r = cw_r[P], pw_i = cw_i[P];
        const int cnt = extcnt + 1;
        const bool boundary = narrow && (cnt >= p.ext_n);
        const bool upd = (!narrow) || boundary;
        const float dp_r = disc_r[P], dp_i = disc_i[P];
        const float t_int = narrow ? (float)cnt * p.code_period_s : t_epoch;

        // --- carrier discriminators (A.3) ---
        const float costas = (dp_r != 0.0f
            ? atan2f(dp_i * sign0(dp_r), fabsf(dp_r)) : 0.0f) / TWO_PI_F;
        float carr_err_cyc;
        if (p.sec_data || !sec_on) {
            carr_err_cyc = costas;
        } else {
            carr_err_cyc = atan2f(dp_i, dp_r) / TWO_PI_F;
        }
        const float dot = prev_r * pw_r + prev_i * pw_i;
        const float cross = prev_r * pw_i - pw_r * prev_i;
        const float freq_err_hz = atan2f(cross, dot) / t_epoch / TWO_PI_F;
        const float p2_r = acc_r[P] - acch_r;
        const float p2_i = acc_i[P] - acch_i;
        const float dot_h = acch_r * p2_r + acch_i * p2_i;
        const float cross_h = acch_r * p2_i - p2_r * acch_i;
        const float h_mag = acch_r * acch_r + acch_i * acch_i;
        const float freq_err_ext = (h_mag > 0.0f && boundary)
            ? atan2f(cross_h, dot_h) / p.t_half / TWO_PI_F : 0.0f;

        const bool fll_on = fllon_i > 0;
        const float pll_in = carr_err_cyc;
        float fll_in = (fll_on && !narrow && push > 0) ? freq_err_hz : 0.0f;
        if (narrow && fll_on) fll_in = freq_err_ext;

        // --- FLL-assisted PLL cascade (A.5) ---
        float w_new, x_new, doppler_new;
        if (p.order == 3) {
            w_new = cw + t_int * (w0p3 * pll_in + w0f2 * fll_in);
            x_new = cx + t_int * (0.5f * w_new + a2 * w0f * fll_in
                                  + a3 * w0p2 * pll_in);
            doppler_new = 0.5f * x_new + b3 * w0p * pll_in;
        } else {
            w_new = cw + t_int * (w0p2 * pll_in + w0f * fll_in);
            doppler_new = 0.5f * (w_new + cw) + a2 * w0p * pll_in;
            x_new = cx;
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
        const float code_err_filt = bo[0] * dout[0] + bo[1] * dout[1]
            + bo[2] * dout[2] + bi[0] * code_err + bi[1] * din[0]
            + bi[2] * din[1] + bi[3] * din[2];

        const bool app = valid && upd;
        const float appf = app ? 1.0f : 0.0f;
        float cw_m = app ? w_new : cw;
        float cx_m = app ? x_new : cx;
        float din_m[3], dout_m[3];
        din_m[0] = app ? code_err : din[0];
        din_m[1] = app ? din[0] : din[1];
        din_m[2] = app ? din[1] : din[2];
        dout_m[0] = app ? code_err_filt : dout[0];
        dout_m[1] = app ? dout[0] : dout[1];
        dout_m[2] = app ? dout[1] : dout[2];
        const float doppler_m = app ? doppler_new : doppler;
        const float delta_m = app ? (p.cr_over_fc * doppler_new - code_err_filt)
                                  : delta;

        // --- NCO stepping / next length (A.6 split precision) ---
        const float ncf = p.chip_rate + delta_m;
        const float d_t = (-p.t0_int_f) * delta_m / ncf - p.t0_frac * delta_m / ncf;
        const float frac = (p.t0_frac + d_t) + rem_code;
        const float frac_floor = floorf(frac);
        const int next_len = p.t0_int + (int)frac_floor;
        const float rem_code_new = frac - frac_floor;
        const float carr_step_new = TWO_PI_F * (doppler_m + carr_off) / p.fs;
        const float rem_carr_new =
            mod_floor(rem_carr + carr_step_new * (float)next_len, TWO_PI_F);

        // --- CN0 / lock supervision on window accumulators (A.7) ---
        float s_absi = sabsi + appf * fabsf(dp_r);
        float s_i2 = si2 + appf * dp_r * dp_r;
        float s_q2 = sq2 + appf * dp_i * dp_i;
        const int push_count = push + (app ? 1 : 0);
        const bool window_done = app && (push_count % p.cn0_samples == 0);
        const float t_cn0 = narrow ? p.t_ext : t_epoch;
        const float m = p.cn0_samples_f;
        const float am = s_absi / m;
        const float psig = am * am;
        const float ptot = (s_i2 + s_q2) / m;
        const float noise = fmaxf(ptot - psig, TINY_F);
        const float cn0 = 10.0f * log10f(fmaxf(psig / noise, 1e-10f))
                          - 10.0f * log10f(t_cn0);
        const float carrier_lock = (s_i2 - s_q2) / fmaxf(s_i2 + s_q2, TINY_F);
        const float cn0_last = window_done ? cn0 : cn0_old;
        const bool hist_full = push_count >= p.cn0_samples;
        if (window_done) { s_absi = 0.0f; s_i2 = 0.0f; s_q2 = 0.0f; }
        const bool check_now = window_done && !fll_on;
        const bool fail = check_now && ((cn0 < p.cn0_min_dbhz)
                                        || (carrier_lock < p.carrier_lock_th));
        const bool ok = check_now && !fail;
        const int lock_fail = fail ? lockfail + 1
                                   : (ok ? max(lockfail - 1, 0) : lockfail);
        const bool still_active = active && (lock_fail <= p.max_lock_fail);

        const int epochs_in_track = epochs + 1;
        const bool fll_still_on = fll_on && (narrow
            ? (push_count < p.fll_narrow_windows)
            : (epochs_in_track < p.fll_epochs));
        const bool turnoff = narrow && fll_on && !fll_still_on;
        if (turnoff && valid) {
            if (p.order == 3) { cw_m = 0.0f; cx_m = 2.0f * doppler_m; }
            else { cw_m = doppler_m; cx_m = 0.0f; }
        }

        const bool reset_acc = boundary || !narrow;
        const float racf = reset_acc ? 0.0f : 1.0f;
        const bool at_half = narrow && (cnt == p.half_n);
        const float acch_r_new = racf * (at_half ? acc_r[P] : acch_r);
        const float acch_i_new = racf * (at_half ? acc_i[P] : acch_i);

        // --- merge by valid: a dead channel never takes new state ---
        const float merged_dopp = valid ? doppler_m : doppler;
        const int merged_active = valid ? (still_active ? 1 : 0) : active_i;
        const float merged_cn0 = valid ? cn0_last : cn0_old;
        const float merged_delta = valid ? delta_m : delta;
        const float merged_rem_code = valid ? rem_code_new : rem_code;
        const float merged_rem_carr = valid ? rem_carr_new : rem_carr;
        const int new_cur = valid ? next_len : cur_len;

        // --- per-epoch outputs ---
        float* of = out_f + (size_t)kk * N_OROWS * C + c;
        of[O_DOPPLER * C] = merged_dopp;
        of[O_DELTA * C] = merged_delta;
        of[O_REM_CODE * C] = merged_rem_code;
        of[O_REM_CARR * C] = merged_rem_carr;
        of[O_CN0 * C] = (valid && hist_full) ? merged_cn0 : 0.0f;
        of[O_VALID * C] = validf;
        of[O_ACTIVE * C] = (float)merged_active;
        int* oi = out_i + (size_t)kk * 2 * C + c;
        oi[0] = start;
        oi[C] = cur_len;
        float* oc = out_corr + (size_t)kk * 2 * K * C + c;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            oc[k * C] = validf * corr_r[k];
            oc[(K + k) * C] = validf * corr_i[k];
        }

        // --- frozen-vs-true phase ledger ---
        const float step_new = TWO_PI_F * (merged_dopp + carr_off) / p.fs;
        const float dphi_next = (dphi + step_new * (float)new_cur)
                                - step0 * (float)cur_len;
        if (valid) dphi = mod_floor(dphi_next + PI_F, TWO_PI_F) - PI_F;

        // --- carry ---
        if (valid) {
            rem_code = merged_rem_code;
            delta = merged_delta;
            doppler = merged_dopp;
            rem_carr = merged_rem_carr;
            cw = cw_m;
            cx = cx_m;
            prev_r = pw_r;
            prev_i = pw_i;
            sabsi = s_absi;
            si2 = s_i2;
            sq2 = s_q2;
            cn0_old = merged_cn0;
            acch_r = acch_r_new;
            acch_i = acch_i_new;
#pragma unroll
            for (int j = 0; j < 3; ++j) { din[j] = din_m[j]; dout[j] = dout_m[j]; }
#pragma unroll
            for (int k = 0; k < K; ++k) {
                accr[k] = acc_r[k] * racf;
                acci[k] = acc_i[k] * racf;
            }
            active_i = merged_active;
            start = start + cur_len;
            cur_len = new_cur;
            push = push_count;
            lockfail = lock_fail;
            epochs = epochs_in_track;
            fllon_i = fll_still_on ? 1 : 0;
            extcnt = reset_acc ? 0 : cnt;
            sec_idx = (sec_idx + 1) % p.sec_len;
        }
    }

    // ---- store state ----
    fst_out[F_REM_CODE * C + c] = rem_code;
    fst_out[F_DELTA * C + c] = delta;
    fst_out[F_DOPPLER * C + c] = doppler;
    fst_out[F_REM_CARR * C + c] = rem_carr;
    fst_out[F_CARR_W * C + c] = cw;
    fst_out[F_CARR_X * C + c] = cx;
    fst_out[F_PREV_R * C + c] = prev_r;
    fst_out[F_PREV_I * C + c] = prev_i;
    fst_out[F_SABSI * C + c] = sabsi;
    fst_out[F_SI2 * C + c] = si2;
    fst_out[F_SQ2 * C + c] = sq2;
    fst_out[F_CN0 * C + c] = cn0_old;
    fst_out[F_ACCH_R * C + c] = acch_r;
    fst_out[F_ACCH_I * C + c] = acch_i;
    fst_out[F_CARR_OFF * C + c] = carr_off;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        fst_out[(F_DLL_IN0 + j) * C + c] = din[j];
        fst_out[(F_DLL_OUT0 + j) * C + c] = dout[j];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        fst_out[(F_ACC_R0 + k) * C + c] = accr[k];
        fst_out[(F_ACC_R0 + K + k) * C + c] = acci[k];
    }
    ist_out[I_ACTIVE * C + c] = active_i;
    ist_out[I_START * C + c] = start;
    ist_out[I_CURLEN * C + c] = cur_len;
    ist_out[I_PUSH * C + c] = push;
    ist_out[I_LOCKFAIL * C + c] = lockfail;
    ist_out[I_EPOCHS * C + c] = epochs;
    ist_out[I_FLL_ON * C + c] = fllon_i;
    ist_out[I_MODE * C + c] = mode0;
    ist_out[I_EXTCNT * C + c] = extcnt;
    ist_out[I_SEC_ON * C + c] = sec_on_i;
    ist_out[I_SEC_IDX * C + c] = sec_idx;
    ist_out[I_LIMIT * C + c] = limit;
}

extern "C" int track_chain_launch(
    const void* zr, const void* zi, const void* s_pred, const void* step0,
    const void* sec_rows, const void* fst, const void* ist, void* out_f,
    void* out_i, void* out_corr, void* fst_out, void* ist_out,
    const ChainParams* params, void* stream) {
    const ChainParams p = *params;
    const int threads = p.C <= 32 ? 32 : (p.C <= 64 ? 64 : 128);
    const int blocks = (p.C + threads - 1) / threads;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define LAUNCH(KV)                                                          \
    track_chain_kernel<KV><<<blocks, threads, 0, s>>>(                      \
        (const float*)zr, (const float*)zi, (const int*)s_pred,             \
        (const float*)step0, (const float*)sec_rows, (const float*)fst,     \
        (const int*)ist, (float*)out_f, (int*)out_i, (float*)out_corr,      \
        (float*)fst_out, (int*)ist_out, p)
    if (p.K == 3) {
        LAUNCH(3);
    } else if (p.K == 5) {
        LAUNCH(5);
    } else {
        return (int)cudaErrorInvalidValue;
    }
#undef LAUNCH
    return (int)cudaGetLastError();
}
