// Fused per-epoch tracking chain for NVIDIA Hopper (sm_90a), and the
// capture-level entry that enqueues the chunk correlator (chunk_corr.cuh)
// and the chain for every chunk of a capture segment.
//
// Replaces the Pallas TPU kernel gnss_sdr_1_tpu/ops/pallas_chain.py
// (`_make_kernel`, built by `make_chain_call`).  Computes exactly what the
// plain torch version gnss_sdr_1_tpu_torch/ops/track_chain.py:chain_plain
// computes: for E epochs x C channels, the sequential per-epoch loop closure
// of the chunked DLL/PLL tracking engine, with the loop state carried from
// epoch to epoch.
//
// What bounds it: per 16-epoch chunk and channel a few hundred float32
// operations per epoch and ~9 KB of lag windows, so neither bytes nor
// operations: the time is one dependent chain of E epochs (three atan2f,
// two log10f, a sincos and several divisions per epoch on the critical
// path).  Nothing inside a channel's chain can run in parallel.
//
// Design, against that chain:
// - one warp per channel (one block of 32 threads): the lanes stage the
//   channel's whole chunk window (zr, zi as [C, E, LW], one contiguous block
//   per plane), its slice origins and its secondary-code column in shared
//   memory with asynchronous copies that overlap the state loads, then
//   lane 0 walks the E epochs with the state in registers.
//   Each epoch's tap read, whose address depends on the previous epoch's
//   code phase, costs a shared-memory access instead of an L2/HBM round
//   trip;
// - templates on K (3 or 5 taps, prompt at K / 2), the PLL order and the
//   secondary-code flags, so every tap array is indexed by constants and
//   stays in registers (no stack frame);
// - the rotation's sine and cosine come from a reduction by pi/2 in double
//   precision and float polynomials (sincos_reduced), which has no
//   local-memory slow path;
// - the capture entry writes the per-epoch rows straight into the
//   capture-wide outputs and ping-pongs the state between two buffers, so
//   a segment costs two launches per chunk and nothing else.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false,
// WITHOUT --use_fast_math, so atan2f / log10f keep full float32 accuracy
// and products round op by op like the plain version.

#include "chunk_corr.cuh"
#include "rows.cuh"

#define MAX_K 5
#define TINY_F 1.17549435e-38f

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

// sin and cos of x: n = rint(x * 2/pi), r = x - n pi/2 in double
// (fdlibm's 33-bit pi/2 head, exact products for |x| < 2^20 pi/2), then the
// Cephes float polynomials on [-pi/4, pi/4]; <= 1.5 ulp from the true
// values.  Beyond ~1.6e6 rad the reduction loses accuracy; the chain's
// phase differences stay within a few radians.
__device__ __forceinline__ void sincos_reduced(float x, float* s, float* c) {
    const double xd = (double)x;
    const double n = rint(xd * 0.63661977236758134308);
    double r = fma(-n, 1.57079632673412561417e+00, xd);
    r = fma(-n, 6.07710050650619224932e-11, r);
    const float rf = (float)r;
    const float z = rf * rf;
    const float ps = fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z,
                          -1.6666654611e-1f);
    const float sr = fmaf(rf * z, ps, rf);
    const float pc = fmaf(fmaf(2.443315711809948e-5f, z,
                               -1.388731625493765e-3f), z,
                          4.166664568298827e-2f);
    const float cr = fmaf(z * z, pc, fmaf(-0.5f, z, 1.0f));
    const int quad = (int)((long long)n & 3);
    *s = quad == 0 ? sr : (quad == 1 ? cr : (quad == 2 ? -sr : -cr));
    *c = quad == 0 ? cr : (quad == 1 ? -sr : (quad == 2 ? -cr : sr));
}

template <int K, int ORDER, bool SEC_DATA, bool HAS_SEC>
__global__ void __launch_bounds__(32)
track_chain_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                   const int* __restrict__ s_reg,
                   const float* __restrict__ step0_p,
                   const float* __restrict__ sec_rows,
                   const float* __restrict__ fst, const int* __restrict__ ist,
                   float* __restrict__ out_f, int* __restrict__ out_i,
                   float* __restrict__ out_corr, float* __restrict__ fst_out,
                   int* __restrict__ ist_out, const ChainParams p) {
    constexpr int P = K / 2;
    extern __shared__ __align__(16) float ch_smem[];
    const int c = blockIdx.x;
    const int C = p.C;
    const int LW = p.LW;
    const int ELW = p.E * LW;
    float* zr_s = ch_smem;                             // [E, LW]
    float* zi_s = ch_smem + ELW;                       // [E, LW]
    int* sreg_s = reinterpret_cast<int*>(ch_smem + 2 * ELW);   // [E]
    float* sec_s = ch_smem + 2 * ELW + p.E;            // [sec_len]

    // ---- stage the channel's chunk in shared memory: every lane starts
    //      its asynchronous copies, then the state loads below overlap
    //      them ----
    {
        const float* zr_c = zr + (size_t)c * ELW;
        const float* zi_c = zi + (size_t)c * ELW;
        for (int i = threadIdx.x; i < ELW; i += 32) {
            cp_async4(zr_s + i, zr_c + i);
            cp_async4(zi_s + i, zi_c + i);
        }
        for (int i = threadIdx.x; i < p.E; i += 32)
            cp_async4(sreg_s + i, s_reg + c * p.E + i);
        asm volatile("cp.async.commit_group;\n" ::);
        if (HAS_SEC)
            for (int i = threadIdx.x; i < p.sec_len; i += 32)
                sec_s[i] = sec_rows[i * C + c];
    }

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
    asm volatile("cp.async.wait_all;\n" ::);
    __syncwarp();
    if (threadIdx.x != 0) return;

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

    for (int kk = 0; kk < p.E; ++kk) {
        const bool active = active_i > 0;
        const bool valid = active && (start < limit);
        const float validf = valid ? 1.0f : 0.0f;

        // ---- tap read at the TRUE code phase: linear interpolation
        //      weight max(0, 1-|pos-l|) is non-zero on floor(pos) and
        //      floor(pos)+1 only ----
        const float d_s = (float)(start - sreg_s[kk]);
        const float rem_eff = (d_s + rem_code) * (1.0f + delta / p.chip_rate);
        const float* zr_k = zr_s + kk * LW;
        const float* zi_k = zi_s + kk * LW;
        float taps_r[K], taps_i[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float pos = (p.lag_margin + rem_eff) - p.shift_samp[k];
            const float fl = floorf(pos);
            const int l0 = (int)fl;
            float tr = 0.0f, ti = 0.0f;
            if (l0 >= 0 && l0 < LW) {
                const float w = 1.0f - (pos - fl);
                tr += zr_k[l0] * w;
                ti += zi_k[l0] * w;
            }
            if (l0 + 1 >= 0 && l0 + 1 < LW) {
                const float w = 1.0f - ((fl + 1.0f) - pos);
                tr += zr_k[l0 + 1] * w;
                ti += zi_k[l0 + 1] * w;
            }
            taps_r[k] = tr;
            taps_i[k] = ti;
        }

        // ---- rotate into the true-NCO frame ----
        const float step_true = TWO_PI_F * (doppler + carr_off) / p.fs;
        const float dphi_mid = dphi + (step_true - step0) * 0.5f * (float)cur_len;
        float rs, rc;
        sincos_reduced(dphi_mid, &rs, &rc);
        float corr_r[K], corr_i[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            corr_r[k] = taps_r[k] * rc + taps_i[k] * rs;
            corr_i[k] = taps_i[k] * rc - taps_r[k] * rs;
        }

        // ---- loop closure ----
        const float t_epoch = (float)cur_len / p.fs;
        float s = 1.0f;
        if (HAS_SEC) {
            if (sec_on) s = sec_s[min(sec_idx, p.sec_len - 1)];
        } else {
            if (sec_on) s = sec_rows[c];
        }
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
        if (SEC_DATA || !sec_on) {
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
        if (ORDER == 3) {
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
            if (ORDER == 3) { cw_m = 0.0f; cx_m = 2.0f * doppler_m; }
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

typedef void (*ChainKernel)(const float*, const float*, const int*,
                            const float*, const float*, const float*,
                            const int*, float*, int*, float*, float*, int*,
                            const ChainParams);

// The template instance for a spec (K, order, sec_data, sec_len > 1), or
// null when the kernel does not take the spec.
static ChainKernel chain_kernel_for(const ChainParams& p) {
#define CH_PICK(KV, OV)                                                     \
    if (p.sec_data) return p.sec_len > 1                                    \
        ? track_chain_kernel<KV, OV, true, true>                            \
        : track_chain_kernel<KV, OV, true, false>;                          \
    return p.sec_len > 1 ? track_chain_kernel<KV, OV, false, true>          \
                         : track_chain_kernel<KV, OV, false, false>;
    if (p.P != p.K / 2) return nullptr;
    if (p.K == 3 && p.order == 3) { CH_PICK(3, 3) }
    if (p.K == 3 && p.order == 2) { CH_PICK(3, 2) }
    if (p.K == 5 && p.order == 3) { CH_PICK(5, 3) }
    if (p.K == 5 && p.order == 2) { CH_PICK(5, 2) }
#undef CH_PICK
    return nullptr;
}

static inline size_t chain_smem_bytes(const ChainParams& p) {
    return sizeof(float) * (2 * (size_t)p.E * p.LW + p.E + p.sec_len);
}

// The chain kernel, checked, and the launch attribute for its dynamic
// shared memory (needed above 48 KB).
static cudaError_t chain_prepare(const ChainParams& p, ChainKernel* kernel) {
    *kernel = chain_kernel_for(p);
    if (*kernel == nullptr) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(*kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)chain_smem_bytes(p));
}

static inline cudaError_t chain_enqueue(
    ChainKernel kernel, const ChainParams& p, const void* zr, const void* zi,
    const void* s_reg, const void* step0, const void* sec_rows,
    const void* fst, const void* ist, void* out_f, void* out_i,
    void* out_corr, void* fst_out, void* ist_out, cudaStream_t s) {
    kernel<<<p.C, 32, chain_smem_bytes(p), s>>>(
        (const float*)zr, (const float*)zi, (const int*)s_reg,
        (const float*)step0, (const float*)sec_rows, (const float*)fst,
        (const int*)ist, (float*)out_f, (int*)out_i, (float*)out_corr,
        (float*)fst_out, (int*)ist_out, p);
    return cudaGetLastError();
}

extern "C" int chunk_corr_launch(
    const void* x, int n_samp, const void* rows, const void* slot,
    const void* fst, const void* ist, void* zr, void* zi, void* s_reg,
    void* step0, const CorrParams* params, void* stream) {
    const CorrParams p = *params;
    cudaError_t err = chunk_corr_prepare(p);
    if (err != cudaSuccess) return (int)err;
    return (int)chunk_corr_enqueue(p, x, n_samp, rows, slot, fst, ist, zr,
                                   zi, s_reg, step0,
                                   reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int track_chain_launch(
    const void* zr, const void* zi, const void* s_reg, const void* step0,
    const void* sec_rows, const void* fst, const void* ist, void* out_f,
    void* out_i, void* out_corr, void* fst_out, void* ist_out,
    const ChainParams* params, void* stream) {
    const ChainParams p = *params;
    ChainKernel kernel;
    cudaError_t err = chain_prepare(p, &kernel);
    if (err != cudaSuccess) return (int)err;
    return (int)chain_enqueue(kernel, p, zr, zi, s_reg, step0, sec_rows, fst,
                              ist, out_f, out_i, out_corr, fst_out, ist_out,
                              reinterpret_cast<cudaStream_t>(stream));
}

// Every chunk of a capture segment: chunk i's correlator and chain read the
// state of chunk i - 1 (the input state for i = 0) and the chain writes
// chunk i's state into ping-pong buffer i % 2 and its per-epoch rows at
// epoch offset i * E of the capture-wide outputs.  Enqueues 2 * n_chunks
// launches on `stream`, checks each, never synchronises and allocates
// nothing; returns the first error.
extern "C" int track_capture_launch(
    int n_chunks, const void* x, int n_samp, const void* rows,
    const void* slot, const void* sec_rows, const void* fst_in,
    const void* ist_in, void* fst_a, void* ist_a, void* fst_b, void* ist_b,
    void* zr, void* zi, void* s_reg, void* step0, void* out_f, void* out_i,
    void* out_corr, const CorrParams* corr_params,
    const ChainParams* chain_params, void* stream) {
    const CorrParams cp = *corr_params;
    const ChainParams p = *chain_params;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    ChainKernel kernel;
    cudaError_t err = chunk_corr_prepare(cp);
    if (err == cudaSuccess) err = chain_prepare(p, &kernel);
    if (err != cudaSuccess) return (int)err;
    void* fst_buf[2] = {fst_a, fst_b};
    void* ist_buf[2] = {ist_a, ist_b};
    const size_t f_stride = (size_t)p.E * N_OROWS * p.C;
    const size_t i_stride = (size_t)p.E * 2 * p.C;
    const size_t c_stride = (size_t)p.E * 2 * p.K * p.C;
    for (int i = 0; i < n_chunks; ++i) {
        const void* f_cur = i == 0 ? fst_in : fst_buf[(i - 1) % 2];
        const void* i_cur = i == 0 ? ist_in : ist_buf[(i - 1) % 2];
        err = chunk_corr_enqueue(cp, x, n_samp, rows, slot, f_cur, i_cur, zr,
                                 zi, s_reg, step0, s);
        if (err != cudaSuccess) return (int)err;
        err = chain_enqueue(kernel, p, zr, zi, s_reg, step0, sec_rows, f_cur,
                            i_cur, (float*)out_f + i * f_stride,
                            (int*)out_i + i * i_stride,
                            (float*)out_corr + i * c_stride, fst_buf[i % 2],
                            ist_buf[i % 2], s);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
