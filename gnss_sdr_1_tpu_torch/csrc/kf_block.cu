// Kalman-filter tracking of whole blocks for NVIDIA Hopper (sm_90a): every
// epoch of every channel of one or more consecutive blocks in one launch.
//
// Computes exactly what the plain torch version
// gnss_sdr_1_tpu_torch/ops/kf_block.py:kf_block_plain computes (the row
// layouts are that module's R_* / I_* / O_* / OI_*): per epoch the window
// origin m over the active channels, the gather multicorrelator
// (gather_corr.cuh), the KF predict / Costas measurement / NIW / scalar
// update, the carrier-aided IIR DLL, the split-precision epoch length and
// the CN0 and carrier-lock supervision.  It takes the place of the JAX
// package's block program, gnss_sdr_1_tpu/track/kf.py `_track_block_impl`
// (a `lax.scan` over `_epoch_step`, :266 and :425), which is not a Pallas
// kernel.
//
// What bounds it: per epoch and channel the correlation touches each of
// its ~spc samples once (8 bytes, a sine and cosine, three table reads),
// which the card could do for a whole 40 ms GPS block of 12 channels in
// microseconds; but the epochs are serial (each epoch's code and carrier
// phase come from the previous epoch's update) and the channels are
// coupled through m, so the time is E dependent epochs of one correlation
// pass plus one scalar update each.
//
// Design, against that chain (a simple kernel first):
// - one block of threads on one SM; a group of warps per channel (rounds
//   of groups when there are more channels than groups), a __syncthreads()
//   per epoch for m, so m is the plain version's m exactly;
// - the state lives in shared memory as the plain version's rows, the
//   channel's lane 0 runs its scalar update, the code tables of the
//   channels' slots sit in shared memory as bits;
// - the walk rebases the epoch starts by `base` between blocks, so one
//   launch covers a capture segment.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false,
// WITHOUT --use_fast_math, so atan2f / log10f / powf keep full float32
// accuracy and products round op by op like the plain version.  Both
// divide by a constant (fs, fs^2, 10, N) as a multiply by its float32
// reciprocal, as the JAX package's compiled step does.

#include <cstdint>

#include "gather_corr.cuh"

#define TINY_F 1.17549435e-38f

// float32 state rows (ops/kf_block.py R_*)
#define R_REM_CODE 0
#define R_DELTA 1
#define R_X 2
#define R_P 5
#define R_DLL_IN 14
#define R_DLL_OUT 17
#define R_CN0 20
#define R_NIW 21
#define R_HIST 26
// int32 state rows (I_*)
#define I_ACTIVE 0
#define I_SLOT 1
#define I_START 2
#define I_CURLEN 3
#define I_HIST_COUNT 4
#define I_LOCK_FAIL 5
#define I_EPOCHS 6
#define N_IROWS 7
// per-epoch output rows (O_*, OI_*)
#define O_DOPPLER 0
#define O_DOPPLER_RATE 1
#define O_SIGMA2 2
#define O_DELTA 3
#define O_REM_CODE 4
#define O_REM_CARR 5
#define O_CN0 6
#define O_CORR 7
#define N_OROWS 13
#define OI_VALID 0
#define OI_START 1
#define OI_CURLEN 2
#define OI_ACTIVE 3
#define N_OIROWS 4

#define MAX_THREADS 1024

struct KfParams {
    int C, n_hist, code_len, n_max, win, base, n_epochs, n_blocks, n_samp;
    int order, bayes_run, bayes_ptrans, bayes_strans, max_lock_fail, t0_int;
    float chip_rate, fs, two_pi, fs2, t, aid, t0_int_f, t0_frac;
    float cn0_min_dbhz, carrier_lock_th, cn0_log_t;
    float inv_fs, inv_fs2, inv_n_hist, tenth;   // float32 reciprocals
    float shifts[3], F[9], Q[9], dll_b_in[4], dll_b_out[3];
};

// numpy/JAX `mod` (the divisor's sign)
__device__ __forceinline__ float mod_floor(float x, float m) {
    float r = fmodf(x, m);
    if (r != 0.0f && ((r < 0.0f) != (m < 0.0f))) r = __fadd_rn(r, m);
    return r;
}

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return v < lo ? lo : v;
}

// the correlation parameters of one channel's epoch, set by its lane 0
struct CorrArgs {
    float step, rem, cp, cs, hr;
    int off, n_valid, valid;
};

// One channel's scalar epoch update (lane 0 of its group): reads and
// writes the channel's column of the shared state rows, writes its output
// rows.  cr / ci: the three taps.
template <bool BAYES>
__device__ __forceinline__ void kf_update(const KfParams& p, float* sf,
                                          int* si, int c, bool valid,
                                          const float cr[3],
                                          const float ci[3], float* of,
                                          int* oi) {
    const int C = p.C;
    const int N = p.n_hist;
#define S(row) sf[(row) * C + c]
#define SI(row) si[(row) * C + c]
    const int active = SI(I_ACTIVE);
    const int start = SI(I_START);
    const int cur_len = SI(I_CURLEN);
    const float rem = S(R_REM_CODE);
    const float delta = S(R_DELTA);
    float X[3], P[9];
#pragma unroll
    for (int j = 0; j < 3; ++j) X[j] = S(R_X + j);
#pragma unroll
    for (int j = 0; j < 9; ++j) P[j] = S(R_P + j);
    const float* F = p.F;
    const float pr = cr[1], pq = ci[1];

    // --- KF predict: x_pre = F x, P_pre = F P F' + Q (sums left to right)
    float xp[3], A[9], Pp[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
        xp[i] = (F[i * 3] * X[0] + F[i * 3 + 1] * X[1]) + F[i * 3 + 2] * X[2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            A[i * 3 + k] = (F[i * 3] * P[k] + F[i * 3 + 1] * P[3 + k])
                           + F[i * 3 + 2] * P[6 + k];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int l = 0; l < 3; ++l)
            Pp[i * 3 + l] = ((A[i * 3] * F[l * 3] + A[i * 3 + 1] * F[l * 3 + 1])
                             + A[i * 3 + 2] * F[l * 3 + 2]) + p.Q[i * 3 + l];

    // --- measurement: two-quadrant Costas atan; R from the running CN0
    const float sgn = pr > 0.0f ? 1.0f : (pr < 0.0f ? -1.0f : 0.0f);
    const float y = pr != 0.0f ? atan2f(pq * sgn, fabsf(pr)) : 0.0f;
    const float cn0_old = S(R_CN0);
    const float cn_lin = powf(10.0f, cn0_old * p.tenth);
    const float a = 1.0f / (2.0f * cn_lin * p.t);
    const float r = a * (1.0f + a);

    // --- NIW innovation covariance (sequential K=1 update)
    const int epochs0 = SI(I_EPOCHS);
    float niw[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) niw[j] = S(R_NIW + j);
    float p_y, r_est;
    if (BAYES) {
        const bool upd = valid && epochs0 >= p.bayes_ptrans;
        const float mu = niw[0], kap = niw[1], nu = niw[2], psi = niw[3];
        const float mu_post = (kap * mu + y) / (kap + 1.0f);
        const float kap_post = kap + 1.0f;
        const float nu_post = nu + 1.0f;
        const float dy = y - mu;
        const float psi_post = psi + kap / (kap + 1.0f) * (dy * dy);
        const float psi_est = nu_post - 2.0f > 0.0f
                                  ? psi_post / (nu_post - 2.0f)
                                  : psi_post / (nu_post + 2.0f);
        if (upd) {
            niw[0] = mu_post;
            niw[1] = kap_post;
            niw[2] = nu_post;
            niw[3] = psi_post;
            niw[4] = psi_est;
        }
        const bool use_bayes = epochs0 >= p.bayes_ptrans + p.bayes_strans;
        p_y = use_bayes ? niw[4] : Pp[0] + r;
        r_est = use_bayes ? niw[4] - Pp[0] : r;
    } else {
        p_y = Pp[0] + r;
        r_est = r;
    }

    // --- scalar update, H = [1, 0, 0]
    float K[3], xn[3], Pn[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) K[i] = Pp[i * 3] / p_y;
#pragma unroll
    for (int i = 0; i < 3; ++i) xn[i] = xp[i] + K[i] * y;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            Pn[i * 3 + j] = Pp[i * 3 + j] - K[i] * Pp[j];

    // --- DLL with carrier aiding
    const float e = hypotf(cr[0], ci[0]);
    const float l = hypotf(cr[2], ci[2]);
    const float s = e + l;
    const float code_err = s > 0.0f ? 0.5f * (e - l) / s : 0.0f;
    const float* bi = p.dll_b_in;
    const float* bo = p.dll_b_out;
    const float d0 = S(R_DLL_IN), d1 = S(R_DLL_IN + 1), d2 = S(R_DLL_IN + 2);
    const float o0 = S(R_DLL_OUT), o1 = S(R_DLL_OUT + 1),
                o2 = S(R_DLL_OUT + 2);
    const float filt = (((bo[0] * o0 + bo[1] * o1) + bo[2] * o2)
                        + bi[0] * code_err)
                       + ((bi[1] * d0 + bi[2] * d1) + bi[3] * d2);
    const float new_delta = p.aid * xn[1] - filt;

    // --- next epoch length (split precision)
    const float ncf = p.chip_rate + new_delta;
    const float d_t = -(p.t0_int_f * new_delta / ncf
                        + p.t0_frac * new_delta / ncf);
    const float frac = (p.t0_frac + d_t) + rem;
    const float ff = floorf(frac);
    const int next_len = p.t0_int + (int)ff;
    const float new_rem = frac - ff;

    // --- CN0 / lock supervision over the prompt history
    float* hr = sf + R_HIST * C + c;          // row n at hr[n * C]
    float* hq = sf + (R_HIST + N) * C + c;
    if (valid) {
        for (int n = 0; n + 1 < N; ++n) {
            hr[n * C] = hr[(n + 1) * C];
            hq[n * C] = hq[(n + 1) * C];
        }
        hr[(N - 1) * C] = pr;
        hq[(N - 1) * C] = pq;
    }
    const int hist_count = min(SI(I_HIST_COUNT) + (valid ? 1 : 0), N);
    const bool hist_full = hist_count >= N;
    float sabs = 0.0f, stot = 0.0f, i2 = 0.0f, q2 = 0.0f;
    for (int n = 0; n < N; ++n) {
        const float vi = hr[n * C], vq = hq[n * C];
        sabs = sabs + fabsf(vi);
        stot = stot + (vi * vi + vq * vq);
        i2 = i2 + vi * vi;
        q2 = q2 + vq * vq;
    }
    const float mabs = sabs * p.inv_n_hist;
    const float psig = mabs * mabs;
    const float ptot = stot * p.inv_n_hist;
    const float noise = clamp_min(ptot - psig, TINY_F);
    const float cn0 = 10.0f * log10f(clamp_min(psig / noise, 1e-10f))
                      - p.cn0_log_t;
    const float lock = (i2 - q2) / clamp_min(i2 + q2, TINY_F);
    const float cn0_run = (valid && hist_full) ? cn0 : cn0_old;
    const int epochs = epochs0 + (valid ? 1 : 0);
    const bool check_now = valid && hist_full && (epochs % N == 0);
    const bool fail = check_now && (cn0 < p.cn0_min_dbhz
                                    || lock < p.carrier_lock_th);
    const int lf0 = SI(I_LOCK_FAIL);
    const int lock_fail = fail ? lf0 + 1
                               : (check_now ? max(lf0 - 1, 0) : lf0);
    const bool still_active = active && lock_fail <= p.max_lock_fail;

    // --- merge by valid, outputs
    const int active_m = valid ? (int)still_active : active;
    const float x0m = valid ? xn[0] : X[0];
    const float x1m = valid ? xn[1] : X[1];
    const float x2m = valid ? xn[2] : X[2];
    const float delta_m = valid ? new_delta : delta;
    const float rem_m = valid ? new_rem : rem;
    of[O_DOPPLER * C + c] = x1m;
    of[O_DOPPLER_RATE * C + c] = x2m;
    of[O_SIGMA2 * C + c] = valid ? r_est : 0.0f;
    of[O_DELTA * C + c] = delta_m;
    of[O_REM_CODE * C + c] = rem_m;
    of[O_REM_CARR * C + c] = mod_floor(x0m, p.two_pi);
    of[O_CN0 * C + c] = (valid && hist_full) ? cn0 : 0.0f;
    for (int k = 0; k < 3; ++k) {
        of[(O_CORR + k) * C + c] = valid ? cr[k] : 0.0f;
        of[(O_CORR + 3 + k) * C + c] = valid ? ci[k] : 0.0f;
    }
    oi[OI_VALID * C + c] = valid ? 1 : 0;
    oi[OI_START * C + c] = start;
    oi[OI_CURLEN * C + c] = cur_len;
    oi[OI_ACTIVE * C + c] = active_m;

    if (valid) {
        S(R_REM_CODE) = new_rem;
        S(R_DELTA) = new_delta;
        for (int j = 0; j < 3; ++j) S(R_X + j) = xn[j];
        for (int j = 0; j < 9; ++j) S(R_P + j) = Pn[j];
        S(R_DLL_IN) = code_err;
        S(R_DLL_IN + 1) = d0;
        S(R_DLL_IN + 2) = d1;
        S(R_DLL_OUT) = filt;
        S(R_DLL_OUT + 1) = o0;
        S(R_DLL_OUT + 2) = o1;
        SI(I_START) = start + cur_len;
        SI(I_CURLEN) = next_len;
        SI(I_LOCK_FAIL) = lock_fail;
    }
    SI(I_ACTIVE) = active_m;
    S(R_CN0) = cn0_run;
    for (int j = 0; j < 5; ++j) S(R_NIW + j) = niw[j];
    SI(I_HIST_COUNT) = hist_count;
    SI(I_EPOCHS) = epochs;
#undef S
#undef SI
}

template <int ORDER, bool BAYES>
__global__ void __launch_bounds__(MAX_THREADS)
kf_block_kernel(const float2* __restrict__ x, const float* __restrict__ codes,
                int n_slots, const float* __restrict__ fst,
                const int* __restrict__ ist, float* __restrict__ out_f,
                int* __restrict__ out_i, float* __restrict__ fst_out,
                int* __restrict__ ist_out, const __grid_constant__ KfParams p,
                int wpg) {
    extern __shared__ __align__(16) uint32_t kf_smem[];
    const int C = p.C;
    const int SF = R_HIST + 2 * p.n_hist;
    const int W = (p.code_len + 31) / 32;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int n_warps = blockDim.x >> 5;
    const int G = n_warps / wpg;              // channel groups
    const int g = warp / wpg;                 // this thread's group
    const int T = wpg * 32;                   // threads per group
    const int tg = tid - g * T;               // thread index in its group

    uint32_t* bits = kf_smem;                                  // [C, W]
    float* sf = reinterpret_cast<float*>(bits + C * W);        // [SF, C]
    int* si = reinterpret_cast<int*>(sf + SF * C);             // [7, C]
    CorrArgs* args = reinterpret_cast<CorrArgs*>(si + N_IROWS * C);  // [G]
    float* part = reinterpret_cast<float*>(args + G);          // [warps, 6]
    int* m_s = reinterpret_cast<int*>(part + n_warps * 6);

    for (int j = tid; j < SF * C; j += blockDim.x) sf[j] = fst[j];
    for (int j = tid; j < N_IROWS * C; j += blockDim.x) si[j] = ist[j];
    __syncthreads();
    for (int c = 0; c < C; ++c) {
        int slot = si[I_SLOT * C + c];
        slot = slot < 0 ? 0 : (slot >= n_slots ? n_slots - 1 : slot);
        pack_code_bits(codes + (size_t)slot * p.code_len, p.code_len,
                       bits + c * W, W, warp, n_warps, lane);
    }
    __syncthreads();

    for (int b = 0; b < p.n_blocks; ++b) {
        const float2* xb = x + (size_t)b * p.base;
        const int n_samp = b < p.n_blocks - 1 ? p.base + p.n_max
                                              : p.n_samp - b * p.base;
        const int win = min(p.win, n_samp);
        for (int e = 0; e < p.n_epochs; ++e) {
            const size_t row = (size_t)b * p.n_epochs + e;
            float* of = out_f + row * N_OROWS * C;
            int* oi = out_i + row * N_OIROWS * C;
            if (tid == 0) {
                int m = 1 << 29;
                for (int c = 0; c < C; ++c)
                    if (si[I_ACTIVE * C + c] != 0)
                        m = min(m, si[I_START * C + c]);
                *m_s = min(max(m, 0), n_samp - win);
            }
            __syncthreads();
            const int m = *m_s;
            for (int c0 = 0; c0 < C; c0 += G) {
                const int c = c0 + g;
                const bool mine = g < G && c < C;
                if (mine && tg == 0) {
                    const int start = si[I_START * C + c];
                    const int cur_len = si[I_CURLEN * C + c];
                    const float rem = sf[R_REM_CODE * C + c];
                    const float code_freq = p.chip_rate + sf[R_DELTA * C + c];
                    CorrArgs a;
                    a.valid = si[I_ACTIVE * C + c] != 0 && start < p.base;
                    a.off = m + min(max(start - m, 0), win - p.n_max);
                    a.n_valid = min(cur_len, p.n_max);
                    a.step = code_freq * p.inv_fs;
                    a.rem = code_freq * rem * p.inv_fs;
                    a.cp = sf[R_X * C + c];
                    a.cs = p.two_pi * sf[(R_X + 1) * C + c] * p.inv_fs;
                    a.hr = ORDER == 3
                               ? 0.5f * (p.two_pi * sf[(R_X + 2) * C + c]
                                         * p.inv_fs2)
                               : 0.0f;
                    args[g] = a;
                }
                __syncthreads();
                float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
                if (mine) {
                    const CorrArgs a = args[g];
                    if (a.valid)
                        gather_corr_partial<ORDER>(
                            xb + a.off, a.n_valid, bits + c * W, p.code_len,
                            a.step, a.rem, p.shifts[0], p.shifts[1],
                            p.shifts[2], a.cp, a.cs, a.hr, tg, T, acc);
                    warp_sum6(acc);
                    if (lane == 0)
                        for (int k = 0; k < 6; ++k) part[warp * 6 + k] = acc[k];
                }
                __syncthreads();
                if (mine && tg == 0) {
                    float cr[3] = {0.0f, 0.0f, 0.0f}, ci[3] = {0.0f, 0.0f, 0.0f};
                    for (int w = 0; w < wpg; ++w)
                        for (int k = 0; k < 3; ++k) {
                            cr[k] = cr[k] + part[(g * wpg + w) * 6 + k];
                            ci[k] = ci[k] + part[(g * wpg + w) * 6 + 3 + k];
                        }
                    kf_update<BAYES>(p, sf, si, c, args[g].valid != 0, cr, ci,
                                     of, oi);
                }
                __syncthreads();
            }
        }
        // rebase the epoch starts onto the next block
        for (int c = tid; c < C; c += blockDim.x) si[I_START * C + c] -= p.base;
        __syncthreads();
    }
    for (int j = tid; j < SF * C; j += blockDim.x) fst_out[j] = sf[j];
    for (int j = tid; j < N_IROWS * C; j += blockDim.x) ist_out[j] = si[j];
}

typedef void (*KfKernel)(const float2*, const float*, int, const float*,
                         const int*, float*, int*, float*, int*,
                         const KfParams, int);

static KfKernel kf_kernel_for(int order, int bayes) {
    if (order == 3)
        return bayes ? kf_block_kernel<3, true> : kf_block_kernel<3, false>;
    return bayes ? kf_block_kernel<2, true> : kf_block_kernel<2, false>;
}

// Warps per channel group: up to 8, and at most MAX_THREADS threads in all.
static int warps_per_group(int C) {
    const int w = (MAX_THREADS / 32) / (C < 1 ? 1 : C);
    return w < 1 ? 1 : (w > 8 ? 8 : w);
}

// One launch: every epoch of the n_blocks blocks on `stream`.  Checks the
// launch, never synchronises and allocates nothing; returns the CUDA error.
extern "C" int kf_block_launch(const void* x, const void* codes, int n_slots,
                               const void* fst, const void* ist, void* out_f,
                               void* out_i, void* fst_out, void* ist_out,
                               const KfParams* params, void* stream) {
    const KfParams p = *params;
    if (p.C < 1 || p.n_hist < 1 || p.code_len < 1 || n_slots < 1 ||
        (p.order != 2 && p.order != 3))
        return (int)cudaErrorInvalidValue;
    const int wpg = warps_per_group(p.C);
    const int groups = (MAX_THREADS / 32) / wpg;
    const int G = groups < p.C ? groups : p.C;
    const int threads = G * wpg * 32;
    const int SF = R_HIST + 2 * p.n_hist;
    const int W = (p.code_len + 31) / 32;
    const size_t smem = (size_t)p.C * W * 4 + (size_t)SF * p.C * 4
                        + (size_t)N_IROWS * p.C * 4 + G * sizeof(CorrArgs)
                        + (size_t)(threads / 32) * 6 * 4 + 16;
    KfKernel kernel = kf_kernel_for(p.order, p.bayes_run);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<1, threads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(x),
        reinterpret_cast<const float*>(codes), n_slots,
        reinterpret_cast<const float*>(fst), reinterpret_cast<const int*>(ist),
        reinterpret_cast<float*>(out_f), reinterpret_cast<int*>(out_i),
        reinterpret_cast<float*>(fst_out), reinterpret_cast<int*>(ist_out), p,
        wpg);
    return (int)cudaGetLastError();
}
