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
// pass, one block reduction, one scalar update and one exchange of m each.
//
// Design, against that chain (the cluster, the exchange of m and the
// prefetch are cluster_walk.cuh's, shared with gather_block.cu):
// - one thread block (CTA) of KF_THREADS threads per channel, all of them
//   in one thread-block cluster of n_cta = min(C, max_cluster) CTAs; CTA r
//   takes channels r, r + n_cta, ... in rounds, so rounds happen only when
//   C exceeds the cluster;
// - m through distributed shared memory: each CTA's thread 0 writes the
//   minimum start of its active channels into slot e & 1 of its own shared
//   memory, one cluster barrier per epoch, then every warp reads all the
//   ranks' slots (a lane each) and takes the same integer minimum; the
//   double-buffered slot makes one barrier an epoch enough (a slot is
//   written again only after every peer has passed the next barrier);
// - the correlation spreads over warps 1.. of the CTA (gather_corr_taps
//   over KF_THREADS - 32 threads, warp sums, one shared-memory pass by
//   warp 0);
// - the scalar update runs on lane 0 of warp 0 with up to 128 registers
//   (__launch_bounds__(KF_THREADS, 1)) in two parts: what it takes from
//   the state alone (the KF predict, R from the running CN0, the DLL
//   filter's old terms, the CN0 / lock sums over the history rows that
//   stay) while warps 1.. correlate, kept in shared memory so that it is
//   done before the barrier; the rest once the taps are in, with the
//   prompt-history shift on the lanes of warp 0; every sum keeps the plain
//   version's left-to-right order;
// - the next epoch's samples are prefetched: the next window starts at
//   start + cur_len, known before the update runs, so thread 0 copies
//   n_max samples from there into the channel's shared-memory buffer with
//   one bulk copy (cp.async.bulk onto an mbarrier) while the update runs;
//   the next epoch correlates from it when its offset is that start, and
//   from global memory when the clamp to m moves the window.  Whether the
//   buffers exist is decided from the shape (ops/kf_block.py
//   kf_geometry: they fit in shared memory or not);
// - the state lives in each CTA's shared memory as its own channels'
//   columns of the plain version's rows, the code tables of its channels'
//   slots as bits; the walk rebases the epoch starts by `base` between
//   blocks, so one launch covers a capture segment.
// With -DKF_BLOCK_STAGES the kernel also writes a timeline of every epoch
// of CTA 0's first channel to `stages` (TL_* below): SM clock stamps of
// thread 0, which runs the update, and of thread 32, which correlates,
// each taken right after work of its own thread, never right after a
// barrier (ptxas may hoist a clock read above one).  A separate build;
// the library the package loads is built without it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false,
// WITHOUT --use_fast_math, so atan2f / log10f / powf keep full float32
// accuracy and products round op by op like the plain version.  Both
// divide by a constant (fs, fs^2, 10, N) as a multiply by its float32
// reciprocal, as the JAX package's compiled step does.

#include <cooperative_groups.h>

#include <cstdint>

#include "cluster_walk.cuh"
#include "gather_corr.cuh"

namespace cg = cooperative_groups;

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

// launch geometry (ops/kf_block.py KF_THREADS, KF_MAX_CLUSTER)
#define KF_THREADS 512
#define KF_WARPS (KF_THREADS / 32)
#define KF_MAX_CLUSTER 16
// the timeline of one epoch (KF_BLOCK_STAGES builds): SM clock cycles
#define TL_START 0     // thread 0: the epoch begins (its local minimum next)
#define TL_M0 1        // thread 0: m known
#define TL_PRE 2       // thread 0: the update's state-only part done
#define TL_RED 3       // thread 0: the taps reduced (after the barrier)
#define TL_UPD 4       // thread 0: the update done
#define TL_M32 5       // thread 32: m known
#define TL_WAIT 6      // thread 32: the prefetch wait done
#define TL_SAMP 7      // thread 32: its share of the samples done
#define TL_PART 8      // thread 32: its warp's sums stored (barrier next)
#define TL_HIT 9       // 1 where the epoch read the prefetch buffer
#define KF_STAGE_POINTS 10
#define KF_PRE_BYTES 160

#ifdef KF_BLOCK_STAGES
constexpr bool kStages = true;
#else
constexpr bool kStages = false;
#endif

struct KfParams {
    int C, n_hist, code_len, n_max, win, base, n_epochs, n_blocks, n_samp;
    int order, bayes_run, bayes_ptrans, bayes_strans, max_lock_fail, t0_int;
    float chip_rate, fs, two_pi, fs2, t, aid, t0_int_f, t0_frac;
    float cn0_min_dbhz, carrier_lock_th, cn0_log_t;
    float inv_fs, inv_fs2, inv_n_hist, tenth;   // float32 reciprocals
    float shifts[3], F[9], Q[9], dll_b_in[4], dll_b_out[3];
    // launch geometry (ops/kf_block.py kf_geometry), checked at launch
    int n_cta, cpc, threads, prefetch, pf_bytes, smem;
};

// Byte offsets of one CTA's dynamic shared memory (ops/kf_block.py
// kf_layout): the prefetch mbarriers [cpc], the two m slots, the prefetch
// records [cpc][4], the prefetch buffers [cpc][pf_bytes], the code bits
// [cpc][W], the float and int state rows [SF][cpc] and [7][cpc], the warp
// partial sums [2][KF_WARPS][6] and the update's state-only part (KfPre).
struct KfLayout {
    int bar, slot, info, pf, bits, sf, si, part, pre, total;
};

__host__ __device__ inline KfLayout kf_layout(const KfParams& p) {
    const int W = (p.code_len + 31) / 32;
    const int SF = R_HIST + 2 * p.n_hist;
    KfLayout l;
    l.bar = 0;
    l.slot = 8 * p.cpc;
    l.info = l.slot + 8;
    l.pf = round16(l.info + 16 * p.cpc);
    l.bits = l.pf + (p.prefetch ? p.cpc * p.pf_bytes : 0);
    l.sf = l.bits + 4 * p.cpc * W;
    l.si = l.sf + 4 * SF * p.cpc;
    l.part = l.si + 4 * N_IROWS * p.cpc;
    l.pre = l.part + 4 * 2 * KF_WARPS * 6;
    l.total = l.pre + KF_PRE_BYTES;
    return l;
}

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

// The SM clock, for the stage build's timeline
__device__ __forceinline__ long long stage_clock() {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t) :: "memory");
    return t;
}

// What one channel's scalar epoch update reads of its state, and what it
// computes from the state alone: lane 0 of warp 0 runs this while the
// other warps correlate (column j of the CTA's shared rows, stride ld).
struct KfPre {
    int active, start, cur_len, epochs0, lf0, hist0;
    float rem, delta, cn0_old, r;
    float X[3], xp[3], Pp[9], niw[5];
    float d0, d1, o0, o1, dll_out, dll_in;
    // the CN0 / lock sums over the history rows that stay, left to right
    float sabs, stot, i2, q2;
};
static_assert(sizeof(KfPre) == KF_PRE_BYTES, "KfPre layout");

__device__ __forceinline__ KfPre kf_pre(const KfParams& p, const float* sf,
                                        const int* si, int ld, int j,
                                        bool valid) {
    const int N = p.n_hist;
#define S(row) sf[(row) * ld + j]
#define SI(row) si[(row) * ld + j]
    KfPre q;
    q.active = SI(I_ACTIVE);
    q.start = SI(I_START);
    q.cur_len = SI(I_CURLEN);
    q.epochs0 = SI(I_EPOCHS);
    q.lf0 = SI(I_LOCK_FAIL);
    q.hist0 = SI(I_HIST_COUNT);
    q.rem = S(R_REM_CODE);
    q.delta = S(R_DELTA);
    float P[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) q.X[k] = S(R_X + k);
#pragma unroll
    for (int k = 0; k < 9; ++k) P[k] = S(R_P + k);
#pragma unroll
    for (int k = 0; k < 5; ++k) q.niw[k] = S(R_NIW + k);
    const float* F = p.F;

    // --- KF predict: x_pre = F x, P_pre = F P F' + Q (sums left to right)
    float A[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
        q.xp[i] = (F[i * 3] * q.X[0] + F[i * 3 + 1] * q.X[1])
                  + F[i * 3 + 2] * q.X[2];
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
            q.Pp[i * 3 + l] =
                ((A[i * 3] * F[l * 3] + A[i * 3 + 1] * F[l * 3 + 1])
                 + A[i * 3 + 2] * F[l * 3 + 2]) + p.Q[i * 3 + l];

    // --- R from the running CN0
    q.cn0_old = S(R_CN0);
    const float cn_lin = powf(10.0f, q.cn0_old * p.tenth);
    const float a = 1.0f / (2.0f * cn_lin * p.t);
    q.r = a * (1.0f + a);

    // --- the DLL filter's terms that do not take this epoch's error
    const float* bi = p.dll_b_in;
    const float* bo = p.dll_b_out;
    q.d0 = S(R_DLL_IN);
    q.d1 = S(R_DLL_IN + 1);
    const float d2 = S(R_DLL_IN + 2);
    q.o0 = S(R_DLL_OUT);
    q.o1 = S(R_DLL_OUT + 1);
    const float o2 = S(R_DLL_OUT + 2);
    q.dll_out = (bo[0] * q.o0 + bo[1] * q.o1) + bo[2] * o2;
    q.dll_in = (bi[1] * q.d0 + bi[2] * q.d1) + bi[3] * d2;

    // --- the history sums up to the new prompt: a valid epoch drops the
    // oldest row and appends its prompt last
    const float* hr = sf + R_HIST * ld + j;          // row n at hr[n * ld]
    const float* hq = sf + (R_HIST + N) * ld + j;
    q.sabs = 0.0f;
    q.stot = 0.0f;
    q.i2 = 0.0f;
    q.q2 = 0.0f;
    for (int n = valid ? 1 : 0; n < N; ++n) {
        const float vi = hr[n * ld], vq = hq[n * ld];
        q.sabs = q.sabs + fabsf(vi);
        q.stot = q.stot + (vi * vi + vq * vq);
        q.i2 = q.i2 + vi * vi;
        q.q2 = q.q2 + vq * vq;
    }
#undef S
#undef SI
    return q;
}

// The rest of the channel's update once its taps are in (lane 0 of warp
// 0): the Costas measurement, the NIW covariance and the scalar update,
// the DLL, the next epoch length and the CN0 / lock supervision; writes
// column j of the shared state rows and column c of the output rows.  The
// prompt history has already been shifted (hist_shift).
template <bool BAYES>
__device__ __forceinline__ void kf_post(const KfParams& p, const KfPre& q,
                                        float* sf, int* si, int ld, int j,
                                        int c, bool valid, const float cr[3],
                                        const float ci[3], float* of,
                                        int* oi) {
    const int C = p.C;
    const int N = p.n_hist;
#define S(row) sf[(row) * ld + j]
#define SI(row) si[(row) * ld + j]
    const float pr = cr[1], pq = ci[1];
    const float* Pp = q.Pp;

    // --- measurement: two-quadrant Costas atan
    const float sgn = pr > 0.0f ? 1.0f : (pr < 0.0f ? -1.0f : 0.0f);
    const float y = pr != 0.0f ? atan2f(pq * sgn, fabsf(pr)) : 0.0f;
    const float r = q.r;

    // --- NIW innovation covariance (sequential K=1 update)
    float niw[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) niw[k] = q.niw[k];
    float p_y, r_est;
    if (BAYES) {
        const bool upd = valid && q.epochs0 >= p.bayes_ptrans;
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
        const bool use_bayes = q.epochs0 >= p.bayes_ptrans + p.bayes_strans;
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
    for (int i = 0; i < 3; ++i) xn[i] = q.xp[i] + K[i] * y;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            Pn[i * 3 + k] = Pp[i * 3 + k] - K[i] * Pp[k];

    // --- DLL with carrier aiding
    const float e = hypotf(cr[0], ci[0]);
    const float l = hypotf(cr[2], ci[2]);
    const float s = e + l;
    const float code_err = s > 0.0f ? 0.5f * (e - l) / s : 0.0f;
    const float filt = (q.dll_out + p.dll_b_in[0] * code_err) + q.dll_in;
    const float new_delta = p.aid * xn[1] - filt;

    // --- next epoch length (split precision)
    const float ncf = p.chip_rate + new_delta;
    const float d_t = -(p.t0_int_f * new_delta / ncf
                        + p.t0_frac * new_delta / ncf);
    const float frac = (p.t0_frac + d_t) + q.rem;
    const float ff = floorf(frac);
    const int next_len = p.t0_int + (int)ff;
    const float new_rem = frac - ff;

    // --- CN0 / lock supervision over the (shifted) prompt history, each
    // sum left to right: the new prompt is the last term
    float sabs = q.sabs, stot = q.stot, i2 = q.i2, q2 = q.q2;
    if (valid) {
        sabs = sabs + fabsf(pr);
        stot = stot + (pr * pr + pq * pq);
        i2 = i2 + pr * pr;
        q2 = q2 + pq * pq;
    }
    const int hist_count = min(q.hist0 + (valid ? 1 : 0), N);
    const bool hist_full = hist_count >= N;
    const float mabs = sabs * p.inv_n_hist;
    const float psig = mabs * mabs;
    const float ptot = stot * p.inv_n_hist;
    const float noise = clamp_min(ptot - psig, TINY_F);
    const float cn0 = 10.0f * log10f(clamp_min(psig / noise, 1e-10f))
                      - p.cn0_log_t;
    const float lock = (i2 - q2) / clamp_min(i2 + q2, TINY_F);
    const float cn0_run = (valid && hist_full) ? cn0 : q.cn0_old;
    const int epochs = q.epochs0 + (valid ? 1 : 0);
    const bool check_now = valid && hist_full && (epochs % N == 0);
    const bool fail = check_now && (cn0 < p.cn0_min_dbhz
                                    || lock < p.carrier_lock_th);
    const int lock_fail = fail ? q.lf0 + 1
                               : (check_now ? max(q.lf0 - 1, 0) : q.lf0);
    const bool still_active = q.active && lock_fail <= p.max_lock_fail;

    // --- merge by valid, outputs
    const int active_m = valid ? (int)still_active : q.active;
    const float x0m = valid ? xn[0] : q.X[0];
    const float x1m = valid ? xn[1] : q.X[1];
    const float x2m = valid ? xn[2] : q.X[2];
    const float delta_m = valid ? new_delta : q.delta;
    const float rem_m = valid ? new_rem : q.rem;
    of[O_DOPPLER * C + c] = x1m;
    of[O_DOPPLER_RATE * C + c] = x2m;
    of[O_SIGMA2 * C + c] = valid ? r_est : 0.0f;
    of[O_DELTA * C + c] = delta_m;
    of[O_REM_CODE * C + c] = rem_m;
    of[O_REM_CARR * C + c] = mod_floor(x0m, p.two_pi);
    of[O_CN0 * C + c] = (valid && hist_full) ? cn0 : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        of[(O_CORR + k) * C + c] = valid ? cr[k] : 0.0f;
        of[(O_CORR + 3 + k) * C + c] = valid ? ci[k] : 0.0f;
    }
    oi[OI_VALID * C + c] = valid ? 1 : 0;
    oi[OI_START * C + c] = q.start;
    oi[OI_CURLEN * C + c] = q.cur_len;
    oi[OI_ACTIVE * C + c] = active_m;

    if (valid) {
        S(R_REM_CODE) = new_rem;
        S(R_DELTA) = new_delta;
#pragma unroll
        for (int k = 0; k < 3; ++k) S(R_X + k) = xn[k];
#pragma unroll
        for (int k = 0; k < 9; ++k) S(R_P + k) = Pn[k];
        S(R_DLL_IN) = code_err;
        S(R_DLL_IN + 1) = q.d0;
        S(R_DLL_IN + 2) = q.d1;
        S(R_DLL_OUT) = filt;
        S(R_DLL_OUT + 1) = q.o0;
        S(R_DLL_OUT + 2) = q.o1;
        SI(I_START) = q.start + q.cur_len;
        SI(I_CURLEN) = next_len;
        SI(I_LOCK_FAIL) = lock_fail;
    }
    SI(I_ACTIVE) = active_m;
    S(R_CN0) = cn0_run;
#pragma unroll
    for (int k = 0; k < 5; ++k) S(R_NIW + k) = niw[k];
    SI(I_HIST_COUNT) = hist_count;
    SI(I_EPOCHS) = epochs;
#undef S
#undef SI
}

// The prompt history of column j moved one row up (oldest row dropped) and
// the new prompt written last, by the 32 lanes of one warp: a copy, exact
// in any order; each pass of 32 rows reads before it writes.
__device__ __forceinline__ void hist_shift(float* sf, int ld, int j, int N,
                                           float pr, float pq, int lane) {
    float* hr = sf + R_HIST * ld + j;
    float* hq = sf + (R_HIST + N) * ld + j;
    for (int n0 = 0; n0 + 1 < N; n0 += 32) {
        const int n = n0 + lane;
        const bool mine = n + 1 < N;
        float vi = 0.0f, vq = 0.0f;
        if (mine) {
            vi = hr[(n + 1) * ld];
            vq = hq[(n + 1) * ld];
        }
        __syncwarp();
        if (mine) {
            hr[n * ld] = vi;
            hq[n * ld] = vq;
        }
        __syncwarp();
    }
    if (lane == 0) {
        hr[(N - 1) * ld] = pr;
        hq[(N - 1) * ld] = pq;
    }
    __syncwarp();
}

// Every CTA barrier below is cta_barrier() (cluster_walk.cuh): lane 0 of
// warp 0 runs long stretches alone (the update, the prefetch issue), and
// on the H100 a lane that reached a bare __syncthreads() after the rest of
// its warp was let through without waiting for the other warps.
template <int ORDER, bool BAYES>
__global__ void __launch_bounds__(KF_THREADS, 1)
kf_block_kernel(const float2* __restrict__ x, const float* __restrict__ codes,
                int n_slots, const float* __restrict__ fst,
                const int* __restrict__ ist, float* __restrict__ out_f,
                int* __restrict__ out_i, float* __restrict__ fst_out,
                int* __restrict__ ist_out, long long* __restrict__ stages,
                const __grid_constant__ KfParams p) {
    extern __shared__ __align__(16) unsigned char kf_smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const KfLayout lay = kf_layout(p);
    const int C = p.C, n_cta = p.n_cta, ld = p.cpc;
    const int rank = (int)cluster.block_rank();
    const int n_own = (C - rank + n_cta - 1) / n_cta;   // r, r + n_cta, ...
    const int SF = R_HIST + 2 * p.n_hist;
    const int W = (p.code_len + 31) / 32;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int pf_len = p.pf_bytes / 8;                    // float2 per buffer

    uint64_t* bar = reinterpret_cast<uint64_t*>(kf_smem + lay.bar);
    int* slot = reinterpret_cast<int*>(kf_smem + lay.slot);
    int* info = reinterpret_cast<int*>(kf_smem + lay.info);
    float2* pf = reinterpret_cast<float2*>(kf_smem + lay.pf);
    uint32_t* bits = reinterpret_cast<uint32_t*>(kf_smem + lay.bits);
    float* sf = reinterpret_cast<float*>(kf_smem + lay.sf);
    int* si = reinterpret_cast<int*>(kf_smem + lay.si);
    float* part = reinterpret_cast<float*>(kf_smem + lay.part);
    KfPre* pre_s = reinterpret_cast<KfPre*>(kf_smem + lay.pre);

    load_columns(sf, fst, SF, n_own, ld, C, rank, n_cta, tid, KF_THREADS);
    load_columns(si, ist, N_IROWS, n_own, ld, C, rank, n_cta, tid,
                 KF_THREADS);
    if (tid == 0) prefetch_init(bar, info, n_own);
    cta_barrier();
    for (int j = 0; j < n_own; ++j) {
        int s = si[I_SLOT * ld + j];
        s = s < 0 ? 0 : (s >= n_slots ? n_slots - 1 : s);
        pack_code_bits(codes + (size_t)s * p.code_len, p.code_len,
                       bits + j * W, W, warp, KF_WARPS, lane);
    }
    cta_barrier();

    // the timeline's writers (KF_BLOCK_STAGES builds only)
    const bool tl0 = kStages && stages != nullptr && rank == 0 && tid == 0;
    const bool tl32 = kStages && stages != nullptr && rank == 0 && tid == 32;

    int parity = 0;                               // the m slot of this epoch
    for (int b = 0; b < p.n_blocks; ++b) {
        const float2* xb = x + (size_t)b * p.base;
        const int n_samp = b < p.n_blocks - 1 ? p.base + p.n_max
                                              : p.n_samp - b * p.base;
        const int win = min(p.win, n_samp);
        for (int e = 0; e < p.n_epochs; ++e, parity ^= 1) {
            const size_t row = (size_t)b * p.n_epochs + e;
            float* of = out_f + row * N_OROWS * C;
            int* oi = out_i + row * N_OIROWS * C;
            long long* tl = kStages ? stages + row * KF_STAGE_POINTS : nullptr;
            if (tl0) tl[TL_START] = stage_clock();
            // thread 0 wrote every state word of this CTA: its minimum
            int local = 1 << 29;
            if (tid == 0)
                for (int j = 0; j < n_own; ++j)
                    if (si[I_ACTIVE * ld + j] != 0)
                        local = min(local, si[I_START * ld + j]);
            const int m = min(max(cluster_min(cluster, slot, parity, local,
                                              tid, lane, n_cta), 0),
                              n_samp - win);
            if (tl0) tl[TL_M0] = stage_clock();
            if (tl32) tl[TL_M32] = stage_clock();
            for (int j = 0; j < n_own; ++j) {
                const int c = rank + j * n_cta;
                const int start = si[I_START * ld + j];
                const int cur_len = si[I_CURLEN * ld + j];
                const bool valid = si[I_ACTIVE * ld + j] != 0
                                   && start < p.base;
                float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
                if (warp == 0) {
                    // the update's state-only part, while warps 1.. correlate
                    // (kept in shared memory, so it is computed before the
                    // barrier and not moved after it)
                    if (lane == 0) {
                        *pre_s = kf_pre(p, sf, si, ld, j, valid);
                        if (tl0 && j == 0) tl[TL_PRE] = stage_clock();
                    }
                } else if (valid) {
                    const float rem = sf[R_REM_CODE * ld + j];
                    const float code_freq = p.chip_rate
                                            + sf[R_DELTA * ld + j];
                    const int off = m + min(max(start - m, 0),
                                            win - p.n_max);
                    const float2* src = prefetched(
                        info + 4 * j, bar + j, pf + (size_t)j * pf_len,
                        b * p.base + off, xb + off);
                    if (tl32 && j == 0) {
                        tl[TL_WAIT] = stage_clock();
                        tl[TL_HIT] = src != xb + off;
                    }
                    gather_corr_taps<3, ORDER>(
                        src, min(cur_len, p.n_max), bits + j * W,
                        p.code_len, code_freq * p.inv_fs,
                        code_freq * rem * p.inv_fs, p.shifts,
                        sf[R_X * ld + j],
                        p.two_pi * sf[(R_X + 1) * ld + j] * p.inv_fs,
                        ORDER == 3 ? 0.5f * (p.two_pi * sf[(R_X + 2) * ld + j]
                                             * p.inv_fs2)
                                   : 0.0f,
                        tid - 32, KF_THREADS - 32, acc);
                    if (tl32 && j == 0) tl[TL_SAMP] = stage_clock();
                }
                float* pj = part + (j & 1) * KF_WARPS * 6;
                if (warp != 0) {
                    warp_sum<6>(acc);
                    if (lane == 0) {
#pragma unroll
                        for (int k = 0; k < 6; ++k) pj[warp * 6 + k] = acc[k];
                    }
                    if (tl32 && j == 0) tl[TL_PART] = stage_clock();
                }
                cta_barrier();
                if (tid == 0 && valid) {
                    // the pending copy was consumed above; prefetch the
                    // next window, start + cur_len, where its block
                    // (rebased) is walked
                    const int gs = b * p.base + start + cur_len;
                    prefetch_next(info + 4 * j, bar + j,
                                  pf + (size_t)j * pf_len, x, p.n_samp, gs,
                                  p.n_max,
                                  p.prefetch && gs < p.n_blocks * p.base);
                }
                if (warp == 0) {
                    float s6[6];
#pragma unroll
                    for (int k = 0; k < 6; ++k)
                        s6[k] = lane >= 1 && lane < KF_WARPS
                                    ? pj[lane * 6 + k] : 0.0f;
                    warp_sum<6>(s6);
                    if (tl0 && j == 0) tl[TL_RED] = stage_clock();
                    const float pr = __shfl_sync(0xffffffffu, s6[1], 0);
                    const float pq = __shfl_sync(0xffffffffu, s6[4], 0);
                    if (valid) hist_shift(sf, ld, j, p.n_hist, pr, pq, lane);
                    if (lane == 0) {
                        const float cr[3] = {s6[0], s6[1], s6[2]};
                        const float ci[3] = {s6[3], s6[4], s6[5]};
                        const KfPre pre = *pre_s;
                        kf_post<BAYES>(p, pre, sf, si, ld, j, c, valid, cr,
                                       ci, of, oi);
                        if (tl0 && j == 0) tl[TL_UPD] = stage_clock();
                    }
                }
            }
        }
        // rebase the epoch starts onto the next block (thread 0 owns them)
        if (tid == 0)
            for (int j = 0; j < n_own; ++j) si[I_START * ld + j] -= p.base;
    }
    if (tid == 0) prefetch_drain(bar, info, n_own);
    cta_barrier();
    store_columns(fst_out, sf, SF, n_own, ld, C, rank, n_cta, tid,
                  KF_THREADS);
    store_columns(ist_out, si, N_IROWS, n_own, ld, C, rank, n_cta, tid,
                  KF_THREADS);
    // no peer may read this CTA's m slots after it exits
    __syncwarp();
    cluster.sync();
}

typedef void (*KfKernel)(const float2*, const float*, int, const float*,
                         const int*, float*, int*, float*, int*, long long*,
                         const KfParams);

static KfKernel kf_kernel_for(int order, int bayes) {
    if (order == 3)
        return bayes ? kf_block_kernel<3, true> : kf_block_kernel<3, false>;
    return bayes ? kf_block_kernel<2, true> : kf_block_kernel<2, false>;
}

// The largest cluster of KF_THREADS-thread CTAs with `smem` bytes of
// dynamic shared memory each that the card can schedule, up to
// KF_MAX_CLUSTER (cluster_walk.cuh cluster_max).
extern "C" int kf_block_max_cluster(int order, int bayes, int smem) {
    return cluster_max(reinterpret_cast<const void*>(
                           kf_kernel_for(order, bayes)),
                       KF_THREADS, smem, KF_MAX_CLUSTER);
}

// One launch: every epoch of the n_blocks blocks on `stream`, as one
// cluster of n_cta CTAs.  Checks the geometry against the layout, checks
// the launch, never synchronises and allocates nothing; returns the CUDA
// error.  `stages`: int64 [n_blocks * n_epochs][KF_STAGE_POINTS] on the
// card, zeroed, for a KF_BLOCK_STAGES build (the timeline), else null.
extern "C" int kf_block_launch(const void* x, const void* codes, int n_slots,
                               const void* fst, const void* ist, void* out_f,
                               void* out_i, void* fst_out, void* ist_out,
                               void* stages, const KfParams* params,
                               void* stream) {
    const KfParams p = *params;
    if (p.C < 1 || p.n_hist < 1 || p.code_len < 1 || n_slots < 1 ||
        (p.order != 2 && p.order != 3))
        return (int)cudaErrorInvalidValue;
    if (p.threads != KF_THREADS || p.n_cta < 1 || p.n_cta > KF_MAX_CLUSTER
        || p.n_cta > p.C || p.cpc != (p.C + p.n_cta - 1) / p.n_cta
        || (p.prefetch && p.pf_bytes != prefetch_bytes(p.n_max))
        || p.smem != kf_layout(p).total || p.smem > CLUSTER_SMEM_MAX
        || (stages != nullptr) != kStages)
        return (int)cudaErrorInvalidConfiguration;
    KfKernel kernel = kf_kernel_for(p.order, p.bayes_run);
    cudaError_t err = cluster_set_attributes(
        reinterpret_cast<const void*>(kernel), p.smem, p.n_cta);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(
        p.n_cta, KF_THREADS, p.smem, &attr,
        reinterpret_cast<cudaStream_t>(stream));
    err = cudaLaunchKernelEx(
        &cfg, kernel, reinterpret_cast<const float2*>(x),
        reinterpret_cast<const float*>(codes), n_slots,
        reinterpret_cast<const float*>(fst), reinterpret_cast<const int*>(ist),
        reinterpret_cast<float*>(out_f), reinterpret_cast<int*>(out_i),
        reinterpret_cast<float*>(fst_out), reinterpret_cast<int*>(ist_out),
        reinterpret_cast<long long*>(stages), p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
