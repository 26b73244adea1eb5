// Fused chunk correlator for NVIDIA Hopper (sm_90a): regular-grid window,
// frozen-NCO carrier wipe-off and lag correlation of one tracking chunk.
//
// Replaces the XLA stages of the JAX package's chunked engine
// (gnss_sdr_1_tpu/track/engine.py `_chunk_windows` and the two `einsum`s
// of `_pallas_chunk`), which the port first ran as ~20 elementwise torch
// launches plus a cuBLAS `bmm` per I/Q plane.  Computes what the plain
// version gnss_sdr_1_tpu_torch/ops/chunk_corr.py:correlate_plain computes,
// in the layout the chain kernel reads: z[c, e, l] channel-major.
//
// Design: one block per (epoch, channel).  The block
//   1. starts an asynchronous copy (cp.async, 16 B) of its channel's
//      Toeplitz replica row into shared memory: R[s, l, n] depends on
//      n - l only, so one row rows[s, n - l + LW - 1] replaces the LW x NW
//      bank;
//   2. predicts the epoch's start and length under the frozen code
//      frequency (the same float32 operations, in the same order, as the
//      plain version: the mask edges must match it bit for bit) and wipes
//      the epoch's samples into shared memory, once per sample;
//   3. correlates: each thread owns TL consecutive lags and one slice of
//      the n range.  Walking n, lag l0 + j needs row[n - l0 - j], so a
//      thread keeps a sliding window of the row in registers and loads one
//      new row value per sample: per sample 1 + 1 shared loads feed 2 TL
//      fused multiply-adds;
//   4. sums the slices' partial sums through shared memory.
//
// What bounds it: at the main path's shape (E = 16, C = 12, LW = 68,
// NW = 4136) the product is 2 x 12 x 16 x 68 x ~4092 multiply-adds
// (~214 MFLOP, 3.2 us at 67 TFLOP/s float32) against ~6.6 MB of samples,
// rows and outputs (2.0 us at 3.35 TB/s): operations.  The thread tiling
// keeps the shared-memory traffic below the FMA rate (two loads per 2 TL
// FMAs) and, at LW = 68 (four lag groups of 17), free of bank conflicts.
//
// Numerics: the product sums use fmaf explicitly (the library is built
// with --fmad=false so that everything else rounds op by op like the plain
// version); the sums run in another order than cuBLAS or the CPU.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "rows.cuh"

#define TWO_PI_F 6.283185307179586f
#define PI_F 3.141592653589793f

// lags per thread (ops/chunk_corr.py TL; checked at launch)
#define CC_TL 17

// Mirror of ops/chunk_corr.py CorrParams; the block geometry (S, L, wbuf,
// qs, smem_bytes) is computed there.
struct CorrParams {
    int E, LW, NW, C, QW, t0_int, grid_pad, seg_len;
    int tl, threads, padl, S, L, wbuf, qs, smem_bytes;
    float t0_frac, neg_t0, chip_rate, fs;
};

// numpy/JAX `mod`: result takes the sign of the divisor (exact fmod, then
// + m where the signs differ).  fmodf alone would keep the dividend's sign.
__device__ __forceinline__ float mod_floor(float x, float m) {
    float r = fmodf(x, m);
    if (r != 0.0f && ((r < 0.0f) != (m < 0.0f))) r += m;
    return r;
}

__device__ __forceinline__ void cp_async16(float* smem_dst,
                                           const float* gmem_src) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async4(void* smem_dst,
                                          const void* gmem_src) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(gmem_src));
}

// predicted start of epoch k >= 1 of the chunk (plain: s_pred[:, k])
__device__ __forceinline__ int predicted_start(int start, int cur_len,
                                               float rem_code, float c_step,
                                               int t0_int, int k) {
    const float r = rem_code + (float)(k - 1) * c_step;
    return start + cur_len + (k - 1) * t0_int + (int)floorf(r);
}

template <int TL>
__global__ void __launch_bounds__(256)
chunk_corr_kernel(const float2* __restrict__ x, int n_samp,
                  const float* __restrict__ rows,
                  const int* __restrict__ slot,
                  const float* __restrict__ fst, const int* __restrict__ ist,
                  float* __restrict__ zr, float* __restrict__ zi,
                  int* __restrict__ s_reg_out, float* __restrict__ step0_out,
                  const CorrParams p) {
    extern __shared__ __align__(16) float cc_smem[];
    const int e = blockIdx.x;
    const int c = blockIdx.y;
    const int C = p.C;
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int SL = p.S * p.L;
    float2* w = reinterpret_cast<float2*>(cc_smem);    // [SL] wiped samples
    float* q = cc_smem + p.wbuf;                       // [qs] replica row

    // ---- 1. replica row -> shared memory, behind PADL zeros ----
    const float* qrow = rows + (size_t)slot[c] * p.QW;
    for (int i = tid; i < p.QW / 4; i += nthr)
        cp_async16(q + p.padl + 4 * i, qrow + 4 * i);
    asm volatile("cp.async.commit_group;\n" ::);
    for (int i = tid; i < p.padl; i += nthr) q[i] = 0.0f;
    for (int i = p.padl + p.QW + tid; i < p.qs; i += nthr) q[i] = 0.0f;

    // ---- 2. epoch geometry under the frozen code frequency ----
    const int start = ist[I_START * C + c];
    const int cur_len = ist[I_CURLEN * C + c];
    const float rem_code = fst[F_REM_CODE * C + c];
    const float delta0 = fst[F_DELTA * C + c];
    const float codef0 = p.chip_rate + delta0;
    const float d_t0 = p.neg_t0 * delta0 / codef0;
    const float c_step = p.t0_frac + d_t0;
    const int s_pred = e == 0 ? start
        : predicted_start(start, cur_len, rem_code, c_step, p.t0_int, e);
    const int s_next =
        predicted_start(start, cur_len, rem_code, c_step, p.t0_int, e + 1);
    const int len_pred = s_next - s_pred;
    const int off = min(max(start - p.grid_pad, 0), n_samp - p.seg_len);
    const int s_reg = off + e * p.t0_int;
    const int dp = s_pred - s_reg;
    const float step0 = TWO_PI_F * (fst[F_DOPPLER * C + c]
                                     + fst[F_CARR_OFF * C + c]) / p.fs;
    const float phi = mod_floor(fst[F_REM_CARR * C + c]
                                + step0 * (float)(s_reg - start), TWO_PI_F);
    if (tid == 0) {
        s_reg_out[c * p.E + e] = s_reg;
        if (e == 0) step0_out[c] = step0;
    }

    // ---- wipe-off into shared memory, zero outside the epoch ----
    const float2* xs = x + s_reg;
    for (int n = tid; n < SL; n += nthr) {
        float2 v = make_float2(0.0f, 0.0f);
        if (n >= dp && n < dp + len_pred && n < p.NW) {
            const float2 s = xs[n];
            const float ph = phi + step0 * (float)n;
            float sn, cs;
            sincosf(ph, &sn, &cs);
            // (re + j im) * (cos - j sin)
            v.x = s.x * cs + s.y * sn;
            v.y = s.y * cs - s.x * sn;
        }
        w[n] = v;
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    // ---- 3. lag correlation: TL lags x one n slice per thread ----
    const int NG = (p.LW + TL - 1) / TL;
    const bool worker = tid < NG * p.S;
    const int g = tid % NG;
    const int sl = tid / NG;
    float ar[TL], ai[TL];
#pragma unroll
    for (int j = 0; j < TL; ++j) { ar[j] = 0.0f; ai[j] = 0.0f; }
    if (worker) {
        const int l0 = g * TL;
        int n0 = sl * p.L;
        // row index of (n0, l0); lag l0 + j at sample n0 + u reads
        // q[b + u - j]: hi[] holds q[b .. b+TL-1], lo[] q[b-TL+1 .. b-1]
        int b = n0 - l0 + p.LW - 1 + p.padl;
        float lo[TL - 1], hi[TL];
#pragma unroll
        for (int m = 0; m < TL - 1; ++m) lo[m] = q[b - (TL - 1) + m];
        for (int blk = 0; blk < p.L / TL; ++blk, b += TL, n0 += TL) {
#pragma unroll
            for (int m = 0; m < TL; ++m) hi[m] = q[b + m];
#pragma unroll
            for (int u = 0; u < TL; ++u) {
                const float2 s = w[n0 + u];
#pragma unroll
                for (int j = 0; j < TL; ++j) {
                    const float r = (u >= j) ? hi[u - j] : lo[TL - 1 + u - j];
                    ar[j] = fmaf(s.x, r, ar[j]);
                    ai[j] = fmaf(s.y, r, ai[j]);
                }
            }
#pragma unroll
            for (int m = 0; m < TL - 1; ++m) lo[m] = hi[m + 1];
        }
    }
    __syncthreads();            // the partial sums reuse the samples buffer

    // ---- 4. sum the slices: red[plane][slice][lag] ----
    const int NGT = NG * TL;
    float* red = cc_smem;
    if (worker) {
#pragma unroll
        for (int j = 0; j < TL; ++j) {
            red[sl * NGT + g * TL + j] = ar[j];
            red[(p.S + sl) * NGT + g * TL + j] = ai[j];
        }
    }
    __syncthreads();
    for (int t = tid; t < 2 * p.LW; t += nthr) {
        const int plane = t / p.LW;
        const int l = t - plane * p.LW;
        const float* col = red + plane * p.S * NGT + l;
        float acc = 0.0f;
        for (int s2 = 0; s2 < p.S; ++s2) acc += col[s2 * NGT];
        float* z = plane == 0 ? zr : zi;
        z[((size_t)c * p.E + e) * p.LW + l] = acc;
    }
}

// One launch of the correlator on `stream` (blocks: E x C).  Returns the
// launch error, if any.
static inline cudaError_t chunk_corr_enqueue(
    const CorrParams& p, const void* x, int n_samp, const void* rows,
    const void* slot, const void* fst, const void* ist, void* zr, void* zi,
    void* s_reg, void* step0, cudaStream_t s) {
    const dim3 grid(p.E, p.C);
    chunk_corr_kernel<CC_TL><<<grid, p.threads, p.smem_bytes, s>>>(
        (const float2*)x, n_samp, (const float*)rows, (const int*)slot,
        (const float*)fst, (const int*)ist, (float*)zr, (float*)zi,
        (int*)s_reg, (float*)step0, p);
    return cudaGetLastError();
}

// The launch attribute for the block's dynamic shared memory (above the
// default 48 KB a launch without it fails).
static inline cudaError_t chunk_corr_prepare(const CorrParams& p) {
    if (p.tl != CC_TL || p.threads < 1 || p.threads > 256)
        return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(chunk_corr_kernel<CC_TL>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                p.smem_bytes);
}
