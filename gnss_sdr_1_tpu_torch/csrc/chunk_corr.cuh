// Fused chunk correlator for NVIDIA Hopper (sm_90a): regular-grid window,
// frozen-NCO carrier wipe-off and lag correlation of one tracking chunk.
//
// Replaces the XLA stages of the JAX package's chunked engine
// (gnss_sdr_1_tpu/track/engine.py `_chunk_windows` (:828) and the two
// `einsum`s of `_pallas_chunk` (:1096-1099)).  Computes what the plain
// version gnss_sdr_1_tpu_torch/ops/chunk_corr.py:correlate_plain computes,
// in the layout the chain kernel reads: z[c, e, l] channel-major.
//
// The JAX package computes the lag correlation as one matrix product per
// channel on the MXU: Z_c[2E, LW] = W_c[2E, NW] . T_c[NW, LW], W the I and
// Q planes of the E wiped windows, T_c[n, l] = row_c[n - l + LW - 1] the
// channel's Toeplitz replica.  This kernel computes the same product on the
// tensor cores (mma.sync.m16n8k8, TF32 in, float32 sums):
// - M is the 2E = 32 plane-epoch rows (two m16 tiles), N the LW lags
//   (66-73 in every receiver) in up to ten n8 tiles, K the samples, eight
//   a k-step; a larger E or LW is walked in blocks of 32 rows by 80 lags;
// - float32 accuracy from TF32 passes: each wiped sample a splits into
//   hi(a) + lo(a) (cvt.rna.tf32.f32, the remainder exact in float32); the
//   receivers' replica tables hold codes (+-1, 0), exact in TF32, so
//   hi(a) b + lo(a) b is the product to ~2^-22 (PASSES = 2); a table that
//   is not exact takes hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b) (PASSES =
//   3), chosen from the data when the engine builds the table
//   (ops/chunk_corr.py table_passes);
// - the B fragments are built on the fly from the row stretch in shared
//   memory, b[k][n] = q[k - n + 79]: the LW x NW bank never exists;
// - 12 channels are too few blocks for the card, so each channel takes a
//   cluster of G CTAs that split the sample range (K): CTA r stages its
//   k-steps of all E windows and the tile's row stretch with cp.async and
//   wipes the samples off in shared memory, tile by tile (the same
//   geometry and frozen-NCO arithmetic as the plain version, so the slice
//   origins, step0 and the mask edges are bit-exact; the tiles sized so
//   that two CTAs share an SM), and its 8 warps take the tile's k-steps
//   four ways and the block's n-tiles two ways (each warp half the block in
//   registers); then the four k-groups' blocks are summed in order through
//   shared memory, each sum stored into the CTA of the cluster that owns
//   its output through distributed shared memory, and after one cluster
//   barrier each CTA sums its outputs rank by rank: deterministic, no
//   atomics.  G
//   is the largest cluster of which every channel's is resident at once
//   (cudaOccupancyMaxActiveClusters, ops/chunk_corr.py fit_cluster).
//
// What bounds it: at the main path's shape (E = 16, C = 12, LW = 68,
// NW = 4136) the product is 2 x 12 x 16 x 68 x ~4092 multiply-adds
// (~214 MFLOP, 3.2 us at the float32 FMA rate of 67 TFLOP/s, 0.9 us per
// TF32 pass at 495) against ~6.6 MB of samples, rows and outputs (2.0 us
// at 3.35 TB/s): at TF32 rates the bytes, and the wipe's sine and cosine
// per sample on the CUDA cores.
//
// Numerics: the tensor cores truncate their sums, so each k-step's passes
// start from zero there and every k-step's block is added to the float32
// sums in registers rounded to nearest: a running sum kept in the tensor
// cores drifts toward zero by ~2^-23 of itself an instruction (at L2C and
// GLONASS the chain's taps moved 2x past their bar over a chunk).  The
// sums run in another order than cuBLAS or the CPU and the TF32 split
// leaves ~2^-22 of each product; the tests hold the lag windows to 1e-4 of
// max|z|.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "cluster_walk.cuh"
#include "rows.cuh"

// geometry (ops/chunk_corr.py THREADS, MAX_CLUSTER, BLOCK_ROWS,
// BLOCK_LAGS, KSTEP)
#define CC_THREADS 256
#define CC_WARPS (CC_THREADS / 32)
#define CC_MAX_CLUSTER 16
#define CC_ROWS 32
#define CC_LAGS 80
#define CC_MT (CC_ROWS / 16)
#define CC_NT (CC_LAGS / 8)
#define CC_KSTEP 8
// the warps as 4 k-groups (k-steps kg, kg + 4, ...) by 2 n-groups (n-tiles
// 5 ng .. 5 ng + 4); the k-groups' blocks meet in shared memory in rows of
// CC_RED_STRIDE floats (= 24 mod 32: the accumulators' float2 stores free
// of bank conflicts)
#define CC_KG 4
#define CC_NG (CC_WARPS / CC_KG)
#define CC_NTW (CC_NT / CC_NG)
#define CC_RED_STRIDE 88

// Mirror of ops/chunk_corr.py CorrParams; the geometry (G .. q_floats,
// smem) is ops/chunk_corr.py corr_geometry's, checked at launch.
struct CorrParams {
    int E, LW, NW, C, QW, t0_int, grid_pad, seg_len;
    int G, NK, SK, TK, tiles, MB, NB, a_stride, a_floats, q_floats, passes,
        smem;
    float t0_frac, neg_t0, chip_rate, fs;
};

// Dynamic shared memory bytes of a geometry (ops/chunk_corr.py _layout):
// the tile's raw samples, its wiped samples, the row stretch, the CTA's
// partial block, the epochs' geometry.
__host__ __device__ inline int cc_smem_bytes(const CorrParams& p) {
    return 4 * (2 * p.E * CC_KSTEP * p.TK + p.a_floats + 2 * p.q_floats
                + CC_ROWS * CC_LAGS + CC_MAX_CLUSTER + 4 * p.E);
}

__device__ __forceinline__ void cp_async4(void* smem_dst,
                                          const void* gmem_src) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async8(void* smem_dst,
                                          const void* gmem_src) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(dst), "l"(gmem_src));
}

// sin and cos of x for |x| < 1e5 without a branch: n = rint(x 2/pi),
// r = x - n pi/2 by three fused multiply-adds with pi/2 in three float
// parts (the reduction of sincosf's own fast path), then the Cephes float
// polynomials on [-pi/4, pi/4]; within 2 ulp of the true values.  Four of
// them overlap in one thread where sincosf's branch to its slow path would
// keep them apart.
__device__ __forceinline__ void sincos_cw(float x, float* s, float* c) {
    const float n = rintf(x * 0.636619772367581343f);
    float r = fmaf(n, -1.5707962512969971e+00f, x);
    r = fmaf(n, -7.5497894158615964e-08f, r);
    r = fmaf(n, -5.3903029534742384e-15f, r);
    const float z = r * r;
    const float ps = fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z,
                          -1.6666654611e-1f);
    const float sr = fmaf(r * z, ps, r);
    const float pc = fmaf(fmaf(2.443315711809948e-5f, z,
                               -1.388731625493765e-3f), z,
                          4.166664568298827e-2f);
    const float cr = fmaf(z * z, pc, fmaf(-0.5f, z, 1.0f));
    const int quad = (int)n & 3;
    *s = quad == 0 ? sr : (quad == 1 ? cr : (quad == 2 ? -sr : -cr));
    *c = quad == 0 ? cr : (quad == 1 ? -sr : (quad == 2 ? -cr : sr));
}

// Wipe off the tile's staged samples (x_s [E][KT]) into the block's rows of
// a_s: item (e, k) of the E x KT, CC_THREADS apart, four a thread at once
// (independent sines and cosines in flight); zero outside each epoch's true
// content.  FAST: every phase below 1e5 rad (sincos_cw), else sincosf.
template <bool FAST>
__device__ __forceinline__ void wipe_tile(const float2* x_s, float* a_s,
                                          const int* ep, int E, int KT,
                                          int a_stride, int kt0, int k_end,
                                          int NW, int row0, float step0,
                                          int tid) {
    constexpr int U = 4;
    const int de = CC_THREADS / KT, dk = CC_THREADS - de * KT;
    int e = tid / KT, k = tid - (tid / KT) * KT;
    while (e < E) {
        int ei[U], ki[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
            ei[i] = e;
            ki[i] = k;
            e += de;
            k += dk;
            if (k >= KT) { k -= KT; ++e; }
        }
        float vr[U], vi[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
            const int ee = min(ei[i], E - 1), kk = ki[i];
            const int n = kt0 + kk, dp = ep[4 * ee + 1];
            const bool in = ei[i] < E && kk < k_end && n >= dp
                            && n < dp + ep[4 * ee + 2] && n < NW;
            const float2 sv = x_s[ee * KT + kk];
            const float ph = __int_as_float(ep[4 * ee + 3])
                             + step0 * (float)n;
            float sn, cs;
            if (FAST) sincos_cw(ph, &sn, &cs);
            else sincosf(ph, &sn, &cs);
            // (re + j im) * (cos - j sin)
            vr[i] = in ? sv.x * cs + sv.y * sn : 0.0f;
            vi[i] = in ? sv.y * cs - sv.x * sn : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
            if (ei[i] >= E) break;
            const int ri = ei[i] - row0, rq = E + ei[i] - row0;
            if (ri >= 0 && ri < CC_ROWS) a_s[ri * a_stride + ki[i]] = vr[i];
            if (rq >= 0 && rq < CC_ROWS) a_s[rq * a_stride + ki[i]] = vi[i];
        }
    }
}

// Stage a tile: the replica row's stretch for lag block nb, q[i] =
// row[kt0 + LW - 80 (nb + 1) + i] (zero off the row), and the tile's
// samples of every epoch below NW, x_s[e][k] = x[off + e t0 + kt0 + k] for
// k < k_end, both by cp.async, committed as one group.  Needs no epoch
// geometry but the window's origin, so the first tile's loads fly while the
// geometry is computed.
__device__ __forceinline__ void stage_tile(const float2* __restrict__ x,
                                           const float* __restrict__ qrow,
                                           float2* x_s, float* q_s,
                                           const CorrParams& p, int off,
                                           int kt0, int k_end, int nb,
                                           int KT, int tid) {
    const int q_base = kt0 + p.LW - CC_LAGS * (nb + 1);
    for (int i = tid; i < p.q_floats; i += CC_THREADS) {
        const int g = q_base + i;
        if (g >= 0 && g < p.QW) cp_async4(q_s + i, qrow + g);
        else q_s[i] = 0.0f;
    }
    const int k_hi = min(k_end, p.NW - kt0);
    for (int u = tid; u < p.E * KT; u += CC_THREADS) {
        const int e = u / KT, k = u - e * KT;
        if (k < k_hi)
            cp_async8(x_s + u, x + off + e * p.t0_int + kt0 + k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// predicted start of epoch k >= 1 of the chunk (plain: s_pred[:, k])
__device__ __forceinline__ int predicted_start(int start, int cur_len,
                                               float rem_code, float c_step,
                                               int t0_int, int k) {
    const float r = rem_code + (float)(k - 1) * c_step;
    return start + cur_len + (k - 1) * t0_int + (int)floorf(r);
}

// mma.sync.m16n8k8 TF32 fragments (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"), lane = 4 g + t (the CPU tests' emulation of the product,
// tests/test_torch_chunk_corr.py frag_a / frag_b / frag_c): A register r of a lane holds (row, col) = (g + 8 (r & 1),
// t + 4 (r >> 1)) of the 16 x 8 tile; B register r holds (k, n) =
// (t + 4 r, g) of the 8 x 8 tile; accumulator r holds (row, col) =
// (g + 8 (r >> 1), 2 t + (r & 1)) of the 16 x 8 tile.
__device__ __forceinline__ int frag_a_row(int lane, int r) {
    return (lane >> 2) + 8 * (r & 1);
}
__device__ __forceinline__ int frag_a_col(int lane, int r) {
    return (lane & 3) + 4 * (r >> 1);
}
__device__ __forceinline__ int frag_b_k(int lane, int r) {
    return (lane & 3) + 4 * r;
}
__device__ __forceinline__ int frag_b_n(int lane) { return lane >> 2; }
__device__ __forceinline__ int frag_c_row(int lane, int r) {
    return (lane >> 2) + 8 * (r >> 1);
}
__device__ __forceinline__ int frag_c_col(int lane, int r) {
    return 2 * (lane & 3) + (r & 1);
}

// x rounded to TF32 (nearest, ties away), as a 32-bit pattern
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// d += a . b on the tensor cores, TF32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

// One CTA of channel c's cluster: the k-steps [rank SK, (rank + 1) SK) of
// every output block, summed over the cluster into z.
template <int PASSES>
__global__ void __launch_bounds__(CC_THREADS)
chunk_corr_kernel(const float2* __restrict__ x, int n_samp,
                  const float* __restrict__ rows,
                  const int* __restrict__ slot,
                  const float* __restrict__ fst, const int* __restrict__ ist,
                  float* __restrict__ zr, float* __restrict__ zi,
                  int* __restrict__ s_reg_out, float* __restrict__ step0_out,
                  const __grid_constant__ CorrParams p) {
    extern __shared__ __align__(16) float cc_smem[];
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int c = blockIdx.x / p.G;
    const int C = p.C, E = p.E;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int KT = CC_KSTEP * p.TK;
    float2* x_s = reinterpret_cast<float2*>(cc_smem);   // [E][KT] raw
    float* a_s = cc_smem + 2 * E * KT;           // [32][a_stride] wiped
    float* q_s = a_s + p.a_floats;               // [2][q_floats] stretches
    float* part = q_s + 2 * p.q_floats;          // [G][range] ranks' sums
    int* ep = reinterpret_cast<int*>(part + CC_ROWS * CC_LAGS
                                     + CC_MAX_CLUSTER);          // [E][4]

    // ---- epoch geometry under the frozen code frequency ----
    const int start = ist[I_START * C + c];
    const int cur_len = ist[I_CURLEN * C + c];
    const float rem_code = fst[F_REM_CODE * C + c];
    const float delta0 = fst[F_DELTA * C + c];
    const int off = min(max(start - p.grid_pad, 0), n_samp - p.seg_len);
    const float* qrow = rows + (size_t)slot[c] * p.QW;
    const int k_lo = rank * p.SK;
    const int k_hi = min(k_lo + p.SK, p.NK);
    // the first tile's loads in flight while the geometry is computed
    if (k_hi > k_lo)
        stage_tile(x, qrow, x_s, q_s, p, off, CC_KSTEP * k_lo,
                   CC_KSTEP * min(p.TK, k_hi - k_lo), 0, KT, tid);
    const float codef0 = p.chip_rate + delta0;
    const float d_t0 = p.neg_t0 * delta0 / codef0;
    const float c_step = p.t0_frac + d_t0;
    const float step0 = TWO_PI_F * (fst[F_DOPPLER * C + c]
                                     + fst[F_CARR_OFF * C + c]) / p.fs;
    if (tid < E) {
        const int e = tid;
        const int s_pred = e == 0 ? start
            : predicted_start(start, cur_len, rem_code, c_step, p.t0_int, e);
        const int s_next = predicted_start(start, cur_len, rem_code, c_step,
                                           p.t0_int, e + 1);
        const int s_reg = off + e * p.t0_int;
        const float phi = mod_floor(fst[F_REM_CARR * C + c]
                                    + step0 * (float)(s_reg - start),
                                    TWO_PI_F);
        ep[4 * e] = s_reg;
        ep[4 * e + 1] = s_pred - s_reg;                      // dp
        ep[4 * e + 2] = s_next - s_pred;                     // len_pred
        ep[4 * e + 3] = __float_as_int(phi);
        if (rank == 0) s_reg_out[c * E + e] = s_reg;
    }
    if (rank == 0 && tid == 0) step0_out[c] = step0;
    // every phase of the chunk, |phi + step0 n| < 2 pi + |step0| NW, within
    // sincos_cw's range
    const bool fast = TWO_PI_F + fabsf(step0) * (float)p.NW < 1e5f;

    for (int mb = 0; mb < p.MB; ++mb) {
        const int rows_live = min(CC_ROWS, 2 * E - CC_ROWS * mb);
        for (int nb = 0; nb < p.NB; ++nb) {
            const int kg = warp % CC_KG, ng = warp / CC_KG;
            float acc[CC_MT][CC_NTW][4];
#pragma unroll
            for (int mt = 0; mt < CC_MT; ++mt)
#pragma unroll
                for (int j = 0; j < CC_NTW; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.0f;

            for (int t = 0; t < p.tiles; ++t) {
                const int ks0 = k_lo + t * p.TK;
                const int nks = min(p.TK, k_hi - ks0);
                const int kt0 = CC_KSTEP * ks0;
                float* qt = q_s + (t & 1) * p.q_floats;
                if (t == 0 && (mb > 0 || nb > 0)) {
                    // the last block's reads of x_s and q_s done: stage
                    // this block's first tile
                    __syncthreads();
                    if (nks > 0)
                        stage_tile(x, qrow, x_s, qt, p, off, kt0,
                                   CC_KSTEP * nks, nb, KT, tid);
                }
                // ---- 1-2. the tile's replica stretch and samples in (the
                //      first tile's staged before the geometry, each later
                //      one during the product of the one before); the
                //      samples wiped off in shared memory, zero outside each
                //      epoch's true content ----
                asm volatile("cp.async.wait_all;\n" ::);
                __syncthreads();
                if (nks > 0) {
                    if (fast)
                        wipe_tile<true>(x_s, a_s, ep, E, KT, p.a_stride, kt0,
                                        CC_KSTEP * nks, p.NW, CC_ROWS * mb,
                                        step0, tid);
                    else
                        wipe_tile<false>(x_s, a_s, ep, E, KT, p.a_stride,
                                         kt0, CC_KSTEP * nks, p.NW,
                                         CC_ROWS * mb, step0, tid);
                    // the block's rows past 2E stay zero
                    for (int u = rows_live * KT + tid; u < CC_ROWS * KT;
                         u += CC_THREADS) {
                        const int r = u / KT;
                        a_s[r * p.a_stride + (u - r * KT)] = 0.0f;
                    }
                }
                __syncthreads();
                // the next tile's loads fly during this tile's product
                // (x_s is read; its stretch goes to the other q buffer)
                if (t + 1 < p.tiles) {
                    const int nks1 = min(p.TK, k_hi - ks0 - p.TK);
                    if (nks1 > 0)
                        stage_tile(x, qrow, x_s,
                                   q_s + ((t + 1) & 1) * p.q_floats, p, off,
                                   kt0 + KT, CC_KSTEP * nks1, nb, KT, tid);
                }
                // ---- 3. the product: k-group kg takes k-steps kg, kg + 4,
                //      ...; n-group ng the n-tiles 5 ng .. 5 ng + 4.  No
                //      tile is skipped (the block's rows past 2E are zero,
                //      its lags past LW never stored), so the ten
                //      independent mma chains of a k-step interleave ----
                for (int ks = kg; ks < nks; ks += CC_KG) {
                    const int kk = CC_KSTEP * ks;
                    uint32_t ah[CC_MT][4], al[CC_MT][4];
#pragma unroll
                    for (int mt = 0; mt < CC_MT; ++mt) {
#pragma unroll
                        for (int r = 0; r < 4; ++r) {
                            const float v =
                                a_s[(16 * mt + frag_a_row(lane, r))
                                        * p.a_stride
                                    + kk + frag_a_col(lane, r)];
                            ah[mt][r] = tf32_rna(v);
                            al[mt][r] = tf32_rna(v - __uint_as_float(
                                                         ah[mt][r]));
                        }
                    }
#pragma unroll
                    for (int j = 0; j < CC_NTW; ++j) {
                        const int nt = CC_NTW * ng + j;
                        uint32_t bh[2], bl[2];
#pragma unroll
                        for (int r = 0; r < 2; ++r) {
                            const float b = qt[kk + frag_b_k(lane, r)
                                                - (CC_KSTEP * nt
                                                   + frag_b_n(lane))
                                                + CC_LAGS - 1];
                            if (PASSES == 3) {
                                bh[r] = tf32_rna(b);
                                bl[r] = tf32_rna(b - __uint_as_float(bh[r]));
                            } else {
                                bh[r] = __float_as_uint(b);  // exact in TF32
                            }
                        }
#pragma unroll
                        for (int mt = 0; mt < CC_MT; ++mt) {
                            // this k-step's passes from zero on the tensor
                            // cores, then into the float32 sums
                            float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                            mma_tf32(d, al[mt], bh);
                            mma_tf32(d, ah[mt], bh);
                            if (PASSES == 3) mma_tf32(d, ah[mt], bl);
#pragma unroll
                            for (int r = 0; r < 4; ++r)
                                acc[mt][j][r] = __fadd_rn(acc[mt][j][r],
                                                          d[r]);
                        }
                    }
                }
            }
            __syncthreads();        // the tiles' reads of a_s done
            // ---- 4. the k-groups' blocks through shared memory (over
            //      a_s), summed in k-group order into this CTA's block ----
            float* red = a_s + kg * CC_ROWS * CC_RED_STRIDE;
#pragma unroll
            for (int mt = 0; mt < CC_MT; ++mt)
#pragma unroll
                for (int j = 0; j < CC_NTW; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        *reinterpret_cast<float2*>(
                            red + (16 * mt + frag_c_row(lane, 2 * h))
                                      * CC_RED_STRIDE
                            + CC_KSTEP * (CC_NTW * ng + j)
                            + frag_c_col(lane, 2 * h)) =
                            make_float2(acc[mt][j][2 * h],
                                        acc[mt][j][2 * h + 1]);
            __syncthreads();
            // ---- 5. each output's sum over the k-groups, stored into the
            //      CTA that owns it (outputs [q range, (q + 1) range) on
            //      rank q), in that CTA's row for this rank; one cluster
            //      barrier; then each CTA sums its outputs' rows in rank
            //      order: deterministic, no atomics, no remote load ----
            const int range = (CC_ROWS * CC_LAGS + p.G - 1) / p.G;
            for (int o = tid; o < CC_ROWS * CC_LAGS; o += CC_THREADS) {
                const int r = o / CC_LAGS, l = o - r * CC_LAGS;
                float v = 0.0f;
#pragma unroll
                for (int g = 0; g < CC_KG; ++g)
                    v += a_s[(g * CC_ROWS + r) * CC_RED_STRIDE + l];
                const int q = o / range;
                *cluster.map_shared_rank(part + rank * range + (o - q * range),
                                         q) = v;
            }
            cluster.sync();
            for (int i = tid; i < range; i += CC_THREADS) {
                const int o = rank * range + i;
                const int r = o / CC_LAGS, l = o - r * CC_LAGS;
                const int row = CC_ROWS * mb + r, lag = CC_LAGS * nb + l;
                if (o >= CC_ROWS * CC_LAGS || row >= 2 * E || lag >= p.LW)
                    continue;
                float v = 0.0f;
                for (int q = 0; q < p.G; ++q) v += part[q * range + i];
                float* z = row < E ? zr : zi;
                const int e = row < E ? row : row - E;
                z[((size_t)c * E + e) * p.LW + lag] = v;
            }
            // the next block's stores wait until every rank has read these
            if (mb < p.MB - 1 || nb < p.NB - 1) cluster.sync();
        }
    }
}

typedef void (*CorrKernel)(const float2*, int, const float*, const int*,
                           const float*, const int*, float*, float*, int*,
                           float*, const CorrParams);

static inline CorrKernel corr_kernel_for(int passes) {
    return passes == 2 ? chunk_corr_kernel<2> : chunk_corr_kernel<3>;
}

// One launch of the correlator on `stream`: C clusters of G CTAs.  Returns
// the launch error, if any.
static inline cudaError_t chunk_corr_enqueue(
    const CorrParams& p, const void* x, int n_samp, const void* rows,
    const void* slot, const void* fst, const void* ist, void* zr, void* zi,
    void* s_reg, void* step0, cudaStream_t s) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(p.G, CC_THREADS, p.smem, &attr,
                                            s);
    cfg.gridDim = dim3(p.C * p.G, 1, 1);
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, corr_kernel_for(p.passes), (const float2*)x, n_samp,
        (const float*)rows, (const int*)slot, (const float*)fst,
        (const int*)ist, (float*)zr, (float*)zi, (int*)s_reg, (float*)step0,
        p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// The geometry checked against the kernel's layout, and the launch
// attributes for its dynamic shared memory and cluster size.
static inline cudaError_t chunk_corr_prepare(const CorrParams& p) {
    if (p.passes < 2 || p.passes > 3 || p.G < 1 || p.G > CC_MAX_CLUSTER
        || p.C < 1 || p.NK != (p.NW + CC_KSTEP - 1) / CC_KSTEP
        || p.SK * p.G < p.NK || p.TK * p.tiles < p.SK
        || p.MB * CC_ROWS < 2 * p.E || p.NB * CC_LAGS < p.LW
        || p.a_stride < CC_KSTEP * p.TK
        || p.a_floats < CC_ROWS * p.a_stride
        || p.a_floats < CC_KG * CC_ROWS * CC_RED_STRIDE
        || p.q_floats < CC_KSTEP * p.TK + CC_LAGS - 1
        || p.E > CC_THREADS || p.smem != cc_smem_bytes(p)
        || p.smem > CLUSTER_SMEM_MAX)
        return cudaErrorInvalidValue;
    return cluster_set_attributes(
        reinterpret_cast<const void*>(corr_kernel_for(p.passes)), p.smem,
        p.G);
}
