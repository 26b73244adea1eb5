// Gather multicorrelator for one channel's epoch, spread over the threads
// of a thread block: carrier wipe-off and the K-tap floor code resampler
// of gnss_sdr_1_tpu_torch/ops/multicorrelator.py, rounded as its plain
// torch version rounds on the CPU.  Used by the KF walk (kf_block.cu, three
// taps), the gather DLL/PLL walk (gather_block.cu, three or five) and the
// one-epoch multicorrelator (multicorrelate.cuh).
//
// For n < n_valid (one epoch, starting at x[0]):
//   phase   = fma(cs, n, cp)                 ORDER 3: fma((0.5 cr) n, n, .)
//   w       = x[n] * (cos(phase) - j sin(phase))   (two products, one add)
//   idx_k   = floor(fma(step, n, shift_k) - rem) mod L
//   acc_k  += code[idx_k] * w                (code +-1, kept as bits)
// The multiply-adds of the phase and the code index round once, as
// torch.addcmul does on the CPU; everything else rounds op by op
// (build with --fmad=false).  Each thread sums its samples in order and the
// block reduces by warp shuffles; the sums differ from the plain version's
// BLAS order in the last bits only.
//
// The code table of a channel is its +-1 chips packed 32 to a word (bit set
// = +1), so a 10,230-chip L2CM table takes 1.3 KB of shared memory.

#pragma once

#include <cstdint>

// sin and cos of x for any |x| < 2^30: n = rint(x 2/pi), r = x - n pi/2
// with pi/2 as the double nearest to it plus its tail, each by one fused
// multiply-add in double (the first is exact: x is a float, and n times
// the head leaves no bit below 2^-52 that the difference needs), then the
// Cephes float polynomials on [-pi/4, pi/4]; <= 1.5 ulp from the true
// values.  The KF's phase state is never wrapped (it grows by 2 pi f_D T an
// epoch), so the arguments reach 1e6 rad where sincosf takes its slow,
// local-memory path.
__device__ __forceinline__ void sincos_wide(float x, float* s, float* c) {
    const double xd = (double)x;
    const double n = rint(xd * 0.63661977236758134308);
    double r = fma(-n, 1.5707963267948966, xd);
    r = fma(-n, 6.123233995736766e-17, r);
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

// Pack a +-1 float code row into words, one warp per word: bit i of word w
// is set where row[32 w + i] > 0.  Every warp of the block takes words
// j = warp, warp + n_warps, ... of the `n_words` words.
__device__ __forceinline__ void pack_code_bits(const float* __restrict__ row,
                                               int len, uint32_t* bits,
                                               int n_words, int warp,
                                               int n_warps, int lane) {
    for (int w = warp; w < n_words; w += n_warps) {
        const int n = w * 32 + lane;
        const float v = n < len ? row[n] : -1.0f;
        const uint32_t word = __ballot_sync(0xffffffffu, v > 0.0f);
        if (lane == 0) bits[w] = word;
    }
}

// One thread's share of a channel's K taps: samples n = t, t + T, ...
// below n_valid, tap k at code-row offset sh[k].  acc = {I_0 .. I_{K-1},
// Q_0 .. Q_{K-1}}.
template <int K, int ORDER>
__device__ __forceinline__ void gather_corr_taps(
    const float2* __restrict__ x, int n_valid, const uint32_t* bits, int len,
    float step, float rem, const float sh[K], float cp, float cs, float hr,
    int t, int T, float acc[2 * K]) {
#pragma unroll
    for (int k = 0; k < 2 * K; ++k) acc[k] = 0.0f;
    for (int n = t; n < n_valid; n += T) {
        const float nf = (float)n;
        float ph = fmaf(cs, nf, cp);
        if (ORDER == 3) ph = fmaf(__fmul_rn(hr, nf), nf, ph);
        float sn, cn;
        sincos_wide(ph, &sn, &cn);
        const float2 v = x[n];
        const float wr = __fadd_rn(__fmul_rn(v.x, cn), __fmul_rn(v.y, sn));
        const float wi = __fsub_rn(__fmul_rn(v.y, cn), __fmul_rn(v.x, sn));
#pragma unroll
        for (int k = 0; k < K; ++k) {
            // floor, then mod L with L's sign; the index stays within a
            // code period or two of [0, L), so the wrap loops run once
            // at most in practice, and one unsigned compare keeps the
            // usual in-range index off them
            int idx = (int)floorf(__fsub_rn(fmaf(step, nf, sh[k]), rem));
            if ((unsigned)idx >= (unsigned)len) {
                while (idx >= len) idx -= len;
                while (idx < 0) idx += len;
            }
            const bool plus = (bits[idx >> 5] >> (idx & 31)) & 1u;
            acc[k] = __fadd_rn(acc[k], plus ? wr : -wr);
            acc[K + k] = __fadd_rn(acc[K + k], plus ? wi : -wi);
        }
    }
}

// Sum N partials over a warp (lane 0 holds the result).
template <int N>
__device__ __forceinline__ void warp_sum(float acc[N]) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
        float v = acc[k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
        acc[k] = v;
    }
}
