// A stream segment's front end for NVIDIA Hopper (sm_90a): the raw items
// decoded, filtered by the frequency-translating FIR, decimated, rotated
// back by the mixer's phase and scaled, in one launch.
//
// Computes exactly what the plain torch version
// gnss_sdr_1_tpu_torch/ops/xlate_fir.py:xlate_fir_plain computes.  The
// conf's SignalConditioner (Freq_Xlating_Fir_Filter with an IF and an
// integer decimation D, or a Direct_Resampler with an integer ratio) in
// GNU Radio's freq_xlating_fir_filter form:
//
//   y[m] = scale * e^{j w D m} * sum_{k<T} g[k] x[m D - k],
//   g[k] = h[k] e^{-j w k},  w = -2 pi IF / fs,
//
// the taps g rotated to the IF on the host (float64, then float32), only
// the kept outputs computed, each rotated once by the mixer's phase at its
// own absolute source sample.  That phase is exact: the host hands the
// phase of the segment's first output as a 64-bit fixed-point fraction of
// a turn (phase0 = m0 F mod 2^64, F = round(frac(-IF D / fs) 2^64)), and
// output m's is phase0 + m F mod 2^64 in unsigned 64-bit arithmetic, the
// same bits whatever the segment it falls in.  Its top 32 bits, a signed
// fraction of a half turn, go to a float64 sincospi, rounded to float32
// once.  No TPU kernel stands behind it: the JAX package conditions a
// whole capture with an overlap-save FFT in XLA (condition/filters.py),
// as the port's batch Conditioner still does.
//
// Input: a logical stream of H history samples (`hist`, the items of the
// previous segment's last H source samples; null at the stream's start,
// read as zeros) and the segment's n_seg source samples (`seg`), in one of
// the raw formats: nsr (real 2-bit, four a byte, the least significant
// pair first, two's complement), interleaved int16 or int8 I/Q, or
// complex64.  Output m reads logical samples H + m D - k, k < T; H >= T-1.
//
// What bounds it: the NSR cell's segment is 2,562,562 outputs of 65 taps
// from 20.5 M real 2-bit samples: ~1.1 GFLOP by the count of
// benchmark/gnssbench/roofline_front_end.py, 16 us at the float32 rate,
// and 25.6 MB (5.1 MB in, 20.5 MB out), 7.6 us at 3.35 TB/s.  With the
// multiply and the add rounded apart (--fmad=false, as the plain version
// rounds them) a tap costs two float32 instructions per accumulator, and
// each reads a sample and a tap from shared memory.  Design:
// - a CTA of XF_THREADS threads takes XF_THREADS J consecutive outputs and
//   decodes the (O-1) D + H + 1 samples they read into shared memory once,
//   a thread a column of D consecutive samples at a time, in polyphase
//   order (row p of D holds samples p, p + D, ...), so that for a tap the
//   warp's 32 outputs read 32 consecutive words: no bank conflict,
//   whatever D;
// - each thread keeps J outputs (strided by the CTA) in registers and walks
//   the taps once for all of them: a tap is read once for J outputs (a
//   broadcast), and the sums run k = 0 .. T-1, the plain version's order;
// - J is the largest of 4, 2, 1 whose tile fits 48 KB of shared memory,
//   else J = 1 above it (the attribute raised once);
// - no atomics, no second pass: every output is written once, coalesced.
// nvcc -O3 --fmad=false, without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

#define XF_THREADS 256
#define XF_MAX_TAPS 1024
#define XF_SMEM_DEFAULT (48 * 1024)
#define XF_SMEM_MAX (227 * 1024)

// raw formats of the input (ops/xlate_fir.py FORMAT_CODES)
#define XF_NSR 0
#define XF_I16 1
#define XF_I8 2
#define XF_F32 3

// the launch's parameters (ops/xlate_fir.py XlateParams mirrors them)
struct XlateParams {
    long long n_out;               // outputs to write
    long long n_seg;               // source samples in `seg`
    unsigned long long phase0;     // the first output's phase, turns 2^-64
    unsigned long long dphase;     // an output's phase step, turns 2^-64
    int fmt;                       // XF_*
    int D;                         // decimation
    int T;                         // taps
    int H;                         // history samples before the segment
    float scale;                   // the ingest scale
    int pad;
};
static_assert(sizeof(XlateParams) == 56, "XlateParams layout");

__device__ __forceinline__ float two_bit(unsigned v) {
    // two's complement 2-bit field: 0, 1, -2, -1
    return (float)((int)v - ((v & 2u) ? 4 : 0));
}

// logical sample i: history below H, the segment above, zero past its end
template <int FMT>
__device__ __forceinline__ void load_sample(const void* hist, const void* seg,
                                            long long i, int H,
                                            long long n_seg, float& re,
                                            float& im) {
    const void* src = seg;
    long long s = i - H;
    if (i < H) {
        src = hist;
        s = i;
    }
    re = 0.0f;
    im = 0.0f;
    if (src == nullptr || s >= n_seg) return;
    if constexpr (FMT == XF_NSR) {
        const unsigned char b = static_cast<const unsigned char*>(src)[s >> 2];
        re = two_bit((b >> (2 * (s & 3))) & 3u);
    } else if constexpr (FMT == XF_I16) {
        const short2 v = static_cast<const short2*>(src)[s];
        re = (float)v.x;
        im = (float)v.y;
    } else if constexpr (FMT == XF_I8) {
        const char2 v = static_cast<const char2*>(src)[s];
        re = (float)v.x;
        im = (float)v.y;
    } else {
        const float2 v = static_cast<const float2*>(src)[s];
        re = v.x;
        im = v.y;
    }
}

template <int FMT, int J>
__global__ void __launch_bounds__(XF_THREADS)
    xlate_fir_kernel(const void* hist, const void* seg,
                     const float2* __restrict__ taps, float2* __restrict__ out,
                     const __grid_constant__ XlateParams p) {
    constexpr bool CPLX = FMT != XF_NSR;
    constexpr int O = XF_THREADS * J;
    extern __shared__ float smem[];
    const int D = p.D, T = p.T, H = p.H;
    const int S = (O - 1) * D + H + 1;       // samples the tile reads
    const int L = (S + D - 1) / D;           // a polyphase row (L D >= S)
    float2* g = reinterpret_cast<float2*>(smem);
    float* xr = smem + 2 * T;
    float* xi = xr + D * L;                  // complex inputs only
    const long long m_base = (long long)blockIdx.x * O;
    const long long i0 = m_base * D;         // the tile's first sample

    for (int k = threadIdx.x; k < T; k += XF_THREADS) g[k] = taps[k];
    // a thread decodes whole columns: the D consecutive samples of column
    // q go to rows 0 .. D-1 (no division; the warp's stores to a row are
    // consecutive words)
    for (int q = threadIdx.x; q < L; q += XF_THREADS) {
        const long long s0 = i0 + (long long)q * D;
        for (int ph = 0; ph < D; ++ph) {
            float re, im;
            load_sample<FMT>(hist, seg, s0 + ph, H, p.n_seg, re, im);
            xr[ph * L + q] = re;
            if constexpr (CPLX) xi[ph * L + q] = im;
        }
    }
    __syncthreads();

    float ar[J], ai[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
        ar[j] = 0.0f;
        ai[j] = 0.0f;
    }
    // tap k reads sample H - k of each output's window: row (H - k) mod D,
    // column m + (H - k) div D
    int rp = H % D, rq = H / D;
    for (int k = 0; k < T; ++k) {
        const float2 gk = g[k];
        const float* pr = xr + rp * L + rq + threadIdx.x;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            if constexpr (CPLX) {
                const float x_r = pr[j * XF_THREADS];
                const float x_i = pr[j * XF_THREADS + (xi - xr)];
                ar[j] = ar[j] + (gk.x * x_r - gk.y * x_i);
                ai[j] = ai[j] + (gk.x * x_i + gk.y * x_r);
            } else {
                const float x = pr[j * XF_THREADS];
                ar[j] = ar[j] + gk.x * x;
                ai[j] = ai[j] + gk.y * x;
            }
        }
        if (--rp < 0) {
            rp = D - 1;
            --rq;
        }
    }

#pragma unroll
    for (int j = 0; j < J; ++j) {
        const long long m = m_base + threadIdx.x + j * XF_THREADS;
        if (m >= p.n_out) break;
        const unsigned long long ph =
            p.phase0 + (unsigned long long)m * p.dphase;
        const int half_turns = (int)(unsigned)(ph >> 32);
        double s, c;
        sincospi((double)half_turns * 0x1p-31, &s, &c);
        const float cf = (float)c, sf = (float)s;
        float2 o;
        o.x = (ar[j] * cf - ai[j] * sf) * p.scale;
        o.y = (ar[j] * sf + ai[j] * cf) * p.scale;
        out[m] = o;
    }
}

static size_t tile_smem(int fmt, int D, int T, int H, int J) {
    const long long S = (long long)(XF_THREADS * J - 1) * D + H + 1;
    const long long L = (S + D - 1) / D;
    const int planes = fmt == XF_NSR ? 1 : 2;
    return (size_t)(2 * T + planes * D * L) * sizeof(float);
}

template <int FMT, int J>
static int launch_fmt(const void* hist, const void* seg, const void* taps,
                      void* out, const XlateParams& p, size_t smem,
                      cudaStream_t st) {
    auto kernel = xlate_fir_kernel<FMT, J>;
    if (smem > XF_SMEM_DEFAULT) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long O = (long long)XF_THREADS * J;
    const long long grid = (p.n_out + O - 1) / O;
    kernel<<<(unsigned)grid, XF_THREADS, smem, st>>>(
        hist, seg, static_cast<const float2*>(taps),
        static_cast<float2*>(out), p);
    return (int)cudaGetLastError();
}

template <int FMT>
static int launch_j(const void* hist, const void* seg, const void* taps,
                    void* out, const XlateParams& p, cudaStream_t st) {
    for (int J = 4; J >= 1; J /= 2) {
        const size_t smem = tile_smem(FMT, p.D, p.T, p.H, J);
        if (smem <= XF_SMEM_DEFAULT || (J == 1 && smem <= XF_SMEM_MAX)) {
            if (J == 4) return launch_fmt<FMT, 4>(hist, seg, taps, out, p,
                                                  smem, st);
            if (J == 2) return launch_fmt<FMT, 2>(hist, seg, taps, out, p,
                                                  smem, st);
            return launch_fmt<FMT, 1>(hist, seg, taps, out, p, smem, st);
        }
    }
    return (int)cudaErrorInvalidValue;
}

// Enqueues the front end of one segment on `stream`; returns the first
// CUDA error, 0 on success.  Geometry the wrapper checks: 1 <= T <=
// XF_MAX_TAPS, D >= 1, H >= T - 1, n_out >= 1, and (n_out - 1) D + H + 1
// <= H + n_seg.
extern "C" int xlate_fir_launch(const void* hist, const void* seg,
                                const void* taps, void* out,
                                const XlateParams* params, void* stream) {
    const XlateParams& p = *params;
    if (p.T < 1 || p.T > XF_MAX_TAPS || p.D < 1 || p.H < p.T - 1 ||
        p.n_out < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (p.fmt) {
        case XF_NSR:
            return launch_j<XF_NSR>(hist, seg, taps, out, p, st);
        case XF_I16:
            return launch_j<XF_I16>(hist, seg, taps, out, p, st);
        case XF_I8:
            return launch_j<XF_I8>(hist, seg, taps, out, p, st);
        case XF_F32:
            return launch_j<XF_F32>(hist, seg, taps, out, p, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
