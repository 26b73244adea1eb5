// The symbol-grid reduction of a capture segment's per-epoch rows for
// NVIDIA Hopper (sm_90a): every channel's slot sums and picks in one
// launch, written into one packed buffer.
//
// Computes exactly what the plain torch version
// gnss_sdr_1_tpu_torch/ops/symbol_slots.py:symbol_slots_plain computes
// (the rows are ops/track_chain.py's O_* of out_f [cap, N_OROWS, C], out_i
// [cap, 2, C] and out_corr [cap, 2K, C], rows.cuh): each channel's epochs
// rolled so that its symbol boundary b0 opens slot 1, slot 0 the partial
// head [0, b0), slot s >= 1 the epochs [b0 + (s-1)N, b0 + sN); per slot
// the sums of the valid prompt I, prompt Q and the valid flag, and the
// loop-state rows entering it.  It takes the place of the ~60 small torch
// ops the engine enqueued after the walk (TrackingEngine._symbol_outputs),
// which came after a stream sync; the JAX package reduces in XLA.
//
// What bounds it: a GPS segment is 1,008 epochs of 8 channels, ~110 KB of
// rows read once and ~15 KB written, 0.04 us at the H100's 3.35 TB/s; a
// launch takes ~7.4 us there, the latency of each thread's N dependent
// adds over loads from L2, where the walk just left the rows.  It runs
// once a segment, behind ~2.5 ms of walk.  Design:
// - one CTA per channel, a thread per slot (S = cap / N + 2; 52 at GPS
//   with N = 20, 254 at E1B with N = 1; a thread takes slots s, s +
//   SYM_THREADS, ... where S exceeds the CTA);
// - the thread walks its slot's N rolled rows in order and starts its
//   sums from the first row's value (+0.0f where that row is padding), as
//   the plain version's row-by-row adds do, so every bit and every zero's
//   sign is the plain version's: the product corr * v is its own multiply
//   (__fmul_rn; the library is built with --fmad=false besides), round is
//   rintf (half to even, as torch.round), the mean's scale is the float32
//   that torch rounds 1.0 / N to (SymParams.scale);
// - the picks at e_s = clamp(b0 - N + sN, 0, cap - 1) (the start) and
//   e_s - 1 (the pre-floor code fraction, rem_carr, Doppler, C/N0 and the
//   code-frequency delta), the fraction from the epoch's rem_code and the
//   one before it (the channel's entering rem_code at epoch 0);
// - n_valid the exact integer count of valid epochs (the slots' counts
//   summed in shared memory: the valid flags are 0 or 1, so it is the
//   plain version's float sum), `active` the flag at its last valid epoch;
// - the per-channel symbol offsets by value in the __grid_constant__
//   parameter block (up to SYM_MAX_C = 1000 channels, which fills a
//   launch's 4 KB of parameters), so nothing is uploaded and
//   the launch never synchronises: it queues behind the walk on the same
//   stream.
// The packed buffer: int32 words, field f of SYM_FIELDS at f S C (each
// [S, C], the floats' bits), then n_valid [C] and active [C] (0 or 1).
// Built into both walks' libraries (track_chain.cu and gather_block.cu
// include it, each with its own C entry): nvcc -O3 --fmad=false, without
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "rows.cuh"

#define SYM_THREADS 128
#define SYM_MAX_C 1000
#define SYM_MAX_K 5
// the [S, C] fields of the packed buffer, in SymbolOutputs' order
// (ops/symbol_slots.py FIELDS)
enum {
    SYM_START = 0, SYM_MEAN_I, SYM_MEAN_Q, SYM_FRAC, SYM_REM_CARR,
    SYM_DOPPLER, SYM_CN0, SYM_DELTA, SYM_VCOUNT, SYM_FIELDS
};

// Mirror of ops/symbol_slots.py SymParams.
struct SymParams {
    int cap, C, S, N, K, prompt;
    float scale;
    int off[SYM_MAX_C];
};
static_assert(offsetof(SymParams, scale) == 24, "SymParams layout");
static_assert(offsetof(SymParams, off) == 28, "SymParams layout");
static_assert(sizeof(SymParams) == 4028, "SymParams layout");
// the block and the kernel's five pointers within a launch's 4 KB of
// parameters
static_assert(sizeof(SymParams) + 5 * sizeof(void*) <= 4096,
              "SymParams size");

__global__ void __launch_bounds__(SYM_THREADS)
symbol_slots_kernel(const float* __restrict__ out_f,
                    const int* __restrict__ out_i,
                    const float* __restrict__ out_corr,
                    const float* __restrict__ entering_rem,
                    int* __restrict__ out, const __grid_constant__ SymParams p) {
    __shared__ int n_valid;
    const int c = blockIdx.x;
    const int C = p.C, N = p.N, S = p.S, cap = p.cap;
    const long long P = (long long)S * N;
    const long long b0 = p.off[c];
    const size_t SC = (size_t)S * C;
    const size_t f_row = (size_t)N_OROWS * C;   // an epoch of out_f
    const size_t c_row = (size_t)2 * p.K * C;   // an epoch of out_corr
    const float* v = out_f + (size_t)O_VALID * C + c;
    const float* pi = out_corr + (size_t)p.prompt * C + c;
    const float* pq = out_corr + (size_t)(p.K + p.prompt) * C + c;
    const float* rem = out_f + (size_t)O_REM_CODE * C + c;
    float* outf = reinterpret_cast<float*>(out);
    if (threadIdx.x == 0) n_valid = 0;
    __syncthreads();
    int count = 0;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        float si = 0.0f, sq = 0.0f, sv = 0.0f;
        // rolled row sN + k holds epoch (sN + k - (N - b0)) mod P; rows at
        // or past cap are the +0.0f padding
        long long e = ((long long)s * N - (N - b0)) % P;
        if (e < 0) e += P;
#pragma unroll 4
        for (int k = 0; k < N; ++k, e = e + 1 == P ? 0 : e + 1) {
            float xi = 0.0f, xq = 0.0f, xv = 0.0f;
            if (e < cap) {
                xv = v[e * f_row];
                xi = __fmul_rn(pi[e * c_row], xv);
                xq = __fmul_rn(pq[e * c_row], xv);
            }
            if (k == 0) {
                si = xi;
                sq = xq;
                sv = xv;
            } else {
                si = __fadd_rn(si, xi);
                sq = __fadd_rn(sq, xq);
                sv = __fadd_rn(sv, xv);
            }
        }
        const long long es = min(max(b0 - N + (long long)s * N, 0LL),
                                 (long long)cap - 1);
        const long long em1 = max(es - 1, 0LL);
        const float r = rem[em1 * f_row];
        const float prev = em1 == 0 ? entering_rem[c] : rem[(em1 - 1) * f_row];
        const int vc = __float2int_rz(sv);
        const size_t o = (size_t)s * C + c;
        out[SYM_START * SC + o] = out_i[es * 2 * C + c];
        outf[SYM_MEAN_I * SC + o] = __fmul_rn(si, p.scale);
        outf[SYM_MEAN_Q * SC + o] = __fmul_rn(sq, p.scale);
        outf[SYM_FRAC * SC + o] = __fsub_rn(r, rintf(__fsub_rn(r, prev)));
        outf[SYM_REM_CARR * SC + o] = out_f[em1 * f_row + O_REM_CARR * C + c];
        outf[SYM_DOPPLER * SC + o] = out_f[em1 * f_row + O_DOPPLER * C + c];
        outf[SYM_CN0 * SC + o] = out_f[em1 * f_row + O_CN0 * C + c];
        outf[SYM_DELTA * SC + o] = out_f[em1 * f_row + O_DELTA * C + c];
        out[SYM_VCOUNT * SC + o] = vc;
        count += vc;
    }
    atomicAdd(&n_valid, count);
    __syncthreads();
    if (threadIdx.x == 0) {
        const int last = min(max(n_valid - 1, 0), cap - 1);
        out[SYM_FIELDS * SC + c] = n_valid;
        out[SYM_FIELDS * SC + C + c] =
            out_f[(size_t)last * f_row + O_ACTIVE * C + c] > 0.5f;
    }
}

// One launch on `stream`: checks the block, never synchronises and
// allocates nothing; returns the CUDA error.
static int symbol_slots_enqueue(const void* out_f, const void* out_i,
                                const void* out_corr,
                                const void* entering_rem, void* out,
                                const SymParams* params, void* stream) {
    const SymParams& p = *params;
    if (p.C < 1 || p.C > SYM_MAX_C || p.N < 1 || p.cap < 1
        || p.S != p.cap / p.N + 2 || (long long)p.S * p.N > 0x7fffffff
        || p.K < 1 || p.K > SYM_MAX_K || p.prompt < 0 || p.prompt >= p.K)
        return (int)cudaErrorInvalidValue;
    symbol_slots_kernel<<<p.C, SYM_THREADS, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float*>(out_f),
        reinterpret_cast<const int*>(out_i),
        reinterpret_cast<const float*>(out_corr),
        reinterpret_cast<const float*>(entering_rem),
        reinterpret_cast<int*>(out), p);
    return (int)cudaGetLastError();
}
