// One epoch of the gather multicorrelator for NVIDIA Hopper (sm_90a): C
// channels, one thread block each, K taps.
//
// Computes what gnss_sdr_1_tpu_torch/ops/multicorrelator.py:multicorrelate
// computes for one segment per channel: the carrier wiped with cp + cs n
// (+ (0.5 cr n) n at ORDER 3), the floor code resampler
// floor(step n + shift_k - rem) mod L, and the K dot products over the
// first n_valid samples.  It takes the place of the JAX package's XLA
// `multicorrelate` (gnss_sdr_1_tpu/ops/multicorrelator.py:33, not a Pallas
// kernel) where the TCP connector (track/tcp_connector.py) calls it once
// per epoch.
//
// What bounds it: each sample is read once (8 bytes) and costs a sine, a
// cosine and K table reads; a 1 ms GPS epoch of one channel is ~4,000
// samples, microseconds of work, so a call is launch-bound.  Design: the
// code row as bits in shared memory (gather_corr.cuh pack_code_bits), each
// thread sums its strided samples in order (gather_corr_taps), warp sums by
// shuffles, then warp 0 sums the warps.  Built into the gather walk's
// library (gather_block.cu includes it): nvcc -O3 --fmad=false, without
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "gather_corr.cuh"

#define MC_THREADS 256
#define MC_WARPS (MC_THREADS / 32)
#define MC_MAX_K 5

// Mirror of ops/multicorrelator.py McParams.
struct McParams {
    int C, K, N, L, order;
    float shifts[MC_MAX_K];
};

template <int K, int ORDER>
__global__ void __launch_bounds__(MC_THREADS)
multicorrelate_kernel(const float2* __restrict__ x,
                      const float* __restrict__ codes,
                      const float* __restrict__ step,
                      const float* __restrict__ rem,
                      const float* __restrict__ cp,
                      const float* __restrict__ cs,
                      const float* __restrict__ cr,
                      const int* __restrict__ n_valid,
                      float2* __restrict__ out,
                      const __grid_constant__ McParams p) {
    extern __shared__ __align__(16) unsigned char mc_smem[];
    float* part = reinterpret_cast<float*>(mc_smem);       // [warps][2K]
    uint32_t* bits = reinterpret_cast<uint32_t*>(part + MC_WARPS * 2 * K);
    const int c = blockIdx.x;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int W = (p.L + 31) / 32;
    pack_code_bits(codes + (size_t)c * p.L, p.L, bits, W, warp, MC_WARPS,
                   lane);
    __syncthreads();
    float acc[2 * K];
    gather_corr_taps<K, ORDER>(x + (size_t)c * p.N, min(n_valid[c], p.N),
                               bits, p.L, step[c], rem[c], p.shifts, cp[c],
                               cs[c], 0.5f * cr[c], tid, MC_THREADS, acc);
    warp_sum<2 * K>(acc);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 2 * K; ++k) part[warp * 2 * K + k] = acc[k];
    }
    __syncthreads();
    if (warp == 0) {
        float s[2 * K];
#pragma unroll
        for (int k = 0; k < 2 * K; ++k)
            s[k] = lane < MC_WARPS ? part[lane * 2 * K + k] : 0.0f;
        warp_sum<2 * K>(s);
        if (lane == 0) {
#pragma unroll
            for (int k = 0; k < K; ++k)
                out[(size_t)c * K + k] = make_float2(s[k], s[K + k]);
        }
    }
}

typedef void (*McKernel)(const float2*, const float*, const float*,
                         const float*, const float*, const float*,
                         const float*, const int*, float2*, const McParams);

static McKernel mc_kernel_for(int K, int order) {
    if (K == 3) return order == 3 ? multicorrelate_kernel<3, 3>
                                  : multicorrelate_kernel<3, 2>;
    if (K == 5) return order == 3 ? multicorrelate_kernel<5, 3>
                                  : multicorrelate_kernel<5, 2>;
    return nullptr;
}

// One launch of C blocks on `stream`; checks the launch, never
// synchronises and allocates nothing; returns the CUDA error.
extern "C" int multicorrelate_launch(const void* x, const void* codes,
                                     const void* step, const void* rem,
                                     const void* cp, const void* cs,
                                     const void* cr, const void* n_valid,
                                     void* out, const McParams* params,
                                     void* stream) {
    const McParams p = *params;
    McKernel kernel = mc_kernel_for(p.K, p.order);
    if (kernel == nullptr || p.C < 1 || p.N < 1 || p.L < 1
        || (p.order != 2 && p.order != 3))
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * MC_WARPS * 2 * p.K
                        + sizeof(uint32_t) * ((p.L + 31) / 32);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<p.C, MC_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(x),
        reinterpret_cast<const float*>(codes),
        reinterpret_cast<const float*>(step),
        reinterpret_cast<const float*>(rem),
        reinterpret_cast<const float*>(cp), reinterpret_cast<const float*>(cs),
        reinterpret_cast<const float*>(cr),
        reinterpret_cast<const int*>(n_valid),
        reinterpret_cast<float2*>(out), p);
    return (int)cudaGetLastError();
}
