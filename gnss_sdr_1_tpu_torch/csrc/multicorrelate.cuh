// One epoch of the gather multicorrelator for NVIDIA Hopper (sm_90a): C
// channels, each over a thread-block cluster of G CTAs, K taps.
//
// Computes what gnss_sdr_1_tpu_torch/ops/multicorrelator.py:multicorrelate
// computes for one segment per channel: the carrier wiped with cp + cs n
// (+ (0.5 cr) n n at ORDER 3), the floor code resampler
// floor(step n + shift_k - rem) mod L, and the K dot products over the
// first n_valid samples.  It takes the place of the JAX package's XLA
// `multicorrelate` (gnss_sdr_1_tpu/ops/multicorrelator.py:36, not a Pallas
// kernel) where the TCP connector (track/tcp_connector.py) calls it once
// per epoch.
//
// What bounds it: each sample is read once (8 bytes) and costs a sine, a
// cosine and K table reads; a 1 ms GPS epoch of one channel is 2,000-4,000
// samples, microseconds of work on one SM and less spread over a cluster,
// so a call is bound by its launch.  Design:
// - one cluster of G CTAs a channel (G from the row length N on the host,
//   ops/multicorrelator.py mc_geometry: about MC_SLICE samples a CTA, at
//   most MC_MAX_CLUSTER, above 8 the non-portable cluster size), C
//   clusters in one grid; CTA `rank` takes the contiguous slice
//   [rank S, rank S + S) of its channel's first n_valid samples;
// - thread 0 brings the slice into shared memory with one cp.async.bulk
//   onto an mbarrier; the copy wants 16-byte ends, so an odd head and
//   tail sample come by plain loads (the slice starts at any sample),
//   while every warp packs the channel's code row into bits
//   (gather_corr.cuh pack_code_bits);
// - each thread sums its strided samples of the slice in order
//   (mc_sample, the per-sample body of gather_corr.cuh gather_corr_taps
//   reading shared memory), the warps reduce by shuffles and warp 0 sums
//   the warps;
// - every CTA but rank 0 writes its 2K sums into rank 0's shared memory
//   (distributed shared memory); behind one cluster barrier rank 0 adds
//   the ranks' sums in rank order, so the result does not depend on
//   scheduling.  The writes wait for every CTA of the cluster to have
//   started (a barrier phase whose arrival is the kernel's first
//   instruction and whose wait follows the correlation);
// - the per-channel arguments arrive in the __grid_constant__ parameter
//   block: by value (Python numbers, up to MC_MAX_C channels) or as
//   pointers to [C] tensors on the card, so a call uploads nothing; the
//   launch never synchronises, and each instance's attributes are set at
//   its first launch only.
// Built into the gather walk's library (gather_block.cu includes it):
// nvcc -O3 --fmad=false, without --use_fast_math.  With -DMC_STAGES (a
// separate build) thread 0 of every CTA writes a timeline (MC_T_* below)
// to `stages`, and the launch takes a probe mask that leaves parts of the
// per-sample body out (MC_PROBE_*; for timing only: the taps are then
// wrong).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster_walk.cuh"
#include "gather_corr.cuh"

#define MC_THREADS 256
#define MC_WARPS (MC_THREADS / 32)
#define MC_MAX_K 5
#define MC_MAX_C 32
#define MC_MAX_CLUSTER 16
// the per-channel arguments: the floats step, rem, cp, cs, cr, then the
// integer n_valid (ops/multicorrelator.py MC_ARGS)
#define MC_STEP 0
#define MC_REM 1
#define MC_CP 2
#define MC_CS 3
#define MC_CR 4
#define MC_NV 5
#define MC_ARGS 6
// the timeline of a CTA (MC_STAGES builds): SM clock cycles of thread 0
// (ops/multicorrelator.py T_*), and the samples it correlated
#define MC_T_START 0    // the kernel begins
#define MC_T_ISSUED 1   // the bulk copy issued, the head and tail loaded
#define MC_T_PACKED 2   // its warp's share of the code bits packed
#define MC_T_READY 3    // every warp's bits and the copy landed
#define MC_T_CORR 4     // its samples correlated
#define MC_T_CTA 5      // the CTA's sums written (warp 0)
#define MC_T_DONE 6     // past the cluster barrier (rank 0: the taps out)
#define MC_T_SAMPLES 7  // samples thread 0 correlated
#define MC_STAGE_POINTS 8
// the probe mask (MC_STAGES builds): what the per-sample body leaves out
#define MC_PROBE_SINCOS 1  // the sine and cosine (cos 1, sin 0)
#define MC_PROBE_TAPS 2    // the code indices (every chip +1)
#define MC_PROBE_F32 4     // the double-precision range reduction (float32)

#ifdef MC_STAGES
constexpr bool kMcStages = true;
#else
constexpr bool kMcStages = false;
#endif

// Mirror of ops/multicorrelator.py McParams.  dev[a]: the [C] values of
// argument a on the card (element stride stride[a], 0 for one value for
// every channel), or null: then val[a] (n_valid for MC_NV) holds them.
struct McParams {
    const void* dev[MC_ARGS];
    int stride[MC_ARGS];
    int C, K, N, L, order, G, slice, smem, probe;
    float shifts[MC_MAX_K];
    float val[MC_ARGS - 1][MC_MAX_C];
    int n_valid[MC_MAX_C];
};
static_assert(offsetof(McParams, dev) == 0, "McParams layout");
static_assert(offsetof(McParams, stride) == 48, "McParams layout");
static_assert(offsetof(McParams, C) == 72, "McParams layout");
static_assert(offsetof(McParams, probe) == 104, "McParams layout");
static_assert(offsetof(McParams, shifts) == 108, "McParams layout");
static_assert(offsetof(McParams, val) == 128, "McParams layout");
static_assert(offsetof(McParams, n_valid) == 768, "McParams layout");
static_assert(sizeof(McParams) == 896, "McParams layout");

// Byte offsets of a CTA's dynamic shared memory (ops/multicorrelator.py
// mc_layout): the mbarrier, the warps' sums, the ranks' sums (rank 0's
// are read), the code bits, the slice (S samples and one of skew).
struct McLayout {
    int part, cl, bits, buf, total;
};

__host__ __device__ inline McLayout mc_layout(int K, int G, int L,
                                              int slice) {
    McLayout l;
    l.part = 16;
    l.cl = l.part + round16(4 * MC_WARPS * 2 * K);
    l.bits = l.cl + round16(4 * G * 2 * K);
    l.buf = l.bits + round16(4 * ((L + 31) / 32));
    l.total = l.buf + round16(8 * (slice + 1));
    return l;
}

__device__ __forceinline__ float mc_float(const McParams& p, int a, int c) {
    const float* d = static_cast<const float*>(p.dev[a]);
    return d != nullptr ? d[(size_t)c * p.stride[a]] : p.val[a][c];
}

__device__ __forceinline__ int mc_n_valid(const McParams& p, int c) {
    const int* d = static_cast<const int*>(p.dev[MC_NV]);
    return d != nullptr ? d[(size_t)c * p.stride[MC_NV]] : p.n_valid[c];
}

__device__ __forceinline__ long long mc_clock() {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t) :: "memory");
    return t;
}

// sin and cos of x with a float32 range reduction, |x| <= 105615 (the
// MC_PROBE_F32 probe): three fused multiply-adds by pi/2 in three parts,
// then sincos_wide's polynomials.
__device__ __forceinline__ void sincos_f32(float x, float* s, float* c) {
    const float n = rintf(x * 0.636619772f);
    float r = fmaf(n, -1.57079625e+00f, x);
    r = fmaf(n, -7.54978942e-08f, r);
    r = fmaf(n, -5.39030253e-15f, r);
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

// Sample v at index n of its channel into the K taps: the arithmetic of
// gather_corr.cuh gather_corr_taps, rounded as it rounds.  `probe` (the
// stage build only) leaves parts out.
template <int K, int ORDER>
__device__ __forceinline__ void mc_sample(float2 v, int n,
                                          const uint32_t* bits, int len,
                                          float step, float rem,
                                          const float* sh, float cp,
                                          float cs, float hr, int probe,
                                          float acc[2 * K]) {
    const float nf = (float)n;
    float ph = fmaf(cs, nf, cp);
    if (ORDER == 3) ph = fmaf(__fmul_rn(hr, nf), nf, ph);
    float sn, cn;
    if (kMcStages && (probe & MC_PROBE_SINCOS)) {
        sn = 0.0f;
        cn = 1.0f;
    } else if (kMcStages && (probe & MC_PROBE_F32)) {
        sincos_f32(ph, &sn, &cn);
    } else {
        sincos_wide(ph, &sn, &cn);
    }
    const float wr = __fadd_rn(__fmul_rn(v.x, cn), __fmul_rn(v.y, sn));
    const float wi = __fsub_rn(__fmul_rn(v.y, cn), __fmul_rn(v.x, sn));
#pragma unroll
    for (int k = 0; k < K; ++k) {
        bool plus = true;
        if (!(kMcStages && (probe & MC_PROBE_TAPS))) {
            // floor, then mod L with L's sign (gather_corr_taps)
            int idx = (int)floorf(__fsub_rn(fmaf(step, nf, sh[k]), rem));
            if ((unsigned)idx >= (unsigned)len) {
                while (idx >= len) idx -= len;
                while (idx < 0) idx += len;
            }
            plus = (bits[idx >> 5] >> (idx & 31)) & 1u;
        }
        acc[k] = __fadd_rn(acc[k], plus ? wr : -wr);
        acc[K + k] = __fadd_rn(acc[K + k], plus ? wi : -wi);
    }
}

template <int K, int ORDER>
__global__ void __launch_bounds__(MC_THREADS)
multicorrelate_kernel(const float2* __restrict__ x,
                      const float* __restrict__ codes,
                      float2* __restrict__ out,
                      long long* __restrict__ stages,
                      const __grid_constant__ McParams p) {
    // every CTA of the cluster has begun before rank 0's shared memory is
    // written (the matching wait follows the correlation)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) unsigned char mc_smem[];
    const McLayout lay = mc_layout(K, p.G, p.L, p.slice);
    uint64_t* bar = reinterpret_cast<uint64_t*>(mc_smem);
    float* part = reinterpret_cast<float*>(mc_smem + lay.part);
    float* cl = reinterpret_cast<float*>(mc_smem + lay.cl);
    uint32_t* bits = reinterpret_cast<uint32_t*>(mc_smem + lay.bits);
    float2* buf = reinterpret_cast<float2*>(mc_smem + lay.buf);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rank = (int)cluster.block_rank();
    const int c = blockIdx.x / p.G;
    long long* tl = stages + (size_t)blockIdx.x * MC_STAGE_POINTS;
    if (kMcStages && tid == 0) tl[MC_T_START] = mc_clock();

    // the CTA's slice: cnt samples from lo, sample i at buf[skew + i]; the
    // bulk copy takes nb of them from the first 16-byte aligned one
    const int nv = max(min(mc_n_valid(p, c), p.N), 0);
    const int lo = rank * p.slice;
    const int cnt = max(min(p.slice, nv - lo), 0);
    const float2* src = x + (size_t)c * p.N + lo;
    const int skew = (int)((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
    const int head = min(skew, cnt);
    const int nb = (cnt - head) & ~1;
    if (tid == 0) {
        mbar_init(bar);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        if (nb > 0)
            bulk_load(buf + skew + head, src + head, (uint32_t)(8 * nb), bar);
        if (head) buf[skew] = src[0];
        if (head + nb < cnt) buf[skew + cnt - 1] = src[cnt - 1];
        if (kMcStages) tl[MC_T_ISSUED] = mc_clock();
    }
    pack_code_bits(codes + (size_t)c * p.L, p.L, bits, (p.L + 31) / 32, warp,
                   MC_WARPS, lane);
    if (kMcStages && tid == 0) tl[MC_T_PACKED] = mc_clock();
    cta_barrier();
    if (nb > 0) mbar_wait(bar, 0);
    if (kMcStages && tid == 0) tl[MC_T_READY] = mc_clock();

    const float step = mc_float(p, MC_STEP, c), rem = mc_float(p, MC_REM, c);
    const float cp = mc_float(p, MC_CP, c), cs = mc_float(p, MC_CS, c);
    const float hr = ORDER == 3 ? 0.5f * mc_float(p, MC_CR, c) : 0.0f;
    float acc[2 * K];
#pragma unroll
    for (int k = 0; k < 2 * K; ++k) acc[k] = 0.0f;
    int mine = 0;
    for (int i = tid; i < cnt; i += MC_THREADS, ++mine)
        mc_sample<K, ORDER>(buf[skew + i], lo + i, bits, p.L, step, rem,
                            p.shifts, cp, cs, hr, p.probe, acc);
    if (kMcStages && tid == 0) {
        tl[MC_T_CORR] = mc_clock();
        tl[MC_T_SAMPLES] = mine;
    }
    warp_sum<2 * K>(acc);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 2 * K; ++k) part[warp * 2 * K + k] = acc[k];
    }
    cta_barrier();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (warp == 0) {
        float s[2 * K];
#pragma unroll
        for (int k = 0; k < 2 * K; ++k)
            s[k] = lane < MC_WARPS ? part[lane * 2 * K + k] : 0.0f;
        warp_sum<2 * K>(s);
        if (lane == 0) {
            float* dst = cluster.map_shared_rank(cl, 0) + rank * 2 * K;
#pragma unroll
            for (int k = 0; k < 2 * K; ++k) dst[k] = s[k];
            if (kMcStages) tl[MC_T_CTA] = mc_clock();
        }
    }
    __syncwarp();
    cluster.sync();
    if (rank == 0 && tid < K) {
        float si = cl[tid], sq = cl[K + tid];
        for (int r = 1; r < p.G; ++r) {
            si = __fadd_rn(si, cl[r * 2 * K + tid]);
            sq = __fadd_rn(sq, cl[r * 2 * K + K + tid]);
        }
        out[(size_t)c * K + tid] = make_float2(si, sq);
    }
    if (kMcStages && tid == 0) tl[MC_T_DONE] = mc_clock();
}

// The launch floor of the same geometry: a kernel that does nothing.
__global__ void __launch_bounds__(MC_THREADS)
mc_empty_kernel(const __grid_constant__ McParams p) {}

typedef void (*McKernel)(const float2*, const float*, float2*, long long*,
                         const McParams);

// the instance for K taps and the order; `slot` its index (0-3)
static McKernel mc_kernel_for(int K, int order, int* slot) {
    *slot = (K == 5) * 2 + (order == 3);
    if (K == 3) return order == 3 ? multicorrelate_kernel<3, 3>
                                  : multicorrelate_kernel<3, 2>;
    if (K == 5) return order == 3 ? multicorrelate_kernel<5, 3>
                                  : multicorrelate_kernel<5, 2>;
    return nullptr;
}

// The block against what the kernel takes; 0 or the CUDA error.
static int mc_check(const McParams& p) {
    if ((p.K != 3 && p.K != 5) || (p.order != 2 && p.order != 3)
        || p.C < 1 || p.N < 1 || p.L < 1)
        return (int)cudaErrorInvalidValue;
    for (int a = 0; a < MC_ARGS; ++a)
        if ((p.dev[a] == nullptr && p.C > MC_MAX_C) || p.stride[a] < 0)
            return (int)cudaErrorInvalidValue;
    if (p.G < 1 || p.G > MC_MAX_CLUSTER || p.slice < 1
        || (long long)p.slice * p.G < p.N
        || (long long)p.slice * (p.G - 1) >= p.N
        || (long long)p.C * p.G > 0x7fffffff
        || p.smem != mc_layout(p.K, p.G, p.L, p.slice).total
        || p.smem > CLUSTER_SMEM_MAX || (p.probe != 0 && !kMcStages))
        return (int)cudaErrorInvalidConfiguration;
    return 0;
}

// The dynamic shared memory ceiling and the non-portable cluster size of
// `kernel` on the current device, once a device (`done`: a bit a device;
// the attributes are the current device's own).
static cudaError_t mc_configure(const void* kernel, unsigned* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (*done & bit) return cudaSuccess;
    err = cluster_set_attributes(kernel, CLUSTER_SMEM_MAX, MC_MAX_CLUSTER);
    if (err == cudaSuccess) *done |= bit;
    return err;
}

// C clusters of G CTAs in one grid.
static cudaLaunchConfig_t mc_config(const McParams& p,
                                    cudaLaunchAttribute* attr,
                                    void* stream) {
    cudaLaunchConfig_t cfg =
        cluster_config(p.G, MC_THREADS, p.smem, attr,
                       reinterpret_cast<cudaStream_t>(stream));
    cfg.gridDim = dim3(p.C * p.G, 1, 1);
    return cfg;
}

// One launch on `stream`: checks the block and the launch, never
// synchronises and allocates nothing; returns the CUDA error.  `stages`:
// int64 [C G][MC_STAGE_POINTS] on the card for an MC_STAGES build, else
// null.
extern "C" int multicorrelate_launch(const void* x, const void* codes,
                                     void* out, void* stages,
                                     const McParams* params, void* stream) {
    static unsigned configured[4];
    const McParams& p = *params;
    const int bad = mc_check(p);
    if (bad != 0) return bad;
    if ((stages != nullptr) != kMcStages)
        return (int)cudaErrorInvalidConfiguration;
    int slot = 0;
    McKernel kernel = mc_kernel_for(p.K, p.order, &slot);
    cudaError_t err =
        mc_configure(reinterpret_cast<const void*>(kernel), &configured[slot]);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = mc_config(p, &attr, stream);
    err = cudaLaunchKernelEx(&cfg, kernel, reinterpret_cast<const float2*>(x),
                             reinterpret_cast<const float*>(codes),
                             reinterpret_cast<float2*>(out),
                             reinterpret_cast<long long*>(stages), p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The empty kernel in the geometry `params` gives the multicorrelator.
extern "C" int multicorrelate_empty_launch(const McParams* params,
                                           void* stream) {
    static unsigned configured;
    const McParams& p = *params;
    const int bad = mc_check(p);
    if (bad != 0) return bad;
    cudaError_t err = mc_configure(
        reinterpret_cast<const void*>(mc_empty_kernel), &configured);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = mc_config(p, &attr, stream);
    err = cudaLaunchKernelEx(&cfg, mc_empty_kernel, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
