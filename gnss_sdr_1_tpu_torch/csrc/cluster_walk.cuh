// The skeleton the cluster walks share (kf_block.cu, gather_block.cu): one
// thread-block cluster with one CTA per channel and rounds past the
// cluster, each CTA's channels as columns of shared-memory state rows, the
// window origin m exchanged through distributed shared memory once an
// epoch, and the next window prefetched by one bulk copy onto an mbarrier.
// Host side: the cluster launch's attributes and configuration, and the
// largest cluster the card schedules.  The Python mirror of the launch
// constants and of the prefetch buffer's size is ops/cluster_walk.py.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

// the portable cluster size (above it the launch sets
// cudaFuncAttributeNonPortableClusterSizeAllowed) and the dynamic shared
// memory one CTA may use on Hopper (ops/cluster_walk.py PORTABLE_CLUSTER,
// SMEM_MAX)
#define CLUSTER_PORTABLE 8
#define CLUSTER_SMEM_MAX 232448

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// One prefetch buffer: n_max samples from a 16-byte aligned start (one
// sample of skew at most) rounded up to 16 bytes.
__host__ __device__ inline int prefetch_bytes(int n_max) {
    return round16(8 * (n_max + 2));
}

// A CTA-wide barrier.  Lane 0 of warp 0 runs a channel's update alone, and
// __syncthreads() is an aligned barrier, which a warp must reach
// converged: without the __syncwarp() a lone lane 0 can pass it
// (ROADMAP.md, "Traps").
__device__ __forceinline__ void cta_barrier() {
    __syncwarp();
    __syncthreads();
}

// Rows [rows][C] of global memory into the CTA's columns [rows][ld]: CTA
// `rank` owns channels rank, rank + n_cta, ... (n_own of them).
template <typename T>
__device__ __forceinline__ void load_columns(T* dst, const T* src, int rows,
                                             int n_own, int ld, int C,
                                             int rank, int n_cta, int tid,
                                             int threads) {
    for (int k = tid; k < rows * n_own; k += threads) {
        const int row = k / n_own, j = k - row * n_own;
        dst[row * ld + j] = src[row * C + rank + j * n_cta];
    }
}

template <typename T>
__device__ __forceinline__ void store_columns(T* dst, const T* src, int rows,
                                              int n_own, int ld, int C,
                                              int rank, int n_cta, int tid,
                                              int threads) {
    for (int k = tid; k < rows * n_own; k += threads) {
        const int row = k / n_own, j = k - row * n_own;
        dst[row * C + rank + j * n_cta] = src[row * ld + j];
    }
}

// The epoch's window origin before its clip: thread 0 publishes the CTA's
// minimum (`local`, the minimum start of its active channels; only thread
// 0's value is read) into slot `parity` of its own shared memory, one
// cluster barrier, then every warp reads all the ranks' slots (a lane
// each) and every thread returns the same integer minimum.  The
// double-buffered slot makes one barrier an epoch enough: a slot is written
// again only after every peer has passed the next barrier.
__device__ __forceinline__ int cluster_min(
    cooperative_groups::cluster_group& cluster, int* slot, int parity,
    int local, int tid, int lane, int n_cta) {
    if (tid == 0) slot[parity] = local;
    __syncwarp();
    cluster.sync();
    int v = 1 << 29;
    if (lane < n_cta) v = *cluster.map_shared_rank(slot + parity, lane);
    return __reduce_min_sync(0xffffffffu, v);
}

// --- mbarrier and bulk copy (PTX) ---

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to shared
// `dst`, completing on `bar` (one arrival plus the bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    const uint32_t b = smem_addr(bar);
    // the buffer's earlier reads (generic proxy) before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// --- the prefetch of the next window, one record per channel slot ---

// the prefetch record of one channel slot (shared, written by thread 0)
#define PF_PENDING 0   // a copy is in flight or unconsumed
#define PF_START 1     // global sample index the window would start at
#define PF_SKEW 2      // samples between the buffer's start and PF_START
#define PF_PARITY 3    // mbarrier parity of the pending copy

// Thread 0: the mbarrier and an empty record of each of the n_own slots.
__device__ __forceinline__ void prefetch_init(uint64_t* bar, int* info,
                                              int n_own) {
    for (int j = 0; j < n_own; ++j) {
        mbar_init(bar + j);
        info[4 * j + PF_PENDING] = 0;
        info[4 * j + PF_PARITY] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Where the window starting at global sample `start` is read from: the
// slot's buffer when its pending copy (waited for) starts there, else
// `src` in global memory.
__device__ __forceinline__ const float2* prefetched(int* rec, uint64_t* bar,
                                                    const float2* buf,
                                                    int start,
                                                    const float2* src) {
    if (rec[PF_PENDING]) {
        mbar_wait(bar, (uint32_t)rec[PF_PARITY]);
        if (rec[PF_START] == start) return buf + rec[PF_SKEW];
    }
    return src;
}

// Thread 0, once every warp has read the epoch's window: the pending copy
// is consumed; then, where `may` holds and the aligned span lies inside
// x[0, n_samp), copy n_max samples from global sample `gs` into `buf`.
__device__ __forceinline__ void prefetch_next(int* rec, uint64_t* bar,
                                              float2* buf, const float2* x,
                                              int n_samp, int gs, int n_max,
                                              bool may) {
    if (rec[PF_PENDING]) {
        rec[PF_PENDING] = 0;
        rec[PF_PARITY] ^= 1;
    }
    const uintptr_t lo = reinterpret_cast<uintptr_t>(x + gs) & ~(uintptr_t)15;
    const uintptr_t hi =
        (reinterpret_cast<uintptr_t>(x + gs + n_max) + 15) & ~(uintptr_t)15;
    if (may && lo >= reinterpret_cast<uintptr_t>(x)
        && hi <= reinterpret_cast<uintptr_t>(x + n_samp)) {
        rec[PF_PENDING] = 1;
        rec[PF_START] = gs;
        rec[PF_SKEW] = (int)((reinterpret_cast<uintptr_t>(x + gs) - lo) / 8);
        bulk_load(buf, reinterpret_cast<const void*>(lo), (uint32_t)(hi - lo),
                  bar);
    }
}

// Thread 0 before the CTA exits: no copy may land after it is gone.
__device__ __forceinline__ void prefetch_drain(uint64_t* bar, const int* info,
                                               int n_own) {
    for (int j = 0; j < n_own; ++j)
        if (info[4 * j + PF_PENDING])
            mbar_wait(bar + j, (uint32_t)info[4 * j + PF_PARITY]);
}

// --- host: the cluster launch ---

static cudaError_t cluster_set_attributes(const void* kernel, int smem,
                                          int n_cta) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && n_cta > CLUSTER_PORTABLE)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
}

// One cluster of n_cta CTAs of `threads` threads as the whole grid.
static cudaLaunchConfig_t cluster_config(int n_cta, int threads, int smem,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_cta, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = n_cta;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// The largest cluster of `threads`-thread CTAs of `kernel` with `smem`
// bytes of dynamic shared memory each that the card can schedule (at
// least one such cluster active), up to max_cluster; minus the CUDA error
// when none can be.
static int cluster_max(const void* kernel, int threads, int smem,
                       int max_cluster) {
    cudaError_t err = cluster_set_attributes(kernel, smem, max_cluster);
    if (err != cudaSuccess) return -(int)err;
    for (int n = max_cluster; n >= 1; --n) {
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg = cluster_config(n, threads, smem, &attr, 0);
        int active = 0;
        err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
        if (err == cudaSuccess && active >= 1) return n;
        cudaGetLastError();
    }
    return -(int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
}
