// The per-epoch gather DLL/PLL walk for NVIDIA Hopper (sm_90a): every epoch
// of every channel of a capture segment in one launch.
//
// Computes exactly what the plain torch version
// gnss_sdr_1_tpu_torch/ops/gather_block.py:gather_block_plain computes (the
// state and output rows are ops/track_chain.py's F_* / I_* / O_*, rows.cuh):
// per epoch the window origin m over the active channels, each channel's
// offset from it, the exact gather multicorrelator over K taps
// (gather_corr.cuh) and the chain's loop closure (loop_close.cuh).  It
// takes the place of the JAX package's gather loop,
// gnss_sdr_1_tpu/track/engine.py `_epoch_step` (:786) with `_loop_update`
// (:548) under `_track_capture_impl` / `_track_block_impl` (:1486, :1171),
// which is not a Pallas kernel.
//
// What bounds it: per epoch and channel the correlation touches each of its
// ~4,000 (GPS at 4.092 Msps) to ~41,000 (L2C) samples once: 8 bytes, a sine
// and a cosine, K table reads; the card could do a whole segment of 12
// channels in a few milliseconds.  But the epochs are serial (each epoch's
// code and carrier phase come from the previous epoch's closure) and the
// channels are coupled through m, so the time is the segment's epochs times
// one correlation pass, one block reduction, one closure on one thread and
// one exchange of m.
//
// Design, against that chain (the skeleton of kf_block.cu, shared in
// cluster_walk.cuh):
// - one thread block (CTA) of GB_THREADS threads per channel, all in one
//   thread-block cluster of n_cta = min(C, max_cluster) CTAs; CTA r takes
//   channels r, r + n_cta, ... in rounds, so rounds happen only when C
//   exceeds the cluster;
// - m through distributed shared memory: each CTA's thread 0 writes the
//   minimum start of its active channels into slot e & 1 of its own shared
//   memory, one cluster barrier an epoch, then every warp reads all the
//   ranks' slots (a lane each) and takes the same integer minimum;
// - the correlation spreads over all the CTA's warps (gather_corr_taps,
//   the code row as bits in shared memory), warp sums, then warp 0 sums
//   the warps' partials and its lane 0 closes the loop (loop_close.cuh)
//   with the channel's state columns in shared memory;
// - the next epoch's samples are prefetched: its window starts at start +
//   cur_len, known before the closure runs, so thread 0 copies n_max
//   samples from there into the channel's shared-memory buffer with one
//   bulk copy (cp.async.bulk onto an mbarrier) while lane 0 closes the
//   loop; the next epoch correlates from it when its offset is that start,
//   and from global memory when the clip to m moves the window.  Whether
//   the buffers exist is decided from the shape (ops/gather_block.py
//   gather_geometry): an L2C epoch of 41,000 samples does not fit;
// - templates on K (3 or 5 taps), the PLL order and the secondary-code
//   flags, the chain's 16 instances; the secondary wipe happens in the
//   closure, the GLONASS FDMA offset enters the carrier step.
// The closure is not split around the correlation yet (kf_block.cu does
// that); lane 0 runs all of it after the taps are in.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false,
// WITHOUT --use_fast_math.  The carrier and code steps multiply by the
// float32 reciprocal of fs, as the JAX package's compiled step does.

#include <cooperative_groups.h>

#include <cstdint>

#include "cluster_walk.cuh"
#include "gather_corr.cuh"
#include "loop_close.cuh"
#include "multicorrelate.cuh"

namespace cg = cooperative_groups;

// launch geometry (ops/gather_block.py GB_THREADS, GB_MAX_CLUSTER)
#define GB_THREADS 256
#define GB_WARPS (GB_THREADS / 32)
#define GB_MAX_CLUSTER 16

// Mirror of ops/gather_block.py GatherParams.
struct GatherParams {
    int C, K, n_max, win, code_len, sec_len, n_samp, n_epochs;
    float chip_rate, inv_fs, spc, two_pi;
    float shifts[MAX_K];
    // launch geometry (ops/gather_block.py gather_geometry), checked
    int n_cta, cpc, threads, prefetch, pf_bytes, smem;
};

// Byte offsets of one CTA's dynamic shared memory (ops/gather_block.py
// gather_layout): the prefetch mbarriers [cpc], the two m slots, the
// prefetch records [cpc][4], the prefetch buffers [cpc][pf_bytes], the code
// bits [cpc][W], the float and int state rows [SF][cpc] and [N_IROWS][cpc],
// the secondary chips [cpc][sec_len] and the warp partials [2][warps][2K].
struct GbLayout {
    int bar, slot, info, pf, bits, sf, si, sec, part, total;
};

__host__ __device__ inline GbLayout gb_layout(const GatherParams& p) {
    const int W = (p.code_len + 31) / 32;
    const int SF = F_ACC_R0 + 2 * p.K;
    GbLayout l;
    l.bar = 0;
    l.slot = 8 * p.cpc;
    l.info = l.slot + 8;
    l.pf = round16(l.info + 16 * p.cpc);
    l.bits = l.pf + (p.prefetch ? p.cpc * p.pf_bytes : 0);
    l.sf = l.bits + 4 * p.cpc * W;
    l.si = l.sf + 4 * SF * p.cpc;
    l.sec = l.si + 4 * N_IROWS * p.cpc;
    l.part = l.sec + 4 * p.sec_len * p.cpc;
    l.total = l.part + 4 * 2 * GB_WARPS * 2 * p.K;
    return l;
}

// Every CTA barrier below is cta_barrier() (cluster_walk.cuh): lane 0 of
// warp 0 runs the closure alone.
template <int K, int ORDER, bool SEC_DATA, bool HAS_SEC>
__global__ void __launch_bounds__(GB_THREADS, 1)
gather_block_kernel(const float2* __restrict__ x,
                    const float* __restrict__ codes,
                    const float* __restrict__ sec_rows,
                    const float* __restrict__ fst,
                    const int* __restrict__ ist, float* __restrict__ out_f,
                    int* __restrict__ out_i, float* __restrict__ out_corr,
                    float* __restrict__ fst_out, int* __restrict__ ist_out,
                    const __grid_constant__ ChainParams lp,
                    const __grid_constant__ GatherParams p) {
    extern __shared__ __align__(16) unsigned char gb_smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const GbLayout lay = gb_layout(p);
    const int C = p.C, n_cta = p.n_cta, ld = p.cpc;
    const int rank = (int)cluster.block_rank();
    const int n_own = (C - rank + n_cta - 1) / n_cta;   // r, r + n_cta, ...
    const int SF = F_ACC_R0 + 2 * K;
    const int W = (p.code_len + 31) / 32;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int pf_len = p.pf_bytes / 8;                    // float2 per buffer

    uint64_t* bar = reinterpret_cast<uint64_t*>(gb_smem + lay.bar);
    int* slot = reinterpret_cast<int*>(gb_smem + lay.slot);
    int* info = reinterpret_cast<int*>(gb_smem + lay.info);
    float2* pf = reinterpret_cast<float2*>(gb_smem + lay.pf);
    uint32_t* bits = reinterpret_cast<uint32_t*>(gb_smem + lay.bits);
    float* sf = reinterpret_cast<float*>(gb_smem + lay.sf);
    int* si = reinterpret_cast<int*>(gb_smem + lay.si);
    float* sec_s = reinterpret_cast<float*>(gb_smem + lay.sec);
    float* part = reinterpret_cast<float*>(gb_smem + lay.part);

    load_columns(sf, fst, SF, n_own, ld, C, rank, n_cta, tid, GB_THREADS);
    load_columns(si, ist, N_IROWS, n_own, ld, C, rank, n_cta, tid,
                 GB_THREADS);
    for (int k = tid; k < p.sec_len * n_own; k += GB_THREADS) {
        const int row = k / n_own, j = k - row * n_own;
        sec_s[j * p.sec_len + row] = sec_rows[row * C + rank + j * n_cta];
    }
    if (tid == 0) prefetch_init(bar, info, n_own);
    for (int j = 0; j < n_own; ++j)
        pack_code_bits(codes + (size_t)(rank + j * n_cta) * p.code_len,
                       p.code_len, bits + j * W, W, warp, GB_WARPS, lane);
    cta_barrier();

    const int win = min(p.win, p.n_samp);
    int parity = 0;                               // the m slot of this epoch
    for (int e = 0; e < p.n_epochs; ++e, parity ^= 1) {
        // thread 0 wrote every state word of this CTA: its minimum
        int local = 1 << 29;
        if (tid == 0)
            for (int j = 0; j < n_own; ++j)
                if (si[I_ACTIVE * ld + j] > 0)
                    local = min(local, si[I_START * ld + j]);
        const int m = min(max(cluster_min(cluster, slot, parity, local, tid,
                                          lane, n_cta), 0),
                          p.n_samp - win);
        for (int j = 0; j < n_own; ++j) {
            const int c = rank + j * n_cta;
            const int start = si[I_START * ld + j];
            const int cur_len = si[I_CURLEN * ld + j];
            const bool valid = si[I_ACTIVE * ld + j] > 0
                               && start < si[I_LIMIT * ld + j];
            float acc[2 * K];
#pragma unroll
            for (int k = 0; k < 2 * K; ++k) acc[k] = 0.0f;
            if (valid) {
                const int off = m + min(max(start - m, 0), win - p.n_max);
                const float2* src = prefetched(info + 4 * j, bar + j,
                                               pf + (size_t)j * pf_len, off,
                                               x + off);
                // the multicorrelator's arguments, rounded as the JAX
                // package's compiled step rounds them (ops/gather_block.py
                // epoch_params)
                const float code_freq = p.chip_rate + sf[F_DELTA * ld + j];
                const float step = (code_freq * p.inv_fs) * p.spc;
                const float rem = ((code_freq * sf[F_REM_CODE * ld + j])
                                   * p.inv_fs) * p.spc;
                const float cs = (p.two_pi * (sf[F_DOPPLER * ld + j]
                                              + sf[F_CARR_OFF * ld + j]))
                                 * p.inv_fs;
                gather_corr_taps<K, 2>(src, min(cur_len, p.n_max),
                                       bits + j * W, p.code_len, step, rem,
                                       p.shifts, sf[F_REM_CARR * ld + j], cs,
                                       0.0f, tid, GB_THREADS, acc);
            }
            float* pj = part + (j & 1) * GB_WARPS * 2 * K;
            warp_sum<2 * K>(acc);
            if (lane == 0) {
#pragma unroll
                for (int k = 0; k < 2 * K; ++k) pj[warp * 2 * K + k] = acc[k];
            }
            cta_barrier();
            if (tid == 0 && valid) {
                // the pending copy was consumed above; prefetch the next
                // window, start + cur_len, where the channel may run
                const int gs = start + cur_len;
                prefetch_next(info + 4 * j, bar + j, pf + (size_t)j * pf_len,
                              x, p.n_samp, gs, p.n_max,
                              p.prefetch && gs >= 0
                                  && gs < si[I_LIMIT * ld + j]);
            }
            if (warp == 0) {
                float s2[2 * K];
#pragma unroll
                for (int k = 0; k < 2 * K; ++k)
                    s2[k] = lane < GB_WARPS ? pj[lane * 2 * K + k] : 0.0f;
                warp_sum<2 * K>(s2);
                if (lane == 0) {
                    LoopState<K> st;
                    load_state<K>(st, sf, si, ld, j);
                    const LoopConsts lc = loop_consts(lp, st.mode0);
                    float s = 1.0f;
                    if (st.sec_on_i > 0)
                        s = HAS_SEC ? sec_s[j * p.sec_len
                                            + min(st.sec_idx, p.sec_len - 1)]
                                    : sec_s[j];
                    loop_close<K, ORDER, SEC_DATA>(
                        lp, lc, st, s2, s2 + K, s,
                        out_f + (size_t)e * N_OROWS * C + c,
                        out_i + (size_t)e * 2 * C + c,
                        out_corr + (size_t)e * 2 * K * C + c, C);
                    store_state<K>(st, sf, si, ld, j);
                }
            }
        }
    }
    if (tid == 0) prefetch_drain(bar, info, n_own);
    cta_barrier();
    store_columns(fst_out, sf, SF, n_own, ld, C, rank, n_cta, tid,
                  GB_THREADS);
    store_columns(ist_out, si, N_IROWS, n_own, ld, C, rank, n_cta, tid,
                  GB_THREADS);
    // no peer may read this CTA's m slots after it exits
    __syncwarp();
    cluster.sync();
}

typedef void (*GatherKernel)(const float2*, const float*, const float*,
                             const float*, const int*, float*, int*, float*,
                             float*, int*, const ChainParams,
                             const GatherParams);

// The template instance for the loop constants (K, order, sec_data,
// sec_len > 1), or null when the kernel does not take them.
static GatherKernel gather_kernel_for(const ChainParams& lp) {
#define GB_PICK(KV, OV)                                                     \
    if (lp.sec_data) return lp.sec_len > 1                                  \
        ? gather_block_kernel<KV, OV, true, true>                           \
        : gather_block_kernel<KV, OV, true, false>;                         \
    return lp.sec_len > 1 ? gather_block_kernel<KV, OV, false, true>        \
                          : gather_block_kernel<KV, OV, false, false>;
    if (lp.P != lp.K / 2) return nullptr;
    if (lp.K == 3 && lp.order == 3) { GB_PICK(3, 3) }
    if (lp.K == 3 && lp.order == 2) { GB_PICK(3, 2) }
    if (lp.K == 5 && lp.order == 3) { GB_PICK(5, 3) }
    if (lp.K == 5 && lp.order == 2) { GB_PICK(5, 2) }
#undef GB_PICK
    return nullptr;
}

// The largest cluster of GB_THREADS-thread CTAs with `smem` bytes of
// dynamic shared memory each that the card can schedule, up to
// GB_MAX_CLUSTER, for the K-tap kernel (cluster_walk.cuh cluster_max).
extern "C" int gather_block_max_cluster(int K, int smem) {
    GatherKernel kernel = K == 5 ? gather_block_kernel<5, 3, false, false>
                                 : gather_block_kernel<3, 3, false, false>;
    return cluster_max(reinterpret_cast<const void*>(kernel), GB_THREADS,
                       smem, GB_MAX_CLUSTER);
}

// One launch: every epoch of the segment on `stream`, as one cluster of
// n_cta CTAs.  Checks the geometry against the layout, checks the launch,
// never synchronises and allocates nothing; returns the CUDA error.
extern "C" int gather_block_launch(const void* x, const void* codes,
                                   const void* sec_rows, const void* fst,
                                   const void* ist, void* out_f, void* out_i,
                                   void* out_corr, void* fst_out,
                                   void* ist_out,
                                   const ChainParams* loop_params,
                                   const GatherParams* params, void* stream) {
    const ChainParams lp = *loop_params;
    const GatherParams p = *params;
    if (p.C < 1 || p.C != lp.C || p.K != lp.K || p.sec_len != lp.sec_len
        || p.code_len < 1 || p.n_max < 1 || p.n_samp < p.n_max
        || p.n_epochs < 0)
        return (int)cudaErrorInvalidValue;
    if (p.threads != GB_THREADS || p.n_cta < 1 || p.n_cta > GB_MAX_CLUSTER
        || p.n_cta > p.C || p.cpc != (p.C + p.n_cta - 1) / p.n_cta
        || (p.prefetch && p.pf_bytes != prefetch_bytes(p.n_max))
        || p.smem != gb_layout(p).total || p.smem > CLUSTER_SMEM_MAX)
        return (int)cudaErrorInvalidConfiguration;
    GatherKernel kernel = gather_kernel_for(lp);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    if (p.n_epochs == 0) return 0;
    cudaError_t err = cluster_set_attributes(
        reinterpret_cast<const void*>(kernel), p.smem, p.n_cta);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(
        p.n_cta, GB_THREADS, p.smem, &attr,
        reinterpret_cast<cudaStream_t>(stream));
    err = cudaLaunchKernelEx(
        &cfg, kernel, reinterpret_cast<const float2*>(x),
        reinterpret_cast<const float*>(codes),
        reinterpret_cast<const float*>(sec_rows),
        reinterpret_cast<const float*>(fst), reinterpret_cast<const int*>(ist),
        reinterpret_cast<float*>(out_f), reinterpret_cast<int*>(out_i),
        reinterpret_cast<float*>(out_corr), reinterpret_cast<float*>(fst_out),
        reinterpret_cast<int*>(ist_out), lp, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
