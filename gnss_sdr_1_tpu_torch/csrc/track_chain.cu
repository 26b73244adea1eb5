// Fused per-epoch tracking chain for NVIDIA Hopper (sm_90a), and the
// capture-level entry that enqueues the chunk correlator (chunk_corr.cuh)
// and the chain for every chunk of a capture segment.
//
// Replaces the Pallas TPU kernel gnss_sdr_1_tpu/ops/pallas_chain.py
// (`_make_kernel`, built by `make_chain_call`).  Computes exactly what the
// plain torch version gnss_sdr_1_tpu_torch/ops/track_chain.py:chain_plain
// computes: for E epochs x C channels, the sequential per-epoch loop closure
// of the chunked DLL/PLL tracking engine, with the loop state carried from
// epoch to epoch.
//
// What bounds it: per 16-epoch chunk and channel a few hundred float32
// operations per epoch and ~9 KB of lag windows, so neither bytes nor
// operations: the time is one dependent chain of E epochs (three atan2f,
// two log10f, a sincos and several divisions per epoch on the critical
// path).  Nothing inside a channel's chain can run in parallel.
//
// Design, against that chain:
// - one warp per channel (one block of 32 threads): the lanes stage the
//   channel's whole chunk window (zr, zi as [C, E, LW], one contiguous block
//   per plane), its slice origins and its secondary-code column in shared
//   memory with asynchronous copies that overlap the state loads, then
//   lane 0 walks the E epochs with the state in registers, each closed
//   by loop_close.cuh (the closure the gather walk shares).
//   Each epoch's tap read, whose address depends on the previous epoch's
//   code phase, costs a shared-memory access instead of an L2/HBM round
//   trip;
// - templates on K (3 or 5 taps, prompt at K / 2), the PLL order and the
//   secondary-code flags, so every tap array is indexed by constants and
//   stays in registers (no stack frame);
// - the rotation's sine and cosine come from a reduction by pi/2 in double
//   precision and float polynomials (sincos_reduced), which has no
//   local-memory slow path;
// - the capture entry writes the per-epoch rows straight into the
//   capture-wide outputs and ping-pongs the state between two buffers, so
//   a segment costs two launches per chunk and nothing else.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false,
// WITHOUT --use_fast_math, so atan2f / log10f keep full float32 accuracy
// and products round op by op like the plain version.

#include "chunk_corr.cuh"
#include "loop_close.cuh"
#include "rows.cuh"

// sin and cos of x: n = rint(x * 2/pi), r = x - n pi/2 in double
// (fdlibm's 33-bit pi/2 head, exact products for |x| < 2^20 pi/2), then the
// Cephes float polynomials on [-pi/4, pi/4]; <= 1.5 ulp from the true
// values.  Beyond ~1.6e6 rad the reduction loses accuracy; the chain's
// phase differences stay within a few radians.
__device__ __forceinline__ void sincos_reduced(float x, float* s, float* c) {
    const double xd = (double)x;
    const double n = rint(xd * 0.63661977236758134308);
    double r = fma(-n, 1.57079632673412561417e+00, xd);
    r = fma(-n, 6.07710050650619224932e-11, r);
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

template <int K, int ORDER, bool SEC_DATA, bool HAS_SEC>
__global__ void __launch_bounds__(32)
track_chain_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                   const int* __restrict__ s_reg,
                   const float* __restrict__ step0_p,
                   const float* __restrict__ sec_rows,
                   const float* __restrict__ fst, const int* __restrict__ ist,
                   float* __restrict__ out_f, int* __restrict__ out_i,
                   float* __restrict__ out_corr, float* __restrict__ fst_out,
                   int* __restrict__ ist_out, const ChainParams p) {
    extern __shared__ __align__(16) float ch_smem[];
    const int c = blockIdx.x;
    const int C = p.C;
    const int LW = p.LW;
    const int ELW = p.E * LW;
    float* zr_s = ch_smem;                             // [E, LW]
    float* zi_s = ch_smem + ELW;                       // [E, LW]
    int* sreg_s = reinterpret_cast<int*>(ch_smem + 2 * ELW);   // [E]
    float* sec_s = ch_smem + 2 * ELW + p.E;            // [sec_len]

    // ---- stage the channel's chunk in shared memory: every lane starts
    //      its asynchronous copies, then the state loads below overlap
    //      them ----
    {
        const float* zr_c = zr + (size_t)c * ELW;
        const float* zi_c = zi + (size_t)c * ELW;
        for (int i = threadIdx.x; i < ELW; i += 32) {
            cp_async4(zr_s + i, zr_c + i);
            cp_async4(zi_s + i, zi_c + i);
        }
        for (int i = threadIdx.x; i < p.E; i += 32)
            cp_async4(sreg_s + i, s_reg + c * p.E + i);
        asm volatile("cp.async.commit_group;\n" ::);
        if (HAS_SEC)
            for (int i = threadIdx.x; i < p.sec_len; i += 32)
                sec_s[i] = sec_rows[i * C + c];
    }

    // ---- load state (rows of [ROWS, C]) ----
    LoopState<K> st;
    load_state<K>(st, fst, ist, C, c);
    const float step0 = step0_p[c];
    asm volatile("cp.async.wait_all;\n" ::);
    __syncwarp();
    if (threadIdx.x != 0) return;

    // wide/narrow constant select, fixed per channel for the chunk
    const LoopConsts lc = loop_consts(p, st.mode0);
    float dphi = 0.0f;

    for (int kk = 0; kk < p.E; ++kk) {
        // ---- tap read at the TRUE code phase: linear interpolation
        //      weight max(0, 1-|pos-l|) is non-zero on floor(pos) and
        //      floor(pos)+1 only ----
        const float d_s = (float)(st.start - sreg_s[kk]);
        const float rem_eff = (d_s + st.rem_code)
                              * (1.0f + st.delta / p.chip_rate);
        const float* zr_k = zr_s + kk * LW;
        const float* zi_k = zi_s + kk * LW;
        float taps_r[K], taps_i[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float pos = (p.lag_margin + rem_eff) - p.shift_samp[k];
            const float fl = floorf(pos);
            const int l0 = (int)fl;
            float tr = 0.0f, ti = 0.0f;
            if (l0 >= 0 && l0 < LW) {
                const float w = 1.0f - (pos - fl);
                tr += zr_k[l0] * w;
                ti += zi_k[l0] * w;
            }
            if (l0 + 1 >= 0 && l0 + 1 < LW) {
                const float w = 1.0f - ((fl + 1.0f) - pos);
                tr += zr_k[l0 + 1] * w;
                ti += zi_k[l0 + 1] * w;
            }
            taps_r[k] = tr;
            taps_i[k] = ti;
        }

        // ---- rotate into the true-NCO frame ----
        const float step_true = TWO_PI_F * (st.doppler + st.carr_off) / p.fs;
        const float dphi_mid = dphi + (step_true - step0) * 0.5f
                                      * (float)st.cur_len;
        float rs, rc;
        sincos_reduced(dphi_mid, &rs, &rc);
        float corr_r[K], corr_i[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            corr_r[k] = taps_r[k] * rc + taps_i[k] * rs;
            corr_i[k] = taps_i[k] * rc - taps_r[k] * rs;
        }

        // ---- loop closure (loop_close.cuh) ----
        float s = 1.0f;
        if (HAS_SEC) {
            if (st.sec_on_i > 0) s = sec_s[min(st.sec_idx, p.sec_len - 1)];
        } else {
            if (st.sec_on_i > 0) s = sec_rows[c];
        }
        const int cur_len0 = st.cur_len;
        const bool valid = loop_close<K, ORDER, SEC_DATA>(
            p, lc, st, corr_r, corr_i, s,
            out_f + (size_t)kk * N_OROWS * C + c,
            out_i + (size_t)kk * 2 * C + c,
            out_corr + (size_t)kk * 2 * K * C + c, C);

        // --- frozen-vs-true phase ledger (the carried Doppler and length
        //     are the epoch's merged ones) ---
        const float step_new = TWO_PI_F * (st.doppler + st.carr_off) / p.fs;
        const float dphi_next = (dphi + step_new * (float)st.cur_len)
                                - step0 * (float)cur_len0;
        if (valid) dphi = mod_floor(dphi_next + PI_F, TWO_PI_F) - PI_F;
    }

    // ---- store state ----
    store_state<K>(st, fst_out, ist_out, C, c);
}

typedef void (*ChainKernel)(const float*, const float*, const int*,
                            const float*, const float*, const float*,
                            const int*, float*, int*, float*, float*, int*,
                            const ChainParams);

// The template instance for a spec (K, order, sec_data, sec_len > 1), or
// null when the kernel does not take the spec.
static ChainKernel chain_kernel_for(const ChainParams& p) {
#define CH_PICK(KV, OV)                                                     \
    if (p.sec_data) return p.sec_len > 1                                    \
        ? track_chain_kernel<KV, OV, true, true>                            \
        : track_chain_kernel<KV, OV, true, false>;                          \
    return p.sec_len > 1 ? track_chain_kernel<KV, OV, false, true>          \
                         : track_chain_kernel<KV, OV, false, false>;
    if (p.P != p.K / 2) return nullptr;
    if (p.K == 3 && p.order == 3) { CH_PICK(3, 3) }
    if (p.K == 3 && p.order == 2) { CH_PICK(3, 2) }
    if (p.K == 5 && p.order == 3) { CH_PICK(5, 3) }
    if (p.K == 5 && p.order == 2) { CH_PICK(5, 2) }
#undef CH_PICK
    return nullptr;
}

static inline size_t chain_smem_bytes(const ChainParams& p) {
    return sizeof(float) * (2 * (size_t)p.E * p.LW + p.E + p.sec_len);
}

// The chain kernel, checked, and the launch attribute for its dynamic
// shared memory (needed above 48 KB).
static cudaError_t chain_prepare(const ChainParams& p, ChainKernel* kernel) {
    *kernel = chain_kernel_for(p);
    if (*kernel == nullptr) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(*kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)chain_smem_bytes(p));
}

static inline cudaError_t chain_enqueue(
    ChainKernel kernel, const ChainParams& p, const void* zr, const void* zi,
    const void* s_reg, const void* step0, const void* sec_rows,
    const void* fst, const void* ist, void* out_f, void* out_i,
    void* out_corr, void* fst_out, void* ist_out, cudaStream_t s) {
    kernel<<<p.C, 32, chain_smem_bytes(p), s>>>(
        (const float*)zr, (const float*)zi, (const int*)s_reg,
        (const float*)step0, (const float*)sec_rows, (const float*)fst,
        (const int*)ist, (float*)out_f, (int*)out_i, (float*)out_corr,
        (float*)fst_out, (int*)ist_out, p);
    return cudaGetLastError();
}

extern "C" int chunk_corr_launch(
    const void* x, int n_samp, const void* rows, const void* slot,
    const void* fst, const void* ist, void* zr, void* zi, void* s_reg,
    void* step0, const CorrParams* params, void* stream) {
    const CorrParams p = *params;
    cudaError_t err = chunk_corr_prepare(p);
    if (err != cudaSuccess) return (int)err;
    return (int)chunk_corr_enqueue(p, x, n_samp, rows, slot, fst, ist, zr,
                                   zi, s_reg, step0,
                                   reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int track_chain_launch(
    const void* zr, const void* zi, const void* s_reg, const void* step0,
    const void* sec_rows, const void* fst, const void* ist, void* out_f,
    void* out_i, void* out_corr, void* fst_out, void* ist_out,
    const ChainParams* params, void* stream) {
    const ChainParams p = *params;
    ChainKernel kernel;
    cudaError_t err = chain_prepare(p, &kernel);
    if (err != cudaSuccess) return (int)err;
    return (int)chain_enqueue(kernel, p, zr, zi, s_reg, step0, sec_rows, fst,
                              ist, out_f, out_i, out_corr, fst_out, ist_out,
                              reinterpret_cast<cudaStream_t>(stream));
}

// Every chunk of a capture segment: chunk i's correlator and chain read the
// state of chunk i - 1 (the input state for i = 0) and the chain writes
// chunk i's state into ping-pong buffer i % 2 and its per-epoch rows at
// epoch offset i * E of the capture-wide outputs.  Enqueues 2 * n_chunks
// launches on `stream`, checks each, never synchronises and allocates
// nothing; returns the first error.
extern "C" int track_capture_launch(
    int n_chunks, const void* x, int n_samp, const void* rows,
    const void* slot, const void* sec_rows, const void* fst_in,
    const void* ist_in, void* fst_a, void* ist_a, void* fst_b, void* ist_b,
    void* zr, void* zi, void* s_reg, void* step0, void* out_f, void* out_i,
    void* out_corr, const CorrParams* corr_params,
    const ChainParams* chain_params, void* stream) {
    const CorrParams cp = *corr_params;
    const ChainParams p = *chain_params;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    ChainKernel kernel;
    cudaError_t err = chunk_corr_prepare(cp);
    if (err == cudaSuccess) err = chain_prepare(p, &kernel);
    if (err != cudaSuccess) return (int)err;
    void* fst_buf[2] = {fst_a, fst_b};
    void* ist_buf[2] = {ist_a, ist_b};
    const size_t f_stride = (size_t)p.E * N_OROWS * p.C;
    const size_t i_stride = (size_t)p.E * 2 * p.C;
    const size_t c_stride = (size_t)p.E * 2 * p.K * p.C;
    for (int i = 0; i < n_chunks; ++i) {
        const void* f_cur = i == 0 ? fst_in : fst_buf[(i - 1) % 2];
        const void* i_cur = i == 0 ? ist_in : ist_buf[(i - 1) % 2];
        err = chunk_corr_enqueue(cp, x, n_samp, rows, slot, f_cur, i_cur, zr,
                                 zi, s_reg, step0, s);
        if (err != cudaSuccess) return (int)err;
        err = chain_enqueue(kernel, p, zr, zi, s_reg, step0, sec_rows, f_cur,
                            i_cur, (float*)out_f + i * f_stride,
                            (int*)out_i + i * i_stride,
                            (float*)out_corr + i * c_stride, fst_buf[i % 2],
                            ist_buf[i % 2], s);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
