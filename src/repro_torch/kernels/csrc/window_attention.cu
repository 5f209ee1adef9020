// Causal sliding-window attention with an online softmax:
//     o_i = Σ_j softmax_j(q_i · k_j / √D) · v_j   over  i − window < j ≤ i
// q (B, S, Hq, D), k and v (B, S, Hkv, D), bf16 or f32; query head h reads
// KV head h / (Hq / Hkv) (GQA without materializing the repeat).  Full
// causal attention is window = S.
//
// Replaces repro/kernels/window_attention.py `_wa_kernel` /
// `window_attention_pallas`.  The TPU kernel walks the KV blocks of one
// query block along a sequential grid axis and carries the accumulator,
// the running max and the denominator in VMEM scratch from step to step.
// CUDA blocks run in no order, so here that axis is a loop inside the block:
//   * one block per (query tile of 64 rows, query head, batch row), 8 warps;
//     each warp owns 8 query rows and keeps their running max m, denominator
//     l and accumulator (D values spread over the lanes, NV = ceil(D/32) per
//     lane) in registers;
//   * the block loops over 64-key tiles from the first key any of its rows
//     sees, max(0, q0 − window + 1), to its last row; each tile of K and V
//     is staged in shared memory as f32 (K rows padded by one word so the
//     lanes' dot products hit distinct banks);
//   * per row and tile: each lane scores two keys (a dot product over D,
//     then · 1/√D), the warp folds the tile max and the sum of
//     p = exp(s − m_new) with shuffles, rescales l and the accumulator by
//     exp(m − m_new), and adds Σ_j p_j v_j with p kept in f32 (V read in f32,
//     as `_wa_kernel` does).  A row skips a tile it cannot see, so a masked
//     key never enters a sum: p is exactly 0 there, and the Pallas kernel's
//     reliance on exp(−1e30 − m) underflowing to 0 never arises;
//   * the output is acc / max(l, 1e-30), cast once to the input dtype.
// The ragged edges (S not a multiple of 64, a window that is not a multiple
// of the tile) are masked in the kernel; nothing is padded.  Scores, the
// softmax and the accumulator are IEEE f32 with `expf` (no fast math).
//
// What bounds it on the card: 4·B·Hq·D·P operations over P visible pairs
// per (b, h), against 2·elt·B·S·(Hq + Hkv)·D bytes.  At the prefill shapes
// of the LM serving path it is the operations; this first version runs them
// on the CUDA cores out of shared memory (no tensor cores, TMA or wgmma).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per staged tile (2 per lane)
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// NV = ceil(D / 32): accumulator entries per lane (lane + 32·c, c < NV).
template <int NV, typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int S,
                        int Hq, int Hkv, int D, int window, float scale) {
    constexpr int DV = NV * 32;            // V row stride in shared memory
    extern __shared__ float smem[];
    const int KS = D + 1;                  // K row stride (odd: no conflicts)
    float* qs = smem;                      // (kBQ, D)
    float* ks = qs + kBQ * D;              // (kBK, D + 1)
    float* vs = ks + kBK * KS;             // (kBK, DV), zero past D
    float* ps = vs + kBK * DV;             // (kWarps, kBK)

    const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q_end = min(S, q0 + kBQ);    // exclusive
    const int kv_lo = max(0, q0 - window + 1);
    const int64_t q_stride = static_cast<int64_t>(Hq) * D;
    const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
    const T* qb = q + (static_cast<int64_t>(b) * S) * q_stride + static_cast<int64_t>(h) * D;
    const T* kb = k + (static_cast<int64_t>(b) * S) * kv_stride + static_cast<int64_t>(hk) * D;
    const T* vb = v + (static_cast<int64_t>(b) * S) * kv_stride + static_cast<int64_t>(hk) * D;

    for (int e = tid; e < kBQ * D; e += kThreads) {
        const int r = e / D, c = e % D;
        qs[e] = (q0 + r < S) ? to_f(qb[(q0 + r) * q_stride + c]) : 0.0f;
    }

    float m[kRows], l[kRows], acc[kRows][NV];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < NV; ++c) acc[r][c] = 0.0f;
    }
    float* pw = ps + warp * kBK;

    for (int k0 = kv_lo; k0 < q_end; k0 += kBK) {
        __syncthreads();                   // the previous tile is consumed
        for (int e = tid; e < kBK * DV; e += kThreads) {
            const int r = e / DV, c = e % DV, key = k0 + r;
            const bool in = key < S && c < D;
            const int64_t off = key * kv_stride + c;
            if (c < D) ks[r * KS + c] = in ? to_f(kb[off]) : 0.0f;
            vs[e] = in ? to_f(vb[off]) : 0.0f;
        }
        __syncthreads();
        const int nk = min(kBK, q_end - k0);   // keys past q_end see no row
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int row = warp * kRows + r, i = q0 + row;
            // warp-uniform: skip rows past S and tiles outside the row's span
            if (i >= S || k0 > i || k0 + kBK - 1 <= i - window) continue;
            const float* qr = qs + row * D;
            const float* k0r = ks + lane * KS;
            const float* k1r = ks + (lane + 32) * KS;
            float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) {
                const float qd = qr[d];
                s0 = fmaf(qd, k0r[d], s0);
                s1 = fmaf(qd, k1r[d], s1);
            }
            const int j0 = k0 + lane, j1 = k0 + lane + 32;
            const bool vis0 = j0 <= i && j0 > i - window;
            const bool vis1 = j1 <= i && j1 > i - window;
            s0 = vis0 ? s0 * scale : -INFINITY;
            s1 = vis1 ? s1 * scale : -INFINITY;
            const float mt = warp_max(fmaxf(s0, s1));
            if (mt == -INFINITY) continue;     // no visible key in this tile
            const float m_new = fmaxf(m[r], mt);
            const float corr = expf(m[r] - m_new);   // 0 on the first tile
            const float p0 = vis0 ? expf(s0 - m_new) : 0.0f;
            const float p1 = vis1 ? expf(s1 - m_new) : 0.0f;
            l[r] = l[r] * corr + warp_sum(p0 + p1);
            m[r] = m_new;
            pw[lane] = p0;
            pw[lane + 32] = p1;
            __syncwarp();
#pragma unroll
            for (int c = 0; c < NV; ++c) acc[r][c] *= corr;
            for (int j = 0; j < nk; ++j) {
                const float pj = pw[j];
                const float* vr = vs + j * DV + lane;
#pragma unroll
                for (int c = 0; c < NV; ++c)
                    acc[r][c] = fmaf(pj, vr[32 * c], acc[r][c]);
            }
            __syncwarp();                      // pw is rewritten by the next row
        }
    }

    T* ob = o + (static_cast<int64_t>(b) * S) * q_stride + static_cast<int64_t>(h) * D;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int i = q0 + warp * kRows + r;
        if (i >= S) continue;
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
            const int d = lane + 32 * c;
            if (d < D) store(ob + i * q_stride + d, acc[r][c] / den);
        }
    }
}

template <int NV, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int D, int window, float scale,
           cudaStream_t stream) {
    const size_t smem = sizeof(float) *
        (static_cast<size_t>(kBQ) * D + static_cast<size_t>(kBK) * (D + 1) +
         static_cast<size_t>(kBK) * NV * 32 + kWarps * kBK);
    auto kern = window_attention_kernel<NV, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, D, window,
        scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Hq, int Hkv, int D, int window, float scale,
             cudaStream_t s) {
    switch ((D + 31) / 32) {
        case 1: return launch<1, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 2: return launch<2, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 3: return launch<3, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 4: return launch<4, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 5: return launch<5, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 6: return launch<6, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 7: return launch<7, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 8: return launch<8, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// q (B, S, Hq, D), k/v (B, S, Hkv, D), o (B, S, Hq, D): contiguous, all of
// one dtype (is_bf16: bf16, else f32).  B, S > 0; D a multiple of 16 up to
// 256; Hkv divides Hq; window >= 1; scale = 1/√D.
extern "C" int window_attention_launch(const void* q, const void* k,
                                       const void* v, void* o, int B, int S,
                                       int Hq, int Hkv, int D, int window,
                                       float scale, int is_bf16,
                                       void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return dispatch<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
    return dispatch<float>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
}
