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
// one block per (query tile of 64 rows, query head, batch row) loops over
// 64-key tiles from the first key any of its rows sees, max(0, q0 − window
// + 1), to its last row.  A tile that none of a warp's rows sees is
// skipped, and masked keys get p = 0 exactly (`expf`, no fast math), so a
// masked key never enters a sum and the Pallas kernel's reliance on
// exp(−1e30 − m) underflowing to 0 never arises.  The ragged edges (S not a
// multiple of 64, a window that is not a multiple of the tile) are masked
// in the kernel; nothing is padded.  Scores, the softmax and the
// accumulator are f32; the output is acc / max(l, 1e-30), cast once to the
// input dtype.
//
// What bounds it on the card: 4·B·Hq·D·P operations over P visible pairs
// per (b, h), against 2·elt·B·S·(Hq + Hkv)·D bytes; at the prefill shapes of
// the LM serving path, the operations.  Two bodies:
//
// * bf16 with D <= 128 (the LM's prefill): the tensor cores, FlashAttention-2
//   style, `mma.sync.m16n8k16` bf16 -> f32.  Four warps, each owning 16 query
//   rows whose Q fragments stay in registers for the whole loop.  K and V
//   tiles stay bf16 in shared memory (rows padded by 16 bytes so `ldmatrix`
//   hits distinct banks), loaded with `cp.async` 16 bytes a thread into a
//   two-stage ring, so the next tile streams in while this one is used.
//   S = Q·Kᵀ runs on the tensor cores (K fragments by `ldmatrix`); the
//   online softmax works on the accumulator fragments (row max and sum by
//   quad shuffles).  P·V runs on the tensor cores too (V fragments by
//   `ldmatrix.trans`), with p in f32 split into three bf16 terms,
//   hi = bf16(p), mid = bf16(p − hi), lo = bf16(p − hi − mid), each an MMA
//   into the same f32 accumulator: that carries p to about 24 bits, as the
//   plain version's f32 p.  Two terms (about 16 bits) are not enough: a
//   near-zero output with few keys then misses the one-ulp bf16 gate
//   (tests/test_torch_lm.py holds both facts on the CPU).  Rounding p to
//   bf16 once, as `repro`'s `attend_dense` does, is not what the plain
//   version or the Pallas kernel compute, and is not done.
// * f32, and bf16 with D > 128: the CUDA cores.  Eight warps, each owning 8
//   query rows one at a time; K and V staged in shared memory as f32; each
//   lane scores two keys, the warp folds the tile max and the sum of
//   p = exp(s − m_new) with shuffles and adds Σ_j p_j v_j with p in f32.
//   bf16 with D > 128 stays here because the tensor-core body's Q and
//   accumulator fragments (D/4 + D/2 registers a thread) would not fit the
//   registers next to the scores.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per staged tile

// ------------------------------------------------------- CUDA-core body
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

// ------------------------------------------------- tensor-core body (bf16)
constexpr int kTcRows = 16;                  // query rows per warp
constexpr int kTcWarps = kBQ / kTcRows;      // 4
constexpr int kTcThreads = kTcWarps * 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros (a key past S)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t r[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) · b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the low element in the low half, as the mma fragments take it
__device__ __forceinline__ uint32_t bf162_u32(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), lane = 4·g + t:
//   A 16x16: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 8+2t..),
//            a3 = (g+8, 8+2t..);
//   B 16x8:  b0 = (k 2t..2t+1, n g), b1 = (k 8+2t.., n g);
//   C 16x8:  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// The C fragments of two adjacent 8-key score tiles are the A fragment of
// the 16-key P tile, so p never leaves the registers.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
window_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int S, int Hq,
                           int Hkv, int window, float scale) {
    static_assert(D % 16 == 0 && D <= 128, "tensor-core body: D % 16, <= 128");
    constexpr int DP = D + 8;                // shared row pitch (elements)
    constexpr int KT = D / 16;               // k-steps of Q·Kᵀ
    constexpr int NT = kBK / 8;              // 8-key score tiles
    constexpr int DT = D / 8;                // 8-wide output tiles
    constexpr int CH = D / 8;                // 16-byte chunks per row
    extern __shared__ __align__(16) unsigned char tc_smem[];
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [2][kBK][DP]
    __nv_bfloat16* vs = ks + 2 * kBK * DP;                           // [2][kBK][DP]

    // grid (Hq, B, query tiles), the last query tile first: under a causal
    // mask the late tiles have the most keys, and starting them first keeps
    // the last wave short
    const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
    const int h = blockIdx.x, b = blockIdx.y;
    const int hk = h / (Hq / Hkv);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int q_end = min(S, q0 + kBQ);      // exclusive
    const int kv_lo = max(0, q0 - window + 1);
    const int64_t q_stride = static_cast<int64_t>(Hq) * D;
    const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
    const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * S * q_stride + static_cast<int64_t>(h) * D;
    const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * S * kv_stride + static_cast<int64_t>(hk) * D;
    const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * S * kv_stride + static_cast<int64_t>(hk) * D;

    // the K and V rows of the tile at key k0 into stage st (zeros past S)
    auto load_tile = [&](int k0, int st) {
        for (int e = tid; e < kBK * CH; e += kTcThreads) {
            const int r = e / CH, c = (e % CH) * 8, key = k0 + r;
            const bool in = key < S;
            const int64_t off = static_cast<int64_t>(in ? key : 0) * kv_stride + c;
            const int so = (st * kBK + r) * DP + c;
            cp_async16(smem_u32(ks + so), kb + off, in ? 16 : 0);
            cp_async16(smem_u32(vs + so), vb + off, in ? 16 : 0);
        }
    };

    // this warp's rows r0 .. r0 + 15; thread rows r0 + g and r0 + g + 8
    const int r0 = q0 + warp * kTcRows;
    const int rows_hi = min(r0 + kTcRows, S) - 1;   // last row in range
    const int row_a = r0 + g, row_b = r0 + g + 8;

    uint32_t qf[KT][4];                      // Q fragments, for the whole loop
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int row = (x & 1) ? row_b : row_a;
            const int col = kk * 16 + (x & 2 ? 8 : 0) + 2 * t;
            qf[kk][x] = row < S ? *reinterpret_cast<const uint32_t*>(
                                      qb + static_cast<int64_t>(row) * q_stride + col)
                                : 0u;
        }
    }

    float acc[DT][4];
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[dn][x] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

    const int ntiles = (q_end - kv_lo + kBK - 1) / kBK;
    load_tile(kv_lo, 0);
    asm volatile("cp.async.commit_group;\n");
    for (int it = 0; it < ntiles; ++it) {
        const int k0 = kv_lo + it * kBK, st = it & 1;
        if (it + 1 < ntiles) load_tile(k0 + kBK, st ^ 1);
        asm volatile("cp.async.commit_group;\n");
        asm volatile("cp.async.wait_group 1;\n");   // this tile has landed
        __syncthreads();
        // warp-uniform: a warp skips a tile none of its rows sees
        const bool seen = r0 < S && k0 <= rows_hi && k0 + kBK - 1 > r0 - window;
        if (seen) {
            const __nv_bfloat16* kt = ks + st * kBK * DP;
            const __nv_bfloat16* vt = vs + st * kBK * DP;
            // S = Q·Kᵀ, 16 rows x 64 keys
            float sc[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int x = 0; x < 4; ++x) sc[nt][x] = 0.0f;
            const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, row
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
                for (int nt = 0; nt < NT; nt += 2) {
                    // matrices: (nt, d lo), (nt, d hi), (nt+1, d lo), (nt+1, d hi)
                    const int key = nt * 8 + (mi >> 1) * 8 + mr;
                    const int col = kk * 16 + (mi & 1) * 8;
                    uint32_t kf[4];
                    ldsm_x4(smem_u32(kt + key * DP + col), kf);
                    mma_bf16(sc[nt], qf[kk], kf[0], kf[1]);
                    mma_bf16(sc[nt + 1], qf[kk], kf[2], kf[3]);
                }
            }
            // scale, mask, the tile's row max.  Warp-uniform: a tile every
            // row of the warp sees whole (all 16 rows < S, every key <= the
            // first row and > the last row − window) needs no mask
            const bool whole = r0 + kTcRows <= S && k0 + kBK - 1 <= r0 &&
                               k0 > r0 + kTcRows - 1 - window;
            float mt_a = -INFINITY, mt_b = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    const int row = (x & 2) ? row_b : row_a;
                    const int key = k0 + nt * 8 + 2 * t + (x & 1);
                    const bool vis = whole || (key <= row && key > row - window);
                    const float sv = vis ? sc[nt][x] * scale : -INFINITY;
                    sc[nt][x] = sv;
                    if (x & 2) mt_b = fmaxf(mt_b, sv); else mt_a = fmaxf(mt_a, sv);
                }
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
                mt_a = fmaxf(mt_a, __shfl_xor_sync(0xffffffffu, mt_a, off));
                mt_b = fmaxf(mt_b, __shfl_xor_sync(0xffffffffu, mt_b, off));
            }
            const float mn_a = fmaxf(m_a, mt_a), mn_b = fmaxf(m_b, mt_b);
            // corr = 0 while a row has seen no key (its acc and l are 0)
            const float corr_a = m_a == -INFINITY ? 0.0f : expf(m_a - mn_a);
            const float corr_b = m_b == -INFINITY ? 0.0f : expf(m_b - mn_b);
            m_a = mn_a;
            m_b = mn_b;
            float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    const float mn = (x & 2) ? mn_b : mn_a;
                    const float sv = sc[nt][x];
                    const float pv = sv == -INFINITY ? 0.0f : expf(sv - mn);
                    sc[nt][x] = pv;
                    if (x & 2) ps_b += pv; else ps_a += pv;
                }
            l_a = l_a * corr_a + ps_a;
            l_b = l_b * corr_b + ps_b;
#pragma unroll
            for (int dn = 0; dn < DT; ++dn) {
                acc[dn][0] *= corr_a;
                acc[dn][1] *= corr_a;
                acc[dn][2] *= corr_b;
                acc[dn][3] *= corr_b;
            }
            // O += P·V, 16 keys per k-step, p in three bf16 terms
#pragma unroll
            for (int j = 0; j < kBK / 16; ++j) {
                uint32_t ph[4], pm[4], pl[4];
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    // a0 = tile 2j (c0, c1), a1 = 2j (c2, c3), a2 = 2j+1 (c0, c1),
                    // a3 = 2j+1 (c2, c3); each term two values, one packed cvt
                    const float p0 = sc[2 * j + (x >> 1)][(x & 1) * 2];
                    const float p1 = sc[2 * j + (x >> 1)][(x & 1) * 2 + 1];
                    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
                    const float r0v = __fsub_rn(p0, __low2float(h));
                    const float r1v = __fsub_rn(p1, __high2float(h));
                    const __nv_bfloat162 m = __floats2bfloat162_rn(r0v, r1v);
                    const __nv_bfloat162 l = __floats2bfloat162_rn(
                        __fsub_rn(r0v, __low2float(m)), __fsub_rn(r1v, __high2float(m)));
                    ph[x] = bf162_u32(h);
                    pm[x] = bf162_u32(m);
                    pl[x] = bf162_u32(l);
                }
#pragma unroll
                for (int dn = 0; dn < DT; dn += 2) {
                    // matrices: (keys lo, dn), (keys hi, dn), (lo, dn+1), (hi, dn+1)
                    const int key = j * 16 + (mi & 1) * 8 + mr;
                    const int col = (dn + (mi >> 1)) * 8;
                    uint32_t vf[4];
                    ldsm_x4_trans(smem_u32(vt + key * DP + col), vf);
                    mma_bf16(acc[dn], ph, vf[0], vf[1]);
                    mma_bf16(acc[dn], pm, vf[0], vf[1]);
                    mma_bf16(acc[dn], pl, vf[0], vf[1]);
                    mma_bf16(acc[dn + 1], ph, vf[2], vf[3]);
                    mma_bf16(acc[dn + 1], pm, vf[2], vf[3]);
                    mma_bf16(acc[dn + 1], pl, vf[2], vf[3]);
                }
            }
        }
        __syncthreads();                     // stage st is free for tile it + 2
    }
    asm volatile("cp.async.wait_all;\n");

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* ob = o + static_cast<int64_t>(b) * S * q_stride + static_cast<int64_t>(h) * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
        const int col = dn * 8 + 2 * t;
        if (row_a < S)
            *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(row_a) * q_stride + col) =
                __floats2bfloat162_rn(acc[dn][0] / den_a, acc[dn][1] / den_a);
        if (row_b < S)
            *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(row_b) * q_stride + col) =
                __floats2bfloat162_rn(acc[dn][2] / den_b, acc[dn][3] / den_b);
    }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int Hq, int Hkv, int window, float scale,
              cudaStream_t stream) {
    const size_t smem = sizeof(__nv_bfloat16) * 2 * 2 * kBK * (D + 8);
    auto kern = window_attention_tc_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(Hq, B, (S + kBQ - 1) / kBQ);
    kern<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        S, Hq, Hkv, window, scale);
    return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Hq, int Hkv, int D, int window, float scale,
                cudaStream_t s) {
    switch (D / 16) {
        case 1: return launch_tc<16>(q, k, v, o, B, S, Hq, Hkv, window, scale, s);
        case 2: return launch_tc<32>(q, k, v, o, B, S, Hq, Hkv, window, scale, s);
        case 3: return launch_tc<48>(q, k, v, o, B, S, Hq, Hkv, window, scale, s);
        case 4: return launch_tc<64>(q, k, v, o, B, S, Hq, Hkv, window, scale, s);
        case 5: return launch_tc<80>(q, k, v, o, B, S, Hq, Hkv, window, scale, s);
        case 6: return launch_tc<96>(q, k, v, o, B, S, Hq, Hkv, window, scale, s);
        case 7: return launch_tc<112>(q, k, v, o, B, S, Hq, Hkv, window, scale, s);
        case 8: return launch_tc<128>(q, k, v, o, B, S, Hq, Hkv, window, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
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

// The CUDA-core body: every D for f32; bf16 reaches it only with D > 128
// (NV >= 5), so its smaller instances are not built.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Hq, int Hkv, int D, int window, float scale,
             cudaStream_t s) {
    const int nv = (D + 31) / 32;
    if constexpr (std::is_same<T, float>::value) {
        switch (nv) {
            case 1: return launch<1, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
            case 2: return launch<2, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
            case 3: return launch<3, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
            case 4: return launch<4, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
            default: break;
        }
    }
    switch (nv) {
        case 5: return launch<5, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 6: return launch<6, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 7: return launch<7, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        case 8: return launch<8, T>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// q (B, S, Hq, D), k/v (B, S, Hkv, D), o (B, S, Hq, D): contiguous, 16-byte
// aligned, all of one dtype (is_bf16: bf16, else f32).  B, S > 0; D a
// multiple of 16 up to 256; Hkv divides Hq; 1 <= window <= S; scale = 1/√D.
// bf16 with D <= 128 takes the tensor-core body, the rest the CUDA cores.
extern "C" int window_attention_launch(const void* q, const void* k,
                                       const void* v, void* o, int B, int S,
                                       int Hq, int Hkv, int D, int window,
                                       float scale, int is_bf16,
                                       void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16 && D <= 128)
        return dispatch_tc(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
    if (is_bf16)
        return dispatch<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
    return dispatch<float>(q, k, v, o, B, S, Hq, Hkv, D, window, scale, s);
}
