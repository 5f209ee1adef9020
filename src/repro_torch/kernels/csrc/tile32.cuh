// The 32x32 tile of a Gram product G = U·Uᵀ over chunks of KS columns,
// shared by the similarity's split and serial plans
// (pairwise_similarity.cu) and Krum's split plan (krum.cu).
//
// A block of S_THREADS threads computes one tile (rows i0.., columns j0..)
// of the upper triangle.  tile32_chunks sums chunks [c_lo, c_hi) of U's
// columns: each chunk's partial P_c in ascending k from 0, for the
// similarity with two IEEE roundings per term (__fmul_rn, __fadd_rn: no FMA
// contraction, no TF32; its fixed order), for Krum by FMA (half the
// instructions; Krum fixes no order but its own), and acc = 0 + P_c_lo +
// P_c_lo+1 + ... in ascending c.  The block stages
// half a chunk of its rows at a time in shared memory with cp.async copies
// (16, 8 or 4 bytes, as U's row alignment allows), all in flight at once;
// 128 threads hold a 4x2 register tile each, read as float4 over 4
// columns (33 KB, so 6 blocks share an SM and hide each other's loads),
// and a warp whose columns all lie past n skips the products.
// Zero padding never changes a sum: a padded column is 0 in both operands,
// its product is +0, and a partial that starts at +0 is never -0, so adding
// +0 leaves it bit for bit as it was (NaN and inf too).
#pragma once

#include "common.cuh"

namespace fedgs {
namespace tile32 {

constexpr int ST = 32;               // output tile edge
constexpr int S_THREADS = 128;       // 4 x 2 outputs each
constexpr int SK = 128;              // columns staged at a time (half a chunk)
constexpr int SROW = SK + 4;         // shared row stride in floats: rows 16-byte
                                     // aligned, float4 reads conflict-free
constexpr size_t S_SMEM = 2 * ST * SROW * sizeof(float);   // 33 KB: 6 blocks/SM
static_assert(KS % SK == 0, "a chunk of KS columns is whole stages of SK");

// (ti, tj), ti <= tj, of upper-triangle tile t of an nt x nt tile grid,
// row by row
__device__ __forceinline__ void upper_tile(int t, int nt, int& ti, int& tj) {
    ti = 0;
    while (t >= nt - ti) { t -= nt - ti; ++ti; }
    tj = ti + t;
}

// the index of tile (t, t) in upper_tile's order
__device__ __forceinline__ int diag_tile(int t, int nt) {
    return t * nt - t * (t - 1) / 2;
}

// p + a·b over 4 columns in ascending order: two roundings per term (the
// similarity's order), or one FMA per term
template <bool FMA>
__device__ __forceinline__ float madd4(float p, float4 a, float4 b) {
    if constexpr (FMA) {
        p = fmaf(a.x, b.x, p);
        p = fmaf(a.y, b.y, p);
        p = fmaf(a.z, b.z, p);
        return fmaf(a.w, b.w, p);
    } else {
        p = __fadd_rn(p, __fmul_rn(a.x, b.x));
        p = __fadd_rn(p, __fmul_rn(a.y, b.y));
        p = __fadd_rn(p, __fmul_rn(a.z, b.z));
        return __fadd_rn(p, __fmul_rn(a.w, b.w));
    }
}

// The widest async copy U's row starts allow: 16 bytes, 8 or 4.
inline int copy_width(const float* u, int d) {
    const uintptr_t base = reinterpret_cast<uintptr_t>(u);
    return (d % 4 == 0 && base % 16 == 0) ? 4
         : (d % 2 == 0 && base % 8 == 0) ? 2 : 1;
}

// rows r0 .. r0 + ST - 1 of U, columns [k0, k0 + kc), into dst (ST, SROW),
// zero past n and from kc up to kc4 = kc rounded up to 4, in async copies
// of EL floats (4, 2 or 1: as wide as the alignment of U's rows allows; d
// is any width), all in flight at once; the caller waits
// (cp.async.wait_all) and syncs.
template <int EL>
__device__ __forceinline__ void stage_rows(const float* __restrict__ u, int n,
                                           int d, int r0, int k0, int kc,
                                           int kc4, float* dst) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < ST; r += S_THREADS / 32) {
        const bool rin = r0 + r < n;
        const float* src = u + (size_t)(rin ? r0 + r : 0) * d + k0;
        const uint32_t row = static_cast<uint32_t>(
            __cvta_generic_to_shared(dst + r * SROW));
        for (int k = lane * EL; k < kc4; k += 32 * EL) {
            const int valid = rin ? max(0, min(EL, kc - k)) : 0;
            asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                         :: "r"(row + 4 * k), "l"(src + (valid ? k : 0)),
                            "n"(4 * EL), "r"(4 * valid));
        }
    }
}

// both operands' rows of one stage, with the copy width el (uniform)
__device__ __forceinline__ void stage_tile(const float* __restrict__ u, int n,
                                           int d, int el, int i0, int j0,
                                           bool diag, int k0, int kc,
                                           int kc4, float* as, float* bs) {
    if (el == 4) {
        stage_rows<4>(u, n, d, i0, k0, kc, kc4, as);
        if (!diag) stage_rows<4>(u, n, d, j0, k0, kc, kc4, bs);
    } else if (el == 2) {
        stage_rows<2>(u, n, d, i0, k0, kc, kc4, as);
        if (!diag) stage_rows<2>(u, n, d, j0, k0, kc, kc4, bs);
    } else {
        stage_rows<1>(u, n, d, i0, k0, kc, kc4, as);
        if (!diag) stage_rows<1>(u, n, d, j0, k0, kc, kc4, bs);
    }
}

// Thread (tx, ty) = (tid / 8, tid % 8) holds rows ty + 8*a (a < 4) and
// columns tx + 16*b (b < 2) of the tile: acc[a][b] = G[i0 + ty + 8a][j0 +
// tx + 16b] over chunks [c_lo, c_hi).  A quarter warp reads 8 consecutive
// rows of one operand (distinct banks) and one row of the other (a
// broadcast); warp w holds columns 4w .. 4w + 3 and 16 + 4w .., so a warp
// whose columns all lie past n (the ragged last tile column) skips the
// products.  smem holds S_SMEM bytes; the caller syncs before reusing it.
// FMA false is the similarity's order (mul, then add); Krum takes FMA.
template <bool FMA = false>
__device__ __forceinline__ void tile32_chunks(const float* __restrict__ u,
                                              int n, int d, int el, int i0,
                                              int j0, bool diag, int c_lo,
                                              int c_hi, float* smem,
                                              float acc[4][2]) {
    float* as = smem;
    float* bs = smem + ST * SROW;
    const float* bsrc = diag ? as : bs;
    const int tid = threadIdx.x, tx = tid >> 3, ty = tid & 7;
    const bool live = j0 + 4 * (tid >> 5) < n;    // warp-uniform
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) acc[a][b] = 0.0f;
    for (int c = c_lo; c < c_hi; ++c) {
        float p[4][2];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) p[a][b] = 0.0f;
        for (int k0 = c * KS; k0 < min(d, (c + 1) * KS); k0 += SK) {
            const int kc = min(SK, d - k0), kc4 = (kc + 3) & ~3;
            __syncthreads();                 // the previous stage is consumed
            stage_tile(u, n, d, el, i0, j0, diag, k0, kc, kc4, as, bs);
            asm volatile("cp.async.wait_all;\n");
            __syncthreads();
            if (!live) continue;
#pragma unroll 2
            for (int k = 0; k < kc4; k += 4) {
                float4 av[4], bv[2];
#pragma unroll
                for (int a = 0; a < 4; ++a)
                    av[a] = *reinterpret_cast<const float4*>(as + (ty + 8 * a) * SROW + k);
#pragma unroll
                for (int b = 0; b < 2; ++b)
                    bv[b] = *reinterpret_cast<const float4*>(bsrc + (tx + 16 * b) * SROW + k);
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 2; ++b) p[a][b] = madd4<FMA>(p[a][b], av[a], bv[b]);
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) acc[a][b] = __fadd_rn(acc[a][b], p[a][b]);
    }
}

}  // namespace tile32
}  // namespace fedgs
