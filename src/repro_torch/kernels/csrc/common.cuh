// Shared helpers of the FedGS kernels: an order-preserving encoding of
// float32 into uint32, and the (value, lowest index) key packed into uint64.
//
// CUDA blocks run in no order, so a running max carried across a sequential
// grid (the TPU idiom) does not carry over.  Instead every thread folds its
// candidates into one uint64 key
//     (order-preserving uint32 of the value) << 32 | ~index
// and the keys are combined with max (warp shuffles, then atomicMax).  The
// largest key holds the largest value and, among equal values, the LOWEST
// index, whatever the order of the blocks: the jnp.argmax / torch.argmax
// first-max tie-break, exactly.  -0.0 is mapped to +0.0 before encoding (the
// two compare equal in argmax), and callers map NaN to the -1e18 sentinel.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fedgs {

constexpr float NEG = -1e18f;   // the solver's masked-entry sentinel

__device__ __forceinline__ uint32_t f2key(float x) {
    x = (x == 0.0f) ? 0.0f : x;                      // -0.0 -> +0.0
    uint32_t b = __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key2f(uint32_t k) {
    uint32_t b = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
    return __uint_as_float(b);
}

__device__ __forceinline__ uint64_t pack(float v, uint32_t idx) {
    return (static_cast<uint64_t>(f2key(v)) << 32) | static_cast<uint64_t>(~idx);
}

__device__ __forceinline__ float unpack_val(uint64_t key) {
    return key2f(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ uint32_t unpack_idx(uint64_t key) {
    return ~static_cast<uint32_t>(key & 0xffffffffull);
}

__device__ __forceinline__ uint64_t warp_max_u64(uint64_t v) {
    for (int off = 16; off > 0; off >>= 1) {
        uint64_t o = __shfl_xor_sync(0xffffffffu, v, off);
        v = o > v ? o : v;
    }
    return v;
}

// Max of one uint64 per thread over the block; the result is valid in
// thread 0.  blockDim.x must be a multiple of 32 and at most 1024.
__device__ __forceinline__ uint64_t block_max_u64(uint64_t v) {
    __shared__ uint64_t part[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_max_u64(v);
    if (lane == 0) part[warp] = v;
    __syncthreads();
    const int nwarps = blockDim.x >> 5;
    v = (threadIdx.x < nwarps) ? part[threadIdx.x] : 0ull;
    if (warp == 0) v = warp_max_u64(v);
    return v;
}

// ----------------------------------------------- the 3DG summation order
// The summation order of every similarity V = U·Uᵀ in the port: the d
// columns of U fall into chunks of KS consecutive columns; a chunk's
// partial P_c is summed in ascending k as p = p + u_ik·u_jk with two IEEE
// roundings (__fmul_rn, __fadd_rn: no FMA contraction, no TF32), starting
// from 0; V = Σ_c P_c adds the partials in ascending c into an accumulator
// that starts from 0.  `kernels/ref.similarity_ref` (SIM_CHUNK there, held
// equal to KS by a test) sums in this order, and so does every plan of the
// similarity's tile kernels (similarity.cuh: the staged similarity and the
// fused adjacency) and the fused adjacency's small plan, so all their V
// are bitwise equal.  For d <= KS the order is one ascending-k sum.
constexpr int KS = 256;      // columns of U per partial sum

// One entry of the 3DG adjacency from a raw similarity v: Vn = (v − lo) /
// range with range = max(hi − lo, 1e-12), then exp(−Vn/σ²) where Vn ≥ eps,
// inf (no edge) elsewhere, and 0 on the diagonal, chosen by a select (never
// a multiply by 1 − eye, which turns inf into NaN).  IEEE division and
// expf: no fast math, the σ² = 0.01 weights reach the denormal range.
__device__ __forceinline__ float adjacency_entry(float v, float lo,
                                                 float range, float eps,
                                                 float sigma2, bool diag) {
    const float vn = __fdiv_rn(__fsub_rn(v, lo), range);
    const float e = (vn >= eps) ? expf(__fdiv_rn(-vn, sigma2)) : INFINITY;
    return diag ? 0.0f : e;
}

}  // namespace fedgs
