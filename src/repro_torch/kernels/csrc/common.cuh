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

}  // namespace fedgs
