// Fused 3DG adjacency: similarity -> min-max stats -> adjacency, with the
// similarity V = U·Uᵀ never written to device memory.
//
// Replaces repro/kernels/graph_fused.py `_fused_kernel` /
// `fused_adjacency_pallas` (a two-phase sequential TPU grid whose phase-0
// stats sit in a resident accumulator block).  CUDA blocks run in no order,
// so the two phases are two launches:
//   pass 1  computes every 64x64 V tile and folds its min/max into two
//           global keys with atomicMin/atomicMax on the order-preserving
//           uint32 encoding (common.cuh).  min and max are associative, so
//           lo/hi are exact whatever the block order.
//   pass 2  recomputes each V tile (the features are small: recomputing is
//           cheaper than a round trip of the (N, N) V through memory) and
//           writes R = 0 on the diagonal, exp(-Vn/σ²) where Vn ≥ eps, inf
//           elsewhere.
// V accumulates in ascending k as acc = acc + u_ik·u_jk with two IEEE
// roundings (__fmul_rn, __fadd_rn: no FMA contraction).  That is the op
// order of the plain version (`kernels/ref.similarity_ref`), so V, lo and hi
// are bitwise equal to it, and so is R's inf pattern at any N.  The tile
// product and the epilogue live in common.cuh, shared with the staged
// kernels (pairwise_similarity.cu), so the fused R is bitwise the staged R.
//
// What bounds it on the card: the 2·N²·d multiply-adds of the product (the
// bytes are only U in and R out).  Each thread keeps a 4x4 register tile and
// reads its operands from shared memory in chunks of 16 columns of U.
#include "common.cuh"

namespace {

using fedgs::RT;
using fedgs::TD;
using fedgs::TILE;
using fedgs::tile_dot;

__global__ void stats_kernel(const float* __restrict__ u, int n, int d,
                             int clamp, uint32_t* __restrict__ keys) {
    const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
    float acc[RT][RT];
    tile_dot(u, n, d, i0, j0, acc);
    uint32_t lo = 0xffffffffu, hi = 0u;
    for (int a = 0; a < RT; ++a)
        for (int b = 0; b < RT; ++b) {
            const int i = i0 + threadIdx.y + TD * a;
            const int j = j0 + threadIdx.x + TD * b;
            if (i < n && j < n) {
                float v = acc[a][b];
                if (clamp) v = fmaxf(v, 0.0f);
                const uint32_t k = fedgs::f2key(v);
                lo = min(lo, k);
                hi = max(hi, k);
            }
        }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    __shared__ uint32_t slo[8], shi[8];
    const int tid = threadIdx.y * TD + threadIdx.x;
    if ((tid & 31) == 0) { slo[tid >> 5] = lo; shi[tid >> 5] = hi; }
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < 8; ++w) { lo = min(lo, slo[w]); hi = max(hi, shi[w]); }
        atomicMin(&keys[0], lo);
        atomicMax(&keys[1], hi);
    }
}

__global__ void adjacency_kernel(const float* __restrict__ u, int n, int d,
                                 int clamp, float eps, float sigma2,
                                 const uint32_t* __restrict__ keys,
                                 float* __restrict__ r,
                                 float* __restrict__ stats) {
    const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
    const float lo = fedgs::key2f(keys[0]), hi = fedgs::key2f(keys[1]);
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
        stats[0] = lo;
        stats[1] = hi;
    }
    float acc[RT][RT];
    tile_dot(u, n, d, i0, j0, acc);
    const float range = fmaxf(__fsub_rn(hi, lo), 1e-12f);
    for (int a = 0; a < RT; ++a)
        for (int b = 0; b < RT; ++b) {
            const int i = i0 + threadIdx.y + TD * a;
            const int j = j0 + threadIdx.x + TD * b;
            if (i >= n || j >= n) continue;
            float v = acc[a][b];
            if (clamp) v = fmaxf(v, 0.0f);
            r[(size_t)i * n + j] = fedgs::adjacency_entry(v, lo, range, eps,
                                                          sigma2, i == j);
        }
}

}  // namespace

// u (n, d) f32 row-major; r (n, n) f32 out; keys: 2 uint32 of scratch;
// stats (2,) f32 out = [lo, hi].  Returns cudaGetLastError().
extern "C" int fused_adjacency_launch(const float* u, int n, int d, int clamp,
                                      float eps, float sigma2, float* r,
                                      uint32_t* keys, float* stats,
                                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaMemsetAsync(keys, 0xff, sizeof(uint32_t), s);          // lo: max key
    cudaMemsetAsync(keys + 1, 0x00, sizeof(uint32_t), s);      // hi: min key
    const dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE);
    const dim3 block(TD, TD);
    stats_kernel<<<grid, block, 0, s>>>(u, n, d, clamp, keys);
    adjacency_kernel<<<grid, block, 0, s>>>(u, n, d, clamp, eps, sigma2, keys, r, stats);
    return static_cast<int>(cudaGetLastError());
}
