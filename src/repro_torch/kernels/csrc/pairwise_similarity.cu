// The staged 3DG kernels: the similarity V = U·Uᵀ, and the adjacency
// epilogue V -> R.
//
// Replaces repro/kernels/pairwise_similarity.py `_sim_kernel` /
// `similarity_pallas` (a tiled MXU matmul whose output block accumulates
// across the sequential k axis of the grid) and `_adj_kernel` /
// `adjacency_pallas` (an elementwise epilogue with host-supplied
// [lo, hi, eps, σ²]).  The staged route writes V and R to device memory
// between the stages: it serves `similarity="precomputed"` (V given, no
// features: SSPP's V, or a user's), the callers that need V, and it is the
// parity oracle of the fused kernel (graph_fused.cu).
//
// similarity: one 64 x 64 tile of V per block, through common.cuh's
//   tile_dot.  A loop over k inside the block takes the place of the
//   TPU's sequential k grid axis.  The sum runs in ascending k, mul then add
//   with two IEEE roundings (no FMA, no TF32, no cuBLAS): the op order of
//   the fused kernel and of `kernels/ref.similarity_ref`, so V is bitwise
//   theirs.  What bounds it: the N²·d multiply-adds (the bytes are U in and
//   V out).
// adjacency: one thread per entry, common.cuh's adjacency_entry (the fused
//   kernel's epilogue), with lo/hi read from a device buffer (reduced by
//   the caller, no host sync).  Given the same V and lo/hi, R is bitwise the
//   fused kernel's.  What bounds it: the bytes, V in and R out.
#include "common.cuh"

namespace {

using fedgs::RT;
using fedgs::TD;
using fedgs::TILE;

__global__ void similarity_kernel(const float* __restrict__ u, int n, int d,
                                  float* __restrict__ v) {
    const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
    float acc[RT][RT];
    fedgs::tile_dot(u, n, d, i0, j0, acc);
    for (int a = 0; a < RT; ++a)
        for (int b = 0; b < RT; ++b) {
            const int i = i0 + threadIdx.y + TD * a;
            const int j = j0 + threadIdx.x + TD * b;
            if (i < n && j < n) v[(size_t)i * n + j] = acc[a][b];
        }
}

// stats (2,) = [lo, hi] on the device.  Rows stride over gridDim.y.
__global__ void adjacency_kernel(const float* __restrict__ v, int n,
                                 const float* __restrict__ stats, float eps,
                                 float sigma2, float* __restrict__ r) {
    const float lo = stats[0], hi = stats[1];
    const float range = fmaxf(__fsub_rn(hi, lo), 1e-12f);
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    for (int i = blockIdx.y; i < n; i += gridDim.y) {
        const size_t f = (size_t)i * n + j;
        r[f] = fedgs::adjacency_entry(v[f], lo, range, eps, sigma2, i == j);
    }
}

}  // namespace

// u (n, d) f32 row-major; v (n, n) f32 out.  Returns cudaGetLastError().
extern "C" int similarity_launch(const float* u, int n, int d, float* v,
                                 void* stream) {
    const dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE);
    const dim3 block(TD, TD);
    similarity_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        u, n, d, v);
    return static_cast<int>(cudaGetLastError());
}

// v (n, n) f32 raw similarity; stats (2,) f32 = [lo, hi] on the device;
// r (n, n) f32 out.  Returns cudaGetLastError().
extern "C" int adjacency_launch(const float* v, int n, const float* stats,
                                float eps, float sigma2, float* r,
                                void* stream) {
    const int threads = 256;
    const dim3 grid((n + threads - 1) / threads, n < 65535 ? n : 65535);
    adjacency_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        v, n, stats, eps, sigma2, r);
    return static_cast<int>(cudaGetLastError());
}
