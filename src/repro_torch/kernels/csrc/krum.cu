// Pairwise squared-distance panel of the Krum aggregator:
//     D[i, j] = (||x_i||² + ||x_j||²) − 2 x_i · x_j     over x (m, P) f32.
//
// Replaces repro/kernels/krum.py `_krum_kernel` / `krum_pallas`.  The TPU
// kernel accumulates per-P-tile partials `ri + rj − 2 x xᵀ` in a revisited
// output block across a sequential grid, with the cross term on the MXU.
// Here two launches from one entry point:
//   1. row norms: one warp per row, lanes stride over P, a shuffle tree
//      folds the 32 partials (a fixed order);
//   2. the Gram panel: 64 x 64 output tiles, the x rows of both tiles staged
//      in shared memory 16 columns at a time, each thread accumulating a
//      4 x 4 micro-tile over P in IEEE f32 FMAs (CUDA cores, no TF32), then
//      the epilogue in the plain version's op order.  The panel is
//      symmetric: only tiles with bj >= bi run, and each writes its mirror
//      too, so D is exactly symmetric.
// The cross term is computed in the kernel's own body (no cuBLAS).
//
// What bounds it on the card: m·(m+1)·P operations (the symmetric Gram)
// against 4·(m·P + m²) bytes; at the main path's m = 6 it is launch
// latency.  No split over P yet, so at m = 512 only 36 tiles run.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kDepth = 16;    // P columns staged per step
constexpr int kMicro = 4;     // micro-tile edge per thread (16 x 16 threads)

__global__ void row_norms_kernel(const float* __restrict__ x, int m, int p,
                                 float* __restrict__ nrm) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= m) return;
    const float* xr = x + static_cast<int64_t>(row) * p;
    float s = 0.0f;
    for (int k = lane; k < p; k += 32) s = fmaf(xr[k], xr[k], s);
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) nrm[row] = s;
}

__global__ void krum_gram_kernel(const float* __restrict__ x, int m, int p,
                                 const float* __restrict__ nrm,
                                 float* __restrict__ d) {
    const int bi = blockIdx.y, bj = blockIdx.x;
    if (bj < bi) return;                      // the mirror tile writes it
    __shared__ float as[kDepth][kTile + 1];   // rows of tile i, transposed
    __shared__ float bs[kDepth][kTile + 1];   // rows of tile j, transposed
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * 16 + tx;
    const int i0 = bi * kTile, j0 = bj * kTile;
    float acc[kMicro][kMicro] = {};

    for (int k0 = 0; k0 < p; k0 += kDepth) {
        for (int e = tid; e < kTile * kDepth; e += 256) {
            const int r = e / kDepth, k = e % kDepth, kk = k0 + k;
            const int gi = i0 + r, gj = j0 + r;
            as[k][r] = (gi < m && kk < p) ? x[static_cast<int64_t>(gi) * p + kk] : 0.0f;
            bs[k][r] = (gj < m && kk < p) ? x[static_cast<int64_t>(gj) * p + kk] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
            float a[kMicro], b[kMicro];
#pragma unroll
            for (int q = 0; q < kMicro; ++q) {
                a[q] = as[k][ty * kMicro + q];
                b[q] = bs[k][tx * kMicro + q];
            }
#pragma unroll
            for (int u = 0; u < kMicro; ++u)
#pragma unroll
                for (int v = 0; v < kMicro; ++v)
                    acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        const int gi = i0 + ty * kMicro + u;
        if (gi >= m) continue;
#pragma unroll
        for (int v = 0; v < kMicro; ++v) {
            const int gj = j0 + tx * kMicro + v;
            if (gj >= m) continue;
            // (n_i + n_j) − 2·g, each step rounded (the plain op order)
            const float dv = __fsub_rn(__fadd_rn(nrm[gi], nrm[gj]),
                                       __fmul_rn(2.0f, acc[u][v]));
            d[static_cast<int64_t>(gi) * m + gj] = dv;
            if (bi != bj) d[static_cast<int64_t>(gj) * m + gi] = dv;
        }
    }
}

}  // namespace

// x (m, p) f32; nrm (m,) f32 scratch; d (m, m) f32 out.  m, p > 0.
extern "C" int krum_distances_launch(const float* x, int m, int p, float* nrm,
                                     float* d, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rows_per_block = 8;
    row_norms_kernel<<<(m + rows_per_block - 1) / rows_per_block,
                       32 * rows_per_block, 0, s>>>(x, m, p, nrm);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int tiles = (m + kTile - 1) / kTile;
    krum_gram_kernel<<<dim3(tiles, tiles), dim3(16, 16), 0, s>>>(x, m, p,
                                                                 nrm, d);
    return static_cast<int>(cudaGetLastError());
}
