// Floyd–Warshall all-pairs shortest paths, in place, one launch per pivot.
//
// Replaces repro/kernels/floyd_warshall.py `_fw_round_kernel` /
// `floyd_warshall_pallas` (a blocked min-plus APSP whose in-round order —
// pivot tile, then pivot panels, then the rest — rests on the TPU's
// sequential grid and resident panel buffers).  CUDA blocks run in no
// order, so this first version takes the design that is bitwise by
// construction: launch k applies h[i][j] = min(h[i][j], h[i][k] + h[k][j])
// to every (i, j), which is exactly `kernels/ref.floyd_warshall_ref`'s op
// order.  In place is race-free: with no negative entry and no NaN,
// h[k][k] ≥ 0, so row k and column k do not change at step k.
//
// What bounds it on the card: at the 3DG sizes the N launches each stream
// the whole (N, N) matrix, so it is bound by memory traffic (N·2·N²·4 bytes
// at N beyond the 50 MB L2) and by launch overhead at small N, far above
// the 2N³ min/add operations the work needs.  A blocked three-phase design
// that keeps tiles in shared memory is later work.
#include "common.cuh"

namespace {

__global__ void fw_pivot_kernel(float* __restrict__ h, int n, int k) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const size_t i = blockIdx.y;
    if (j >= n) return;
    const float c = __fadd_rn(h[i * n + k], h[(size_t)k * n + j]);
    const float cur = h[i * n + j];
    // torch.minimum / jnp.minimum: the smaller, NaN propagating
    if (c < cur || (isnan(c) && !isnan(cur))) h[i * n + j] = c;
}

}  // namespace

// h (n, n) f32 row-major, updated in place.  Returns cudaGetLastError().
extern "C" int floyd_warshall_launch(float* h, int n, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    const dim3 grid((n + threads - 1) / threads, n);
    for (int k = 0; k < n; ++k) {
        fw_pivot_kernel<<<grid, threads, 0, s>>>(h, n, k);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}
