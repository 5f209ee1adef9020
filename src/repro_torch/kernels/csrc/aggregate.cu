// Memory-rectified server aggregation (the `memory` aggregator family):
// scatter the m sampled clients' fresh updates into the (N, P) last-update
// panel, then reduce the panel with the staleness weights, red = w · panel.
//
// Replaces repro/kernels/aggregate.py `_memagg_kernel` / `memagg_pallas`.
// The TPU kernel scatters with a one-hot MXU matmul (plus a second one-hot
// dot that restores non-finite entries as NaN) and carries the reduction
// in a revisited accumulator block across a sequential grid.  Here the
// scatter is a direct row copy: a copy moves a NaN or an inf into its own
// row and nowhere else, which is the reference's containment rule with no
// second dot, and the panel is bitwise the plain scatter's.
//
// Design: a grid over P column tiles of 32 columns; a block of 32 x 8
// threads owns its 32 columns completely.  Thread (c, g) copies the
// updates k = g, g + 8, ... into their rows, the block syncs, then thread
// (c, g) sums rows n = g, g + 8, ... of column c in ascending order and
// the 8 partial sums meet in shared memory in ascending g.  The order of
// every sum is fixed, so `red` repeats bit for bit from run to run.  One
// launch per round; the post-scatter panel is read once, by the block
// that wrote it, out of L2.
//
// What bounds it on the card: bytes.  The panel is read and written once
// (4·N·P each way at most) against 2·N·P operations; at the main path's
// sizes it is launch latency.  The panel is updated in place.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;     // panel columns per block (one warp wide)
constexpr int kGroups = 8;    // row groups per block

__global__ void memagg_kernel(float* __restrict__ mem,
                              const float* __restrict__ upd,
                              const int64_t* __restrict__ sel,
                              const uint8_t* __restrict__ valid,
                              const float* __restrict__ w, int n, int p,
                              int m, float* __restrict__ red) {
    __shared__ float part[kGroups][kCols];
    const int c = blockIdx.x * kCols + threadIdx.x;
    const int g = threadIdx.y;
    const bool col_ok = c < p;

    // 1. scatter: invalid slots and rows outside [0, n) are skipped
    if (col_ok) {
        for (int k = g; k < m; k += kGroups) {
            const int64_t row = sel[k];
            if (valid[k] && row >= 0 && row < n)
                mem[row * p + c] = upd[static_cast<int64_t>(k) * p + c];
        }
    }
    __syncthreads();

    // 2. reduce: rows g, g + 8, ... ascending, then the groups ascending
    float acc = 0.0f;
    if (col_ok) {
#pragma unroll 4
        for (int r = g; r < n; r += kGroups)
            acc = fmaf(w[r], mem[static_cast<int64_t>(r) * p + c], acc);
    }
    part[g][threadIdx.x] = acc;
    __syncthreads();
    if (g == 0 && col_ok) {
        float s = part[0][threadIdx.x];
#pragma unroll
        for (int q = 1; q < kGroups; ++q) s += part[q][threadIdx.x];
        red[c] = s;
    }
}

}  // namespace

// mem (n, p) f32, updated in place; upd (m, p) f32; sel (m,) int64 target
// rows; valid (m,) bool; w (n,) f32; red (p,) f32 out.  p > 0.
extern "C" int memagg_launch(float* mem, const float* upd, const int64_t* sel,
                             const uint8_t* valid, const float* w, int n,
                             int p, int m, float* red, void* stream) {
    const dim3 block(kCols, kGroups);
    const dim3 grid((p + kCols - 1) / kCols);
    memagg_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        mem, upd, sel, valid, w, n, p, m, red);
    return static_cast<int>(cudaGetLastError());
}
