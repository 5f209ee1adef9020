// FedGS Eq. 16 solver kernels: the greedy masked argmax, the Q-free
// best-swap reduction and the best swap over a dense Q.
//
// Replaces repro/kernels/solver.py `_masked_argmax_kernel` /
// `masked_argmax_pallas`, `_swap_fused_kernel` (+ `_best_swap_update`) /
// `swap_gain_fused_pallas` and `_swap_gain_kernel` / `swap_gain_pallas`.  The TPU versions carry a running (best, index)
// pair across a sequential grid in resident accumulator blocks.  Here every
// thread folds its candidates into a packed (value, ~index) uint64 key and
// the keys meet by max (common.cuh), which keeps the largest value and its
// LOWEST index in any block order: the reference's first-max tie-break.
//
// What bounds them on the card: both are tiny per call (N floats for the
// greedy step, an m x N panel for the swap), so at the main path's sizes
// they are bound by launch latency, and at large N by reading the H row
// and column panels (bytes).  The greedy step is one block with no padding
// of N.  The swap reads H[sel_r, j] and H[j, sel_r] straight from H (no
// gathered panels; H need not be symmetric) and finishes in the last block
// to arrive, so a call is one memset and one launch.  The dense swap
// (`fedgs_solve`'s route, Q given) reads the selected rows Q[sel_s, :] in
// place instead of a gathered (m, N) panel; it needs no padding, and its
// keys carry the global flat index s·N + j, so the lowest one wins ties as
// in the JAX wrapper (which pads Q with 0 and a, b with -1e18).
//
// Numerics: Q = 0.5·((a·H_sj − δz) + (a·H_js − δz)) and delta =
// (a_s + b_j) − 2Q are written with __fmul_rn / __fadd_rn / __fsub_rn so
// nvcc's default --fmad=true cannot contract a·H − δz into an FMA: the
// result is bitwise the plain version's.
#include "common.cuh"

namespace {

using fedgs::NEG;

__global__ void masked_argmax_kernel(const float* __restrict__ diag,
                                     const float* __restrict__ r,
                                     const uint8_t* __restrict__ mask, int n,
                                     float* __restrict__ out_val,
                                     int64_t* __restrict__ out_idx) {
    uint64_t best = 0ull;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float g = __fadd_rn(diag[i], __fmul_rn(2.0f, r[i]));
        if (!mask[i] || isnan(g)) g = NEG;
        const uint64_t key = fedgs::pack(g, static_cast<uint32_t>(i));
        best = key > best ? key : best;
    }
    best = fedgs::block_max_u64(best);
    if (threadIdx.x == 0) {
        if (n == 0) best = fedgs::pack(NEG, 0u);
        *out_val = fedgs::unpack_val(best);
        *out_idx = static_cast<int64_t>(fedgs::unpack_idx(best));
    }
}

// Fold each block's best key into scratch; the last block to arrive writes
// (value, rank, j) of the winning flat index s·n + j.  scratch: [0] = uint64
// best key, [1] (low half) = uint32 arrival count; zeroed by the launcher.
__device__ __forceinline__ void finish_best(uint64_t best, int n,
                                            unsigned long long* scratch,
                                            float* out_val, int64_t* out_rank,
                                            int64_t* out_j) {
    best = fedgs::block_max_u64(best);
    if (threadIdx.x == 0) {
        atomicMax(&scratch[0], static_cast<unsigned long long>(best));
        __threadfence();
        unsigned int* count = reinterpret_cast<unsigned int*>(&scratch[1]);
        if (atomicAdd(count, 1u) == gridDim.x - 1) {       // last block
            const uint64_t key = atomicMax(&scratch[0], 0ull);
            const uint32_t flat = fedgs::unpack_idx(key);
            *out_val = fedgs::unpack_val(key);
            *out_rank = static_cast<int64_t>(flat / n);
            *out_j = static_cast<int64_t>(flat % n);
        }
    }
}

__global__ void swap_best_kernel(const float* __restrict__ h,
                                 const float* __restrict__ z, float scale,
                                 const int64_t* __restrict__ sel,
                                 const uint8_t* __restrict__ valid,
                                 const float* __restrict__ a,
                                 const float* __restrict__ b, int m, int n,
                                 unsigned long long* __restrict__ scratch,
                                 float* __restrict__ out_val,
                                 int64_t* __restrict__ out_rank,
                                 int64_t* __restrict__ out_j) {
    const uint32_t total = static_cast<uint32_t>(m) * static_cast<uint32_t>(n);
    uint64_t best = 0ull;
    for (uint32_t f = blockIdx.x * blockDim.x + threadIdx.x; f < total;
         f += gridDim.x * blockDim.x) {
        const uint32_t s = f / n, j = f % n;
        const int64_t row = sel[s];
        const float zc = (valid[s] && row == j) ? z[row] : 0.0f;
        const float t1 = __fsub_rn(__fmul_rn(scale, h[row * n + j]), zc);
        const float t2 = __fsub_rn(__fmul_rn(scale, h[(int64_t)j * n + row]), zc);
        const float q = __fmul_rn(0.5f, __fadd_rn(t1, t2));
        float delta = __fsub_rn(__fadd_rn(a[s], b[j]), __fmul_rn(2.0f, q));
        if (isnan(delta)) delta = NEG;
        const uint64_t key = fedgs::pack(delta, f);
        best = key > best ? key : best;
    }
    finish_best(best, n, scratch, out_val, out_rank, out_j);
}

__global__ void swap_gain_kernel(const float* __restrict__ q,
                                 const int64_t* __restrict__ sel,
                                 const float* __restrict__ a,
                                 const float* __restrict__ b, int m, int n,
                                 unsigned long long* __restrict__ scratch,
                                 float* __restrict__ out_val,
                                 int64_t* __restrict__ out_rank,
                                 int64_t* __restrict__ out_j) {
    const uint32_t total = static_cast<uint32_t>(m) * static_cast<uint32_t>(n);
    uint64_t best = 0ull;
    for (uint32_t f = blockIdx.x * blockDim.x + threadIdx.x; f < total;
         f += gridDim.x * blockDim.x) {
        const uint32_t s = f / n, j = f % n;
        const float qv = q[sel[s] * n + j];
        float delta = __fsub_rn(__fadd_rn(a[s], b[j]), __fmul_rn(2.0f, qv));
        if (isnan(delta)) delta = NEG;
        const uint64_t key = fedgs::pack(delta, f);
        best = key > best ? key : best;
    }
    finish_best(best, n, scratch, out_val, out_rank, out_j);
}

constexpr int kSwapThreads = 256;

// Grid of a swap reduction over an m x n panel: one thread per entry, at
// most 8 blocks per SM on 132 SMs (the rest grid-stride).
int swap_blocks(int m, int n) {
    const long long total = static_cast<long long>(m) * n;
    long long blocks = (total + kSwapThreads - 1) / kSwapThreads;
    if (blocks > 1056) blocks = 1056;
    if (blocks < 1) blocks = 1;
    return static_cast<int>(blocks);
}

}  // namespace

// diag, r (n,) f32; mask (n,) bool; out_val () f32; out_idx () int64.
extern "C" int masked_argmax_launch(const float* diag, const float* r,
                                    const uint8_t* mask, int n, float* out_val,
                                    int64_t* out_idx, void* stream) {
    masked_argmax_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
        diag, r, mask, n, out_val, out_idx);
    return static_cast<int>(cudaGetLastError());
}

// h (n, n), z (n,) f32; sel (m,) int64 row indices in range; valid (m,)
// bool; a (m,), b (n,) f32 with the -1e18 sentinel on invalid entries;
// scratch 2 x uint64; outputs () f32, () int64, () int64.  m·n < 2^32.
extern "C" int swap_best_launch(const float* h, const float* z, float scale,
                                const int64_t* sel, const uint8_t* valid,
                                const float* a, const float* b, int m, int n,
                                unsigned long long* scratch, float* out_val,
                                int64_t* out_rank, int64_t* out_j,
                                void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaMemsetAsync(scratch, 0, 2 * sizeof(unsigned long long), s);
    swap_best_kernel<<<swap_blocks(m, n), kSwapThreads, 0, s>>>(
        h, z, scale, sel, valid, a, b, m, n, scratch, out_val, out_rank, out_j);
    return static_cast<int>(cudaGetLastError());
}

// q (n, n) f32 dense Q; sel (m,) int64 row indices in range; a (m,), b (n,)
// f32 with the -1e18 sentinel on invalid entries; scratch 2 x uint64;
// outputs () f32, () int64, () int64.  m·n < 2^32.
extern "C" int swap_gain_launch(const float* q, const int64_t* sel,
                                const float* a, const float* b, int m, int n,
                                unsigned long long* scratch, float* out_val,
                                int64_t* out_rank, int64_t* out_j,
                                void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaMemsetAsync(scratch, 0, 2 * sizeof(unsigned long long), s);
    swap_gain_kernel<<<swap_blocks(m, n), kSwapThreads, 0, s>>>(
        q, sel, a, b, m, n, scratch, out_val, out_rank, out_j);
    return static_cast<int>(cudaGetLastError());
}
