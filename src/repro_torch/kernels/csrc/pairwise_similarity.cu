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
// similarity: V is summed in the order common.cuh fixes, so V is bitwise
//   `kernels/ref.similarity_ref`'s and the fused kernel's.  What bounds it:
//   the N(N+1)/2·d multiply-adds of the upper triangle (the bytes are U in
//   and V out); with no FMA and no TF32 each multiply-add is two
//   instructions, so the f32 CUDA-core instruction rate is the ceiling.  Its
//   tile kernels and their three plans (split, serial, big) live in
//   similarity.cuh, which the fused kernel shares: the staged route runs
//   their FUSED-false instances.
// adjacency: common.cuh's adjacency_entry over the flat N² array, a thread
//   for every access (single entries at small N, 16-byte vectors beyond),
//   with lo/hi read from a device buffer (reduced by the caller, no host
//   sync) and the diagonal found as f % (N + 1) == 0: the kernel of
//   similarity.cuh that the fused kernel's epilogue launch runs in place,
//   so given the same V and lo/hi, R is bitwise the fused kernel's.  What
//   bounds it: the bytes, V in and R out.
#include "similarity.cuh"

using namespace fedgs::sim;

// Bytes of scratch similarity_launch needs for u (n, d) on the current
// device (0 when the plan does not split).
extern "C" long long similarity_scratch_bytes(int n, int d) {
    return static_cast<long long>(plan(n, d).scratch);
}

// The plan similarity_launch takes for (n, d) on the current device:
// 0 serial, 1 split, 2 big.
extern "C" int similarity_plan_kind(int n, int d) {
    return plan(n, d).kind;
}

// u (n, d) f32 row-major; v (n, n) f32 out; scratch: similarity_scratch_
// bytes(n, d) bytes (may be null when that is 0).
// Returns cudaGetLastError().
extern "C" int similarity_launch(const float* u, int n, int d, float* v,
                                 void* scratch, void* stream) {
    return launch<false>(plan(n, d), u, n, d, v, scratch,
                         static_cast<cudaStream_t>(stream), Fuse{});
}

// The serial plan at any (n, d): the same V as similarity_launch, bit for
// bit; it exists to time the plans against each other.
extern "C" int similarity_serial_launch(const float* u, int n, int d,
                                        float* v, void* stream) {
    return launch<false>(serial_plan(n, d), u, n, d, v, nullptr,
                         static_cast<cudaStream_t>(stream), Fuse{});
}

// v (n, n) f32 raw similarity; stats (2,) f32 = [lo, hi] on the device;
// r (n, n) f32 out (r == v: in place).  Returns cudaGetLastError().
extern "C" int adjacency_launch(const float* v, int n, const float* stats,
                                float eps, float sigma2, float* r,
                                void* stream) {
    return launch_adjacency(v, n, stats, eps, sigma2, r,
                            static_cast<cudaStream_t>(stream));
}

// The grid adjacency_launch takes for n on aligned storage: blocks * 8 +
// width.
extern "C" int adjacency_grid_code(int n) {
    const AdjGrid g = adjacency_grid(n);
    return g.blocks * 8 + g.width;
}
