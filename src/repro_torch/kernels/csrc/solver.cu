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
// and column panels (bytes).  The greedy step needs no padding of N: one
// warp with shuffles only up to kArgmaxWarpMost = 128 entries (one round of
// loads a lane), one block beyond;
// it reads the availability mask A_t and the selected set S itself (a lane
// is addable where mask && !taken), so its caller launches no mask op.
// The Q-free swap reads H[sel_s, j] and H[j, sel_s] straight from H (no
// gathered panels; H need not be symmetric), on one of two paths
// (swap_best_plan_kind):
//   * small (m·N <= 2,048 entries: the quickstart's 6 x 30, N = 130's
//     13 x 130): one block folds every key and thread 0 writes the result,
//     as the greedy step's block plan does: one launch, no scratch, no
//     atomics;
//   * tiled: one block per 32 x 64 tile of the panel.  The column term
//     H[j, sel_s] is read with the lanes along s (sel ascending, so a
//     warp's loads lie in one row of H and share sectors where the
//     selected rows are closer than 8) into shared memory; the row term
//     H[sel_s, j] with the lanes along j.  Each block folds its best key
//     into a 16-byte (key, arrival count) state that the caller keeps for
//     its stream (one per stream, and one per CUDA-graph capture, zeroed
//     once when made: kernels/solver.py); the last block to arrive reads
//     the key, writes the result and zeroes the state again, so the next
//     call on the stream, or the graph's next replay, finds it zero with no
//     memset, and calls on other streams never share it.
// The dense swap (`fedgs_solve`'s route, Q given) reads the selected rows
// Q[sel_s, :] in place instead of a gathered (m, N) panel; it needs no
// padding, and its keys carry the global flat index s·N + j, so the lowest
// one wins ties as in the JAX wrapper (which pads Q with 0 and a, b with
// -1e18).  Its rows are contiguous, so its lanes run along j on both of its
// paths (swap_gain_plan_kind):
//   * small (m·N <= kGainSmall = 4,096: the vision solve's 10 x 100, and
//     up to where the grid path overtakes it on an H100): one block,
//     thread slot t = flat index; every load of every entry is issued
//     before one is used, and thread 0 writes the result: one launch, no
//     scratch, no memset, no atomics;
//   * grid: at most kGainBlocks blocks (four per SM on 132 SMs) stride
//     over the panel, each thread with kGainLoads 16-byte loads of a row in
//     flight where N % 4 == 0 (scalar loads otherwise), and meet in the
//     same kind of 16-byte (key, arrival count) state as the tiled Q-free
//     swap, which the last block re-zeroes.
//
// Numerics: Q = 0.5·((a·H_sj − δz) + (a·H_js − δz)) and delta =
// (a_s + b_j) − 2Q are written with __fmul_rn / __fadd_rn / __fsub_rn so
// nvcc's default --fmad=true cannot contract a·H − δz into an FMA: the
// result is bitwise the plain version's.
#include <type_traits>

#include "common.cuh"

namespace {

using fedgs::NEG;

// The greedy step's key of entry i: gain = diag + 2r, NEG where the lane is
// not addable (`out`: mask false, or taken true) or the gain is NaN, packed
// with i.
__device__ __forceinline__ uint64_t argmax_key(float dv, float rv, bool out,
                                               int i) {
    float g = __fadd_rn(dv, __fmul_rn(2.0f, rv));
    if (out || isnan(g)) g = NEG;
    return fedgs::pack(g, static_cast<uint32_t>(i));
}

__device__ __forceinline__ void write_argmax(uint64_t best, int n,
                                             float* out_val,
                                             int64_t* out_idx) {
    if (n == 0) best = fedgs::pack(NEG, 0u);
    *out_val = fedgs::unpack_val(best);
    *out_idx = static_cast<int64_t>(fedgs::unpack_idx(best));
}

// The greedy argmax's plans (masked_argmax_plan_kind): `warp` up to
// kArgmaxWarpMost entries, one warp and shuffles only (no shared memory, no
// barrier), each lane with the loads of up to kArgmaxLoads entries in
// flight at a time (only those in range: a load at a clamped index costs
// time too); `block` beyond, 1,024 threads and a shared-memory block
// reduction.  TAKEN: the kernel also reads the selected set S and masks
// mask && !taken, both loaded at once (a short-circuit && would wait for
// the first load before it starts the second); without it the code is the
// single-mask step's.
constexpr int kArgmaxWarpMost = 128;
constexpr int kArgmaxLoads = 4;

template <bool TAKEN>
__global__ void __launch_bounds__(32)
masked_argmax_warp_kernel(const float* __restrict__ diag,
                          const float* __restrict__ r,
                          const uint8_t* __restrict__ mask,
                          const uint8_t* __restrict__ taken, int n,
                          float* __restrict__ out_val,
                          int64_t* __restrict__ out_idx) {
    constexpr int L = kArgmaxLoads;
    uint64_t best = 0ull;
    for (int base = threadIdx.x; base < n; base += 32 * L) {
        float dv[L], rv[L];
        uint8_t mv[L], tv[L];
#pragma unroll
        for (int e = 0; e < L; ++e) {
            const int i = base + 32 * e;
            if (i < n) {
                dv[e] = diag[i];
                rv[e] = r[i];
                mv[e] = mask[i];
                tv[e] = TAKEN ? taken[i] : 0;
            }
        }
#pragma unroll
        for (int e = 0; e < L; ++e) {
            const int i = base + 32 * e;
            if (i < n) {
                const uint64_t key = argmax_key(dv[e], rv[e],
                                                !mv[e] || tv[e], i);
                best = key > best ? key : best;
            }
        }
    }
    best = fedgs::warp_max_u64(best);
    if (threadIdx.x == 0) write_argmax(best, n, out_val, out_idx);
}

template <bool TAKEN>
__global__ void masked_argmax_kernel(const float* __restrict__ diag,
                                     const float* __restrict__ r,
                                     const uint8_t* __restrict__ mask,
                                     const uint8_t* __restrict__ taken, int n,
                                     float* __restrict__ out_val,
                                     int64_t* __restrict__ out_idx) {
    uint64_t best = 0ull;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float g = __fadd_rn(diag[i], __fmul_rn(2.0f, r[i]));
        bool out;
        if constexpr (TAKEN) {
            const uint8_t m = mask[i], t = taken[i];
            out = !m || t;
        } else {
            out = !mask[i];
        }
        if (out || isnan(g)) g = NEG;
        const uint64_t key = fedgs::pack(g, static_cast<uint32_t>(i));
        best = key > best ? key : best;
    }
    best = fedgs::block_max_u64(best);
    if (threadIdx.x == 0) write_argmax(best, n, out_val, out_idx);
}

// The small path serves panels of up to kSwapSmall entries: on an H100 it
// beats the tiled path's ~3.9 µs up to 2,000–3,000 entries, as the column
// reads of one SM pile up (chip_smoke.py's swap_best_fused rows time both).
// Forced, it takes at most kSmallMost (E <= 4).
constexpr long long kSwapSmall = 2048;
constexpr int kSmallMost = 4096;

// delta of one Q-free panel entry from its H terms (the plain version's
// op order), NaN -> NEG, packed with its flat index f = s·n + j
__device__ __forceinline__ uint64_t swap_fused_key(float scale, float hrow,
                                                  float hcol, float zc,
                                                  float as, float bj,
                                                  uint32_t f) {
    const float t1 = __fsub_rn(__fmul_rn(scale, hrow), zc);
    const float t2 = __fsub_rn(__fmul_rn(scale, hcol), zc);
    const float q = __fmul_rn(0.5f, __fadd_rn(t1, t2));
    float delta = __fsub_rn(__fadd_rn(as, bj), __fmul_rn(2.0f, q));
    if (isnan(delta)) delta = NEG;
    return fedgs::pack(delta, f);
}

__device__ __forceinline__ void write_best(uint64_t key, int n,
                                           float* out_val, int64_t* out_rank,
                                           int64_t* out_j) {
    const uint32_t flat = fedgs::unpack_idx(key);
    *out_val = fedgs::unpack_val(key);
    *out_rank = static_cast<int64_t>(flat / n);
    *out_j = static_cast<int64_t>(flat % n);
}

// Fold a block's best key into the (key, arrival count) state; the last
// block to arrive writes the result and zeroes the state again.
__device__ __forceinline__ void grid_finish(uint64_t best, int n,
                                            unsigned long long* state,
                                            float* out_val, int64_t* out_rank,
                                            int64_t* out_j) {
    best = fedgs::block_max_u64(best);
    if (threadIdx.x == 0) {
        unsigned int* arrived = reinterpret_cast<unsigned int*>(&state[1]);
        atomicMax(&state[0], static_cast<unsigned long long>(best));
        __threadfence();
        if (atomicAdd(arrived, 1u) == gridDim.x * gridDim.y - 1) {
            write_best(atomicExch(&state[0], 0ull), n, out_val, out_rank,
                       out_j);
            atomicExch(arrived, 0u);
        }
    }
}

// Small path: the whole m x n panel in one block of up to 1024 threads;
// thread slot t = threadIdx.x + e·blockDim.x (e < E) takes panel row s = t
// mod m and column j = t / m, so a warp's column reads H[j, sel_s] fall in
// a few rows of H (fewer cache lines than with the lanes along j).  Each
// round of loads (the row's sel, a, b; then its two H terms) is issued for
// all E entries before any is used, at a clamped in-range index, so a
// thread waits for two rounds of loads whatever E.  One SM issues every
// load, so the panel's scattered column reads set its time as it grows.
template <int E>
__global__ void __launch_bounds__(1024)
swap_best_small_kernel(const float* __restrict__ h, const float* __restrict__ z,
                       float scale, const int64_t* __restrict__ sel,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ a, const float* __restrict__ b,
                       int m, int n, float* __restrict__ out_val,
                       int64_t* __restrict__ out_rank,
                       int64_t* __restrict__ out_j) {
    const uint32_t total = static_cast<uint32_t>(m) * static_cast<uint32_t>(n);
    uint32_t f[E], jj[E];
    int64_t row[E];
    bool vld[E];
    float as[E], bj[E], hr[E], hc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const uint32_t t = threadIdx.x + e * blockDim.x;
        const uint32_t tc = t < total ? t : 0u, s = tc % m;
        jj[e] = tc / m;
        f[e] = t < total ? s * n + jj[e] : total;
        row[e] = sel[s];
        vld[e] = valid[s];
        as[e] = a[s];
        bj[e] = b[jj[e]];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
        hr[e] = h[row[e] * n + jj[e]];
        hc[e] = h[(int64_t)jj[e] * n + row[e]];
    }
    uint64_t best = 0ull;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        if (f[e] >= total) continue;
        const float zc = (vld[e] && row[e] == jj[e]) ? z[row[e]] : 0.0f;
        const uint64_t key = swap_fused_key(scale, hr[e], hc[e], zc, as[e],
                                            bj[e], f[e]);
        best = key > best ? key : best;
    }
    best = fedgs::block_max_u64(best);
    if (threadIdx.x == 0) write_best(best, n, out_val, out_rank, out_j);
}

constexpr int kTileS = 32;            // panel rows per tile (the lanes)
constexpr int kTileJ = 64;            // panel columns per tile
constexpr int kTileThreads = 256;

// Tiled path: grid (ceil(n / kTileJ), ceil(m / kTileS)), one block per
// tile.  Warp w reads the column terms of columns w, w + 8, .. with lane =
// panel row; then thread t takes column t % 64 and rows t / 64, + 4, ..;
// each thread issues all its loads of a phase before it uses one.  state:
// [0] = uint64 best key, [1] (low half) = uint32 arrival count, zero on
// entry and zeroed again by the last block.
__global__ void __launch_bounds__(kTileThreads)
swap_best_tiled_kernel(const float* __restrict__ h, const float* __restrict__ z,
                       float scale, const int64_t* __restrict__ sel,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ a, const float* __restrict__ b,
                       int m, int n, unsigned long long* __restrict__ state,
                       float* __restrict__ out_val,
                       int64_t* __restrict__ out_rank,
                       int64_t* __restrict__ out_j) {
    __shared__ float col[kTileJ][kTileS + 1];    // H[j0 + jj, sel[s0 + ss]]
    __shared__ int64_t rows[kTileS];
    __shared__ float zs[kTileS], as_[kTileS];
    __shared__ bool vs[kTileS];
    const int s0 = blockIdx.y * kTileS, j0 = blockIdx.x * kTileJ;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool s_in = s0 + lane < m;
    const int64_t r = s_in ? sel[s0 + lane] : 0;
    if (warp == 0) {
        rows[lane] = r;
        vs[lane] = s_in && valid[s0 + lane];
        zs[lane] = vs[lane] ? z[r] : 0.0f;
        as_[lane] = s_in ? a[s0 + lane] : 0.0f;
    }
    constexpr int kWarps = kTileThreads / 32, kCols = kTileJ / kWarps;
    float cv[kCols];                         // all in flight, then stored
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
        const int jj = warp + kWarps * q;
        cv[q] = (s_in && j0 + jj < n) ? h[(int64_t)(j0 + jj) * n + r] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) col[warp + kWarps * q][lane] = cv[q];
    __syncthreads();
    constexpr int kGroups = kTileThreads / kTileJ, kRows = kTileS / kGroups;
    const int jj = tid % kTileJ, j = j0 + jj, g = tid / kTileJ;
    const bool j_in = j < n;
    const float bj = j_in ? b[j] : 0.0f;
    float hr[kRows];                         // all in flight, then used
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
        const int ss = g + kGroups * q;
        hr[q] = (j_in && s0 + ss < m) ? h[rows[ss] * n + j] : 0.0f;
    }
    uint64_t best = 0ull;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
        const int ss = g + kGroups * q, s = s0 + ss;
        if (!j_in || s >= m) continue;
        const float zc = (vs[ss] && rows[ss] == j) ? zs[ss] : 0.0f;
        const uint64_t key = swap_fused_key(
            scale, hr[q], col[jj][ss], zc, as_[ss], bj,
            static_cast<uint32_t>(s) * static_cast<uint32_t>(n) + j);
        best = key > best ? key : best;
    }
    grid_finish(best, n, state, out_val, out_rank, out_j);
}

// delta of one dense-Q panel entry (the plain version's op order), NaN ->
// NEG, packed with its flat index f = s·n + j
__device__ __forceinline__ uint64_t swap_gain_key(float as, float bj, float qv,
                                                  uint32_t f) {
    float delta = __fsub_rn(__fadd_rn(as, bj), __fmul_rn(2.0f, qv));
    if (isnan(delta)) delta = NEG;
    return fedgs::pack(delta, f);
}

// Dense swap, small path: one block of up to 1024 threads; thread slot t =
// threadIdx.x + e·blockDim.x (e < E) is the flat index s·n + j itself, so a
// warp reads consecutive entries of a row of Q.  The row's sel, a and b are
// loaded for all E entries, then the Q values, then all are used.
template <int E>
__global__ void __launch_bounds__(1024)
swap_gain_small_kernel(const float* __restrict__ q,
                       const int64_t* __restrict__ sel,
                       const float* __restrict__ a, const float* __restrict__ b,
                       int m, int n, float* __restrict__ out_val,
                       int64_t* __restrict__ out_rank,
                       int64_t* __restrict__ out_j) {
    const uint32_t total = static_cast<uint32_t>(m) * static_cast<uint32_t>(n);
    int64_t at[E];
    float as[E], bj[E], qv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const uint32_t t = threadIdx.x + e * blockDim.x;
        const uint32_t tc = t < total ? t : 0u, s = tc / n, j = tc - s * n;
        at[e] = sel[s] * n + j;
        as[e] = a[s];
        bj[e] = b[j];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) qv[e] = q[at[e]];
    uint64_t best = 0ull;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const uint32_t t = threadIdx.x + e * blockDim.x;
        if (t >= total) continue;
        const uint64_t key = swap_gain_key(as[e], bj[e], qv[e], t);
        best = key > best ? key : best;
    }
    best = fedgs::block_max_u64(best);
    if (threadIdx.x == 0) write_best(best, n, out_val, out_rank, out_j);
}

constexpr int kGainThreads = 256;
constexpr int kGainLoads = 4;        // loads in flight per thread and pass
constexpr int kGainBlocks = 4 * 132;

// Dense swap, grid path: the panel as m rows of n / W items of W floats (W
// = 4, 16-byte loads, where n % 4 == 0 and q, b are 16-byte aligned; W = 1
// otherwise), item it = s·(n / W) + c.  Each pass a thread loads the sel,
// a and b of kGainLoads items, then their Q values, then folds their keys.
template <int W>
__global__ void __launch_bounds__(kGainThreads)
swap_gain_grid_kernel(const float* __restrict__ q,
                      const int64_t* __restrict__ sel,
                      const float* __restrict__ a, const float* __restrict__ b,
                      int m, int n, unsigned long long* __restrict__ state,
                      float* __restrict__ out_val,
                      int64_t* __restrict__ out_rank,
                      int64_t* __restrict__ out_j) {
    using V = typename std::conditional<W == 4, float4, float>::type;
    const uint32_t per_row = static_cast<uint32_t>(n) / W;
    const uint32_t items = static_cast<uint32_t>(m) * per_row;
    const uint32_t step = gridDim.x * kGainThreads * kGainLoads;
    uint64_t best = 0ull;
    for (uint32_t base = blockIdx.x * kGainThreads * kGainLoads; base < items;
         base += step) {
        uint32_t f[kGainLoads];
        int64_t at[kGainLoads];
        float as[kGainLoads];
        V bv[kGainLoads], qv[kGainLoads];
#pragma unroll
        for (int u = 0; u < kGainLoads; ++u) {
            const uint32_t it = base + threadIdx.x + u * kGainThreads;
            const uint32_t ic = it < items ? it : 0u;
            const uint32_t s = ic / per_row, j = (ic - s * per_row) * W;
            f[u] = it < items ? s * static_cast<uint32_t>(n) + j : 0xffffffffu;
            at[u] = sel[s] * n + j;
            as[u] = a[s];
            bv[u] = *reinterpret_cast<const V*>(b + j);
        }
#pragma unroll
        for (int u = 0; u < kGainLoads; ++u)
            qv[u] = *reinterpret_cast<const V*>(q + at[u]);
#pragma unroll
        for (int u = 0; u < kGainLoads; ++u) {
            if (f[u] == 0xffffffffu) continue;
            const float* bb = reinterpret_cast<const float*>(&bv[u]);
            const float* qq = reinterpret_cast<const float*>(&qv[u]);
#pragma unroll
            for (int l = 0; l < W; ++l) {
                const uint64_t key = swap_gain_key(as[u], bb[l], qq[l],
                                                   f[u] + l);
                best = key > best ? key : best;
            }
        }
    }
    grid_finish(best, n, state, out_val, out_rank, out_j);
}

__global__ void empty_kernel() {}

}  // namespace

// The plan masked_argmax_launch takes for n entries: 0 warp, 1 block.
extern "C" int masked_argmax_plan_kind(int n) {
    return n <= kArgmaxWarpMost ? 0 : 1;
}

// The most entries the warp plan is taken for.
extern "C" int masked_argmax_warp_most() { return kArgmaxWarpMost; }

// diag, r (n,) f32; mask (n,) bool (true: addable); taken (n,) bool (true:
// already selected, not addable) or null; out_val () f32; out_idx () int64;
// kind: -1 the planned path, 0 warp, 1 block.
extern "C" int masked_argmax_launch(const float* diag, const float* r,
                                    const uint8_t* mask, const uint8_t* taken,
                                    int n, int kind, float* out_val,
                                    int64_t* out_idx, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind < 0) kind = masked_argmax_plan_kind(n);
    if (kind == 0 && taken != nullptr)
        masked_argmax_warp_kernel<true><<<1, 32, 0, s>>>(
            diag, r, mask, taken, n, out_val, out_idx);
    else if (kind == 0)
        masked_argmax_warp_kernel<false><<<1, 32, 0, s>>>(
            diag, r, mask, nullptr, n, out_val, out_idx);
    else if (kind == 1 && taken != nullptr)
        masked_argmax_kernel<true><<<1, 1024, 0, s>>>(
            diag, r, mask, taken, n, out_val, out_idx);
    else if (kind == 1)
        masked_argmax_kernel<false><<<1, 1024, 0, s>>>(
            diag, r, mask, nullptr, n, out_val, out_idx);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

// The path swap_best_launch takes for an m x n panel: 0 small, 1 tiled.
extern "C" int swap_best_plan_kind(int m, int n) {
    return static_cast<long long>(m) * n <= kSwapSmall ? 0 : 1;
}

namespace {

template <int E>
void launch_small(int threads, cudaStream_t s, const float* h, const float* z,
                  float scale, const int64_t* sel, const uint8_t* valid,
                  const float* a, const float* b, int m, int n,
                  float* out_val, int64_t* out_rank, int64_t* out_j) {
    swap_best_small_kernel<E><<<1, threads, 0, s>>>(
        h, z, scale, sel, valid, a, b, m, n, out_val, out_rank, out_j);
}

}  // namespace

// h (n, n), z (n,) f32; sel (m,) int64 row indices in range; valid (m,)
// bool; a (m,), b (n,) f32 with the -1e18 sentinel on invalid entries;
// outputs () f32, () int64, () int64; kind: 0 small or 1 tiled
// (swap_best_plan_kind's path, or the other one to time the two; the small
// one takes at most 4,096 entries); state: the tiled path's 2 x uint64,
// zero, used on `stream` alone (null for the small path).  0 < m·n < 2^31.
extern "C" int swap_best_launch(const float* h, const float* z, float scale,
                                const int64_t* sel, const uint8_t* valid,
                                const float* a, const float* b, int m, int n,
                                int kind, unsigned long long* state,
                                float* out_val, int64_t* out_rank,
                                int64_t* out_j, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == 0) {
        // one block of up to 1024 threads, E entries per thread
        if (static_cast<long long>(m) * n > kSmallMost)
            return static_cast<int>(cudaErrorInvalidValue);
        const int total = m * n;
        const int threads = total < 1024 ? (total + 31) / 32 * 32 : 1024;
        const int e = (total + threads - 1) / threads;
        if (e <= 1)
            launch_small<1>(threads, s, h, z, scale, sel, valid, a, b, m, n,
                            out_val, out_rank, out_j);
        else if (e <= 2)
            launch_small<2>(threads, s, h, z, scale, sel, valid, a, b, m, n,
                            out_val, out_rank, out_j);
        else
            launch_small<4>(threads, s, h, z, scale, sel, valid, a, b, m, n,
                            out_val, out_rank, out_j);
    } else {
        if (state == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const dim3 grid((n + kTileJ - 1) / kTileJ, (m + kTileS - 1) / kTileS);
        swap_best_tiled_kernel<<<grid, kTileThreads, 0, s>>>(
            h, z, scale, sel, valid, a, b, m, n, state, out_val, out_rank,
            out_j);
    }
    return static_cast<int>(cudaGetLastError());
}

// The dense swap's small path serves panels of up to kGainSmall entries;
// forced, it takes at most kGainSmallMost (E <= 8).
constexpr long long kGainSmall = 4096;
constexpr int kGainSmallMost = 8192;

// The path swap_gain_launch takes for an m x n panel: 0 small, 1 grid.
extern "C" int swap_gain_plan_kind(int m, int n) {
    return static_cast<long long>(m) * n <= kGainSmall ? 0 : 1;
}

namespace {

template <int E>
void launch_gain_small(int threads, cudaStream_t s, const float* q,
                       const int64_t* sel, const float* a, const float* b,
                       int m, int n, float* out_val, int64_t* out_rank,
                       int64_t* out_j) {
    swap_gain_small_kernel<E><<<1, threads, 0, s>>>(q, sel, a, b, m, n,
                                                    out_val, out_rank, out_j);
}

}  // namespace

// q (n, n) f32 dense Q; sel (m,) int64 row indices in range; a (m,), b (n,)
// f32 with the -1e18 sentinel on invalid entries; outputs () f32, ()
// int64, () int64; kind: 0 small or 1 grid (swap_gain_plan_kind's path, or
// the other one to time the two; the small one takes at most 8,192
// entries); state: the grid path's 2 x uint64, zero, used on `stream` alone
// (null for the small path).  0 < m·n < 2^31.
extern "C" int swap_gain_launch(const float* q, const int64_t* sel,
                                const float* a, const float* b, int m, int n,
                                int kind, unsigned long long* state,
                                float* out_val, int64_t* out_rank,
                                int64_t* out_j, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long total = static_cast<long long>(m) * n;
    if (kind == 0) {
        if (total > kGainSmallMost)
            return static_cast<int>(cudaErrorInvalidValue);
        const int threads = total < 1024 ? (static_cast<int>(total) + 31) / 32 * 32
                                         : 1024;
        const int e = static_cast<int>((total + threads - 1) / threads);
        if (e <= 1)
            launch_gain_small<1>(threads, s, q, sel, a, b, m, n, out_val,
                                 out_rank, out_j);
        else if (e <= 2)
            launch_gain_small<2>(threads, s, q, sel, a, b, m, n, out_val,
                                 out_rank, out_j);
        else if (e <= 4)
            launch_gain_small<4>(threads, s, q, sel, a, b, m, n, out_val,
                                 out_rank, out_j);
        else
            launch_gain_small<8>(threads, s, q, sel, a, b, m, n, out_val,
                                 out_rank, out_j);
    } else {
        if (state == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const bool vec = n % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(b)) %
                16 == 0;
        const long long items = vec ? total / 4 : total;
        long long blocks = (items + kGainThreads * kGainLoads - 1) /
                           (kGainThreads * kGainLoads);
        if (blocks > kGainBlocks) blocks = kGainBlocks;
        if (vec)
            swap_gain_grid_kernel<4><<<static_cast<int>(blocks), kGainThreads,
                                       0, s>>>(q, sel, a, b, m, n, state,
                                               out_val, out_rank, out_j);
        else
            swap_gain_grid_kernel<1><<<static_cast<int>(blocks), kGainThreads,
                                       0, s>>>(q, sel, a, b, m, n, state,
                                               out_val, out_rank, out_j);
    }
    return static_cast<int>(cudaGetLastError());
}

// The id of the CUDA-graph capture under way on `stream`, or 0 when none is.
extern "C" unsigned long long stream_capture_id(void* stream) {
    cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
    unsigned long long id = 0;
    if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                 &id) != cudaSuccess ||
        status != cudaStreamCaptureStatusActive)
        return 0;
    return id;
}

// An empty one-warp launch: replayed from a CUDA graph, its time is the
// floor that every tiny kernel of the port is held against.
extern "C" int empty_launch(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
