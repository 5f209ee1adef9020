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
// The batched solve's two kernels (masked_argmax_cells_kernel,
// swap_best_cells_kernel: "the cell axis" below) do a greedy step or a
// sweep of every FedGS cell of a batch in one launch, a block a cell, with
// the step's glue inside; their panels are the small path's.
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

// One entry of Q = sym(a·H) − diag(z) from its two H terms:
// 0.5·((a·H_kj − δz) + (a·H_jk − δz)), δz = z_k on the diagonal, else 0
// (kernels/solver.py q_row's op order)
__device__ __forceinline__ float q_entry(float scale, float hrow, float hcol,
                                         float zc) {
    const float t1 = __fsub_rn(__fmul_rn(scale, hrow), zc);
    const float t2 = __fsub_rn(__fmul_rn(scale, hcol), zc);
    return __fmul_rn(0.5f, __fadd_rn(t1, t2));
}

// delta of one Q-free panel entry from its H terms (the plain version's
// op order), NaN -> NEG, packed with its flat index f = s·n + j
__device__ __forceinline__ uint64_t swap_fused_key(float scale, float hrow,
                                                  float hcol, float zc,
                                                  float as, float bj,
                                                  uint32_t f) {
    const float q = q_entry(scale, hrow, hcol, zc);
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

// ------------------------------------------------------------ the cell axis
// The batched solve (core/sampler_device.fedgs_select_cells): every FedGS
// cell of a batch in one launch a greedy step and one a sweep, block c
// taking cell c.  A cell's state, s (B, n) bool and r (B, n) f32, stays in
// device memory and each launch updates its row in place, so the solve's
// per-step glue (q_row's gathers, the sort of S, the selects and adds) runs
// inside the two kernels: m + max_sweeps launches a batch round, whatever
// the number of cells.  H is the cell's (n, n) at h + c·h_stride (stride 0:
// one H shared by every cell), z (B, n) the count penalty, scale (B,) each
// cell's alpha/N in float32.  Every value is the per-step route's bit for
// bit: the same keys, the same op order, no FMA contraction.  They take a
// panel of m <= n rows with m·n <= kSwapSmall, one block's worth
// (solve_cells_take); a larger panel takes the per-step kernels cell by
// cell.

// The greedy value a lane must beat to be added: the per-step route's
// `val > NEG / 2`, the Python -5e17 compared in float32.
constexpr float kAddFloor = -5e17f;
constexpr float kSwapTol = 1e-9f;    // SWAP_TOL, compared in float32 too
constexpr int kCellsMostN = 2048;    // n <= kSwapSmall / m
constexpr int kCellsMostM = 64;      // m <= sqrt(kSwapSmall) = 45

// diag(Q)_k = 0.5·((a·H_kk − z_k) + (a·H_kk − z_k)) (q_diag's op order)
__device__ __forceinline__ float q_diag_entry(const float* h, const float* z,
                                              float scale, int k, int n) {
    const float t = __fsub_rn(__fmul_rn(scale, h[(int64_t)k * n + k]), z[k]);
    return __fmul_rn(0.5f, __fadd_rn(t, t));
}

// One greedy step of every cell: the argmax of diag + 2r over the lanes
// that are available and not yet selected (argmax_key), then, where its
// value beats kAddFloor, s[k] set and Q's row k added to r; where it does
// not, +0.0 added (the per-step route's r + where(ok, row, 0)).  FIRST:
// the solve's first step, which reads s and r as zero and writes both rows
// whole (no memset before the solve).  Each thread updates the entries it
// read, so the step needs one barrier between its reads and its writes.
template <bool FIRST>
__global__ void __launch_bounds__(1024)
masked_argmax_cells_kernel(const float* __restrict__ h, long long h_stride,
                           const float* __restrict__ z,
                           const float* __restrict__ scale,
                           const uint8_t* __restrict__ avail,
                           uint8_t* __restrict__ s, float* __restrict__ r,
                           int n) {
    __shared__ int k_sh;
    __shared__ bool ok_sh;
    const int64_t row = (int64_t)blockIdx.x * n;
    const float* hc = h + blockIdx.x * h_stride;
    const float* zc = z + row;
    const uint8_t* ac = avail + row;
    uint8_t* sc = s + row;
    float* rc = r + row;
    const float a = scale[blockIdx.x];
    uint64_t best = 0ull;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float rv = FIRST ? 0.0f : rc[i];
        const bool taken = FIRST ? false : sc[i] != 0;
        const uint64_t key = argmax_key(q_diag_entry(hc, zc, a, i, n), rv,
                                        !ac[i] || taken, i);
        best = key > best ? key : best;
    }
    best = fedgs::block_max_u64(best);
    if (threadIdx.x == 0) {
        k_sh = static_cast<int>(fedgs::unpack_idx(best));
        ok_sh = fedgs::unpack_val(best) > kAddFloor;
    }
    __syncthreads();
    const int k = k_sh;
    const bool ok = ok_sh;
    const float zk = zc[k];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float add = ok ? q_entry(a, hc[(int64_t)k * n + i],
                                       hc[(int64_t)i * n + k],
                                       i == k ? zk : 0.0f)
                             : 0.0f;
        rc[i] = __fadd_rn(FIRST ? 0.0f : rc[i], add);
        if (FIRST)
            sc[i] = ok && i == k;
        else if (ok && i == k)
            sc[i] = 1;
    }
}

// One best-swap sweep of every cell: (1) diag and the in-terms b = 2r +
// diag where the lane is available and not selected, else NEG, into shared
// memory, and the selected rows in ascending order by a block-wide
// compaction of s (padded rows: n − 1, marked invalid); (2) the rows'
// out-terms a = −2r + diag, NEG where padded; (3) the m x n panel folded
// as swap_best_small_kernel folds it (slot t: row t mod m, column t / m,
// the same keys, the lowest flat index s·n + j winning ties); (4) where the
// best delta beats kSwapTol, s loses row i and gains column j and r
// becomes (r − Q[i]) + Q[j].  Every read of s and r comes before the
// barrier of (3)'s reduction, every write after it.
template <int E>
__global__ void __launch_bounds__(1024)
swap_best_cells_kernel(const float* __restrict__ h, long long h_stride,
                       const float* __restrict__ z,
                       const float* __restrict__ scale,
                       const uint8_t* __restrict__ avail,
                       uint8_t* __restrict__ s, float* __restrict__ r,
                       int m, int n) {
    __shared__ float diag_sh[kCellsMostN], b_sh[kCellsMostN];
    __shared__ int rows_sh[kCellsMostM];
    __shared__ float a_sh[kCellsMostM], z_sh[kCellsMostM];
    __shared__ bool v_sh[kCellsMostM];
    __shared__ int warp_sh[32];
    __shared__ int count_sh, i_sh, j_sh;
    __shared__ bool swap_sh;
    const int64_t row = (int64_t)blockIdx.x * n;
    const float* hc = h + blockIdx.x * h_stride;
    const float* zc = z + row;
    const uint8_t* ac = avail + row;
    uint8_t* sc = s + row;
    float* rc = r + row;
    const float a = scale[blockIdx.x];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;

    // (1): a chunk of blockDim.x entries a pass; count_sh carries how many
    // rows the chunks before it selected
    if (tid == 0) count_sh = 0;
    for (int c0 = 0; c0 < n; c0 += blockDim.x) {
        const int i = c0 + tid;
        bool in_s = false;
        if (i < n) {
            in_s = sc[i] != 0;
            const float d = q_diag_entry(hc, zc, a, i, n);
            diag_sh[i] = d;
            b_sh[i] = (!in_s && ac[i]) ? __fadd_rn(__fmul_rn(2.0f, rc[i]), d)
                                       : NEG;
        }
        const unsigned bal = __ballot_sync(0xffffffffu, in_s);
        if (lane == 0) warp_sh[warp] = __popc(bal);
        __syncthreads();
        int pos = count_sh + __popc(bal & ((1u << lane) - 1u));
        for (int w = 0; w < warp; ++w) pos += warp_sh[w];
        if (in_s && pos < m) rows_sh[pos] = i;
        int chunk = 0;
        if (tid == 0)
            for (int w = 0; w < nwarps; ++w) chunk += warp_sh[w];
        __syncthreads();
        if (tid == 0) count_sh += chunk;
    }
    __syncthreads();
    // (2)
    if (tid < m) {
        const bool v = tid < count_sh;
        const int rw = v ? rows_sh[tid] : n - 1;
        rows_sh[tid] = rw;
        v_sh[tid] = v;
        z_sh[tid] = v ? zc[rw] : 0.0f;
        a_sh[tid] = v ? __fadd_rn(__fmul_rn(-2.0f, rc[rw]), diag_sh[rw]) : NEG;
    }
    __syncthreads();
    // (3): every slot's loads in flight before one is used
    const uint32_t total = static_cast<uint32_t>(m) * static_cast<uint32_t>(n);
    uint32_t sr[E], jj[E];
    float hr[E], hcol[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const uint32_t t = tid + e * blockDim.x;
        const uint32_t tc = t < total ? t : 0u;
        sr[e] = tc % m;
        jj[e] = tc / m;
        const int64_t rw = rows_sh[sr[e]];
        hr[e] = hc[rw * n + jj[e]];
        hcol[e] = hc[(int64_t)jj[e] * n + rw];
    }
    uint64_t best = 0ull;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        if (tid + e * blockDim.x >= total) continue;
        const int rw = rows_sh[sr[e]];
        const float zv = (v_sh[sr[e]] && rw == static_cast<int>(jj[e]))
                             ? z_sh[sr[e]] : 0.0f;
        const uint64_t key = swap_fused_key(a, hr[e], hcol[e], zv,
                                            a_sh[sr[e]], b_sh[jj[e]],
                                            sr[e] * n + jj[e]);
        best = key > best ? key : best;
    }
    best = fedgs::block_max_u64(best);
    if (tid == 0) {
        const uint32_t flat = fedgs::unpack_idx(best);
        const uint32_t rank = flat / n;
        i_sh = rows_sh[rank < static_cast<uint32_t>(m) ? rank : m - 1];
        j_sh = static_cast<int>(flat % n);
        swap_sh = fedgs::unpack_val(best) > kSwapTol;
    }
    __syncthreads();
    if (!swap_sh) return;
    // (4)
    const int i = i_sh, j = j_sh;
    const float zi = zc[i], zj = zc[j];
    for (int x = tid; x < n; x += blockDim.x) {
        const float qi = q_entry(a, hc[(int64_t)i * n + x],
                                 hc[(int64_t)x * n + i], x == i ? zi : 0.0f);
        const float qj = q_entry(a, hc[(int64_t)j * n + x],
                                 hc[(int64_t)x * n + j], x == j ? zj : 0.0f);
        rc[x] = __fadd_rn(__fsub_rn(rc[x], qi), qj);
    }
    if (tid == 0) {
        sc[i] = 0;
        sc[j] = 1;
    }
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

// Whether the batched solve's kernels take an m-row panel over n clients:
// 1 <= m <= n and the panel fits swap_best_plan_kind's small path.
extern "C" int solve_cells_take(int m, int n) {
    return m >= 1 && m <= n && swap_best_plan_kind(m, n) == 0;
}

namespace {

int cells_threads(long long entries) {
    return entries < 1024 ? static_cast<int>((entries + 31) / 32 * 32) : 1024;
}

}  // namespace

// One greedy step of `cells` cells, in place: h at h + c·h_stride (n, n)
// f32 (stride 0: one H for all), z (cells, n) f32, scale (cells,) f32,
// avail and s (cells, n) bool, r (cells, n) f32; first != 0 for the solve's
// first step (s and r read as zero and written whole).  1 <= n <= 2,048.
extern "C" int masked_argmax_cells_launch(const float* h, long long h_stride,
                                          const float* z, const float* scale,
                                          const uint8_t* avail, uint8_t* s,
                                          float* r, int cells, int n,
                                          int first, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cells < 1 || n < 1 || n > kCellsMostN)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = cells_threads(n);
    if (first)
        masked_argmax_cells_kernel<true><<<cells, threads, 0, st>>>(
            h, h_stride, z, scale, avail, s, r, n);
    else
        masked_argmax_cells_kernel<false><<<cells, threads, 0, st>>>(
            h, h_stride, z, scale, avail, s, r, n);
    return static_cast<int>(cudaGetLastError());
}

// One best-swap sweep of `cells` cells over m-row panels, in place, on the
// arguments of masked_argmax_cells_launch; solve_cells_take(m, n) must hold.
extern "C" int swap_best_cells_launch(const float* h, long long h_stride,
                                      const float* z, const float* scale,
                                      const uint8_t* avail, uint8_t* s,
                                      float* r, int cells, int m, int n,
                                      void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cells < 1 || !solve_cells_take(m, n))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long total = static_cast<long long>(m) * n;
    const int threads = cells_threads(total);
    if (total <= threads)
        swap_best_cells_kernel<1><<<cells, threads, 0, st>>>(
            h, h_stride, z, scale, avail, s, r, m, n);
    else
        swap_best_cells_kernel<2><<<cells, threads, 0, st>>>(
            h, h_stride, z, scale, avail, s, r, m, n);
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
