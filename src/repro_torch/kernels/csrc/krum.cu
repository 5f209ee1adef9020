// Pairwise squared-distance panel of the Krum aggregator:
//     D[i, j] = (||x_i||² + ||x_j||²) − 2 x_i · x_j     over x (m, P) f32.
//
// Replaces repro/kernels/krum.py `_krum_kernel` / `krum_pallas`.  The TPU
// kernel accumulates per-P-tile partials `ri + rj − 2 x xᵀ` in a revisited
// output block across a sequential grid, with the cross term on the MXU.
// Here the sums are IEEE f32 on the CUDA cores (never TF32, no cuBLAS), no
// float atomics (every call repeats bit for bit), and the epilogue is the
// plain version's op order, (n_i + n_j) − 2·g with each step rounded.  D
// is exactly symmetric (D_ij and D_ji are one value, or the same products
// in the same order) and its diagonal is exactly 0 (a row's norm and its
// Gram diagonal are one sum).  Two plans, chosen from (m, P)
// (krum_plan_kind):
//   * small (the main path's (6, 610), up to m = 210 there; few pairs of
//     rows up to P = 8,192): one launch, no scratch.  One warp per upper
//     pair i <= j; the lanes stride over P with 16-, 8- or 4-byte loads (as
//     P and x's alignment allow) and fold x_i·x_i, x_j·x_j and x_i·x_j in
//     one pass, by FMA, in the same lane order for every pair; a fixed
//     xor-shuffle tree adds the lanes up and lane 0 writes D_ij and D_ji.
//     Every pair takes a row's norm in the same order, so the norms agree
//     and D_ii = 0.
//   * split: the Gram G = x·xᵀ by tile32.cuh's 32x32 tiles (the
//     similarity's split and serial plans' tile, summed in chunks of KS
//     columns, here by FMA) with P split so the card fills: block (t, y)
//     sums chunks [y·cpb, (y+1)·cpb) of upper tile t into scratch, enough
//     slices S per tile for about four blocks per SM (one slice when the
//     tiles alone are that many).  A second launch adds each entry's S
//     partials in ascending slice order from 0 and applies the epilogue,
//     with n_i taken as the same ordered sum of the diagonal's partials,
//     and writes D_ij and, through shared memory, D_ji.
// What bounds it on the card: the m·(m+1)·P operations of the symmetric
// Gram against 4·(m·P + m²) bytes; at the main path's m = 6, one launch.
#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "tile32.cuh"

namespace {

using fedgs::KS;
using namespace fedgs::tile32;

// The small plan serves while P <= SMALL_MAX_P and pairs · (P +
// SMALL_PAIR_COST) <= SMALL_WORK (a pair's fixed cost is worth about 512
// columns).  On an H100 the split plan's two launches take 9–14 µs at small
// shapes, and the small plan undercuts them up to m = 210 at P = 610 and
// m = 139 at P = 2,048; a warp's serial walk over P passes the split plan's
// time near P = 8,192 (chip_smoke.py's krum rows time both plans at m =
// 209-211 for P = 610, and at P = 8,192 and 8,193 for m = 8).
constexpr int SMALL_MAX_P = 8192;
constexpr long long SMALL_PAIR_COST = 512;
constexpr long long SMALL_WORK = 25000000;
constexpr int SMALL_WARPS = 8;       // warps (pairs) per block
constexpr int R_ROWS = 8;            // tile rows per block of the ordered sum
constexpr int RB = 16;               // partials in flight per thread there

// pair w of the row-major upper triangle of an m x m grid: (i, j), i <= j
__device__ __forceinline__ void upper_pair(int w, int m, int& i, int& j) {
    auto off = [m](long long r) { return r * m - r * (r - 1) / 2; };
    const double b = 2.0 * m + 1.0;
    int r = static_cast<int>(0.5 * (b - sqrt(b * b - 8.0 * w)));
    r = max(0, min(r, m - 1));
    while (r > 0 && off(r) > w) --r;
    while (r + 1 < m && off(r + 1) <= w) ++r;
    i = r;
    j = r + static_cast<int>(w - off(r));
}

template <int EL>
__device__ __forceinline__ void load_el(const float* p, float v[EL]) {
    if constexpr (EL == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else if constexpr (EL == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        v[0] = t.x; v[1] = t.y;
    } else {
        v[0] = *p;
    }
}

// Small plan: one warp per upper pair, the lanes striding through P
// (P % EL == 0); a fixed xor-shuffle tree adds the lanes' three sums.
template <int EL>
__global__ void __launch_bounds__(32 * SMALL_WARPS)
krum_pair_kernel(const float* __restrict__ x, int m, int p, int pairs,
                 float* __restrict__ d) {
    const int lane = threadIdx.x & 31;
    const int pair = blockIdx.x * SMALL_WARPS + (threadIdx.x >> 5);
    if (pair >= pairs) return;               // warp-uniform
    int i, j;
    upper_pair(pair, m, i, j);
    const float* xi = x + static_cast<size_t>(i) * p;
    const float* xj = x + static_cast<size_t>(j) * p;
    float nii = 0.0f, njj = 0.0f, g = 0.0f;
    for (int k = lane * EL; k < p; k += 32 * EL) {
        float a[EL], b[EL];
        load_el<EL>(xi + k, a);
        load_el<EL>(xj + k, b);
#pragma unroll
        for (int e = 0; e < EL; ++e) {
            nii = fmaf(a[e], a[e], nii);
            njj = fmaf(b[e], b[e], njj);
            g = fmaf(a[e], b[e], g);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        nii = __fadd_rn(nii, __shfl_xor_sync(0xffffffffu, nii, off));
        njj = __fadd_rn(njj, __shfl_xor_sync(0xffffffffu, njj, off));
        g = __fadd_rn(g, __shfl_xor_sync(0xffffffffu, g, off));
    }
    if (lane == 0) {
        const float dv = __fsub_rn(__fadd_rn(nii, njj), __fmul_rn(2.0f, g));
        d[static_cast<size_t>(i) * m + j] = dv;
        d[static_cast<size_t>(j) * m + i] = dv;
    }
}

// Split plan, first launch: grid (upper tiles, S); block (t, y) writes the
// sum of chunks [y·cpb, min((y+1)·cpb, nchunks)) of tile t to part (tiles,
// S, ST, ST).
__global__ void __launch_bounds__(S_THREADS)
krum_partial_kernel(const float* __restrict__ x, int m, int p, int el, int nt,
                    int nchunks, int cpb, float* __restrict__ part) {
    extern __shared__ __align__(16) float smem[];
    int ti, tj;
    upper_tile(blockIdx.x, nt, ti, tj);
    const int c_lo = blockIdx.y * cpb, c_hi = min(nchunks, c_lo + cpb);
    float acc[4][2];
    tile32_chunks<true>(x, m, p, el, ti * ST, tj * ST, ti == tj, c_lo, c_hi,
                        smem, acc);
    float* mine = part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * (ST * ST);
    const int tx = threadIdx.x >> 3, ty = threadIdx.x & 7;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
            mine[(ty + 8 * a) * ST + tx + 16 * b] = acc[a][b];
}

// 0 + e_0 + e_1 + ... + e_{s-1}, e_y = pe[y · ST²], RB loads in flight
__device__ __forceinline__ float ordered_sum(const float* __restrict__ pe,
                                             int s) {
    float acc = 0.0f;
    for (int y0 = 0; y0 < s; y0 += RB) {
        float buf[RB];
#pragma unroll
        for (int q = 0; q < RB; ++q)
            buf[q] = y0 + q < s ? __ldg(pe + (size_t)(y0 + q) * (ST * ST)) : 0.0f;
#pragma unroll
        for (int q = 0; q < RB; ++q)
            if (y0 + q < s) acc = __fadd_rn(acc, buf[q]);
    }
    return acc;
}

// Split plan, second launch: grid (upper tiles, ST / R_ROWS), one thread per
// entry of R_ROWS rows of a tile.  The norms of the block's rows and
// columns are the same ordered sums over the diagonal tiles' partials, so
// n_i is G_ii bit for bit.  Writes D_ij and, through shared memory, D_ji.
__global__ void __launch_bounds__(R_ROWS * ST)
krum_sum_kernel(const float* __restrict__ part, int m, int nt, int s,
                float* __restrict__ d) {
    __shared__ float nrm_r[R_ROWS], nrm_c[ST];
    __shared__ float ts[ST][R_ROWS + 1];
    int ti, tj;
    upper_tile(blockIdx.x, nt, ti, tj);
    const int rq = blockIdx.y * R_ROWS;      // the block's first tile row
    const int tid = threadIdx.x;
    if (tid < R_ROWS + ST) {
        const bool row = tid < R_ROWS;
        const int r = row ? rq + tid : tid - R_ROWS;
        const float* pe = part + (size_t)diag_tile(row ? ti : tj, nt) * s * (ST * ST);
        const float nv = ordered_sum(pe + r * ST + r, s);
        if (row) nrm_r[tid] = nv; else nrm_c[tid - R_ROWS] = nv;
    }
    __syncthreads();
    const int r = rq + tid / ST, c = tid % ST;
    const float g = ordered_sum(part + (size_t)blockIdx.x * s * (ST * ST) + r * ST + c, s);
    const float dv = __fsub_rn(__fadd_rn(nrm_r[tid / ST], nrm_c[c]),
                               __fmul_rn(2.0f, g));
    const int i = ti * ST + r, j = tj * ST + c;
    if (i < m && j < m) d[(size_t)i * m + j] = dv;
    if (ti == tj) return;                    // the tile holds its mirror
    ts[c][r - rq] = dv;
    __syncthreads();
    const int jr = tid / R_ROWS, ic = tid % R_ROWS;
    const int jj = tj * ST + jr, ii = ti * ST + rq + ic;   // D[jj][ii]
    if (jj < m && ii < m) d[(size_t)jj * m + ii] = ts[jr][ic];
}

struct SplitPlan {
    int nt, tiles, nchunks, cpb, slices;
    size_t scratch;            // bytes of the partials
};

int sm_count() {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

bool small(int m, int p) {
    return p <= SMALL_MAX_P &&
           static_cast<long long>(m) * (m + 1) / 2 * (p + SMALL_PAIR_COST)
               <= SMALL_WORK;
}

SplitPlan split_plan(int m, int p) {
    SplitPlan pl{};
    pl.nt = (m + ST - 1) / ST;
    pl.tiles = pl.nt * (pl.nt + 1) / 2;
    pl.nchunks = (p + KS - 1) / KS;
    // slices per tile for about four blocks per SM, whole chunks each
    const int want = std::max(1, (4 * sm_count() + pl.tiles - 1) / pl.tiles);
    const int slices = std::min(want, pl.nchunks);
    pl.cpb = (pl.nchunks + slices - 1) / slices;
    pl.slices = (pl.nchunks + pl.cpb - 1) / pl.cpb;
    pl.scratch = (size_t)pl.tiles * pl.slices * ST * ST * sizeof(float);
    return pl;
}

}  // namespace

// The plan krum_distances_launch takes for (m, p) on the current device:
// 0 small, 1 split.
extern "C" int krum_plan_kind(int m, int p) { return small(m, p) ? 0 : 1; }

// Bytes of scratch plan `kind` needs for x (m, p) (0 for the small plan).
extern "C" long long krum_scratch_bytes(int m, int p, int kind) {
    return kind == 0 ? 0 : static_cast<long long>(split_plan(m, p).scratch);
}

// x (m, p) f32 row-major; d (m, m) f32 out; kind: krum_plan_kind(m, p), or
// the other plan to time the two against each other; scratch:
// krum_scratch_bytes(m, p, kind) bytes (null when that is 0).  m, p > 0.
// Returns cudaGetLastError().
extern "C" int krum_distances_launch(const float* x, int m, int p, int kind,
                                     void* scratch, float* d, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int el = copy_width(x, p);
    if (kind == 0) {
        if (static_cast<long long>(m) * (m + 1) / 2 > (1ll << 26))
            return static_cast<int>(cudaErrorInvalidValue);
        const int pairs = m * (m + 1) / 2;
        const int blocks = (pairs + SMALL_WARPS - 1) / SMALL_WARPS;
        if (el == 4)
            krum_pair_kernel<4><<<blocks, 32 * SMALL_WARPS, 0, s>>>(x, m, p, pairs, d);
        else if (el == 2)
            krum_pair_kernel<2><<<blocks, 32 * SMALL_WARPS, 0, s>>>(x, m, p, pairs, d);
        else
            krum_pair_kernel<1><<<blocks, 32 * SMALL_WARPS, 0, s>>>(x, m, p, pairs, d);
        return static_cast<int>(cudaGetLastError());
    }
    const SplitPlan pl = split_plan(m, p);
    cudaError_t err = cudaFuncSetAttribute(
        krum_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    float* part = static_cast<float*>(scratch);
    krum_partial_kernel<<<dim3(pl.tiles, pl.slices), S_THREADS, S_SMEM, s>>>(
        x, m, p, el, pl.nt, pl.nchunks, pl.cpb, part);
    krum_sum_kernel<<<dim3(pl.tiles, ST / R_ROWS), R_ROWS * ST, 0, s>>>(
        part, m, pl.nt, pl.slices, d);
    return static_cast<int>(cudaGetLastError());
}
