// The similarity V = U·Uᵀ's tile kernels and their plan, shared by the
// staged similarity (pairwise_similarity.cu) and the fused 3DG adjacency
// (graph_fused.cu).
//
// V is summed in the order common.cuh fixes (chunks of KS columns, each
// chunk's partial in ascending k with __fmul_rn/__fadd_rn, the partials
// added in ascending chunk order from 0), so every plan's V is bitwise
// `kernels/ref.similarity_ref`'s.  Only the upper triangle's tiles are
// computed; each off-diagonal tile writes V_ij and, through a transpose in
// shared memory, V_ji (the same products in the same order, so the mirror
// is exact).  Three plans, chosen from N, d and the SM count (plan()):
//   * split: when the 32x32 tiles of the upper triangle are too few to
//     fill the card (N = 100: 10 tiles), one block per (tile, chunk)
//     writes its chunk's partial to a scratch buffer, and a second launch
//     adds each entry's partials in ascending chunk order (one thread per
//     entry, 32 partials in flight) and writes the tile.  No float atomics:
//     the result does not depend on the block order.  The chunks go in
//     windows whose partials fit SCRATCH_MAX bytes (and gridDim.y), a pair
//     of launches per window; a window's sum starts from the V the last
//     one wrote, which is the running sum itself, so any d keeps the order.
//   * serial: 32x32 tiles that fill the card alone; each block runs the
//     chunks in series (acc = acc + partial), no scratch.
//   In both, a block computes its tile through tile32.cuh (which Krum's
//   split plan shares): it stages half a chunk of its rows at a time in
//   shared memory with cp.async copies, 128 threads with a 4x2 register
//   tile each.
//   * big: when the upper triangle's 128x128 tiles fill the card twice
//     (N >= ~2900), one block per tile, 256 threads with an 8x8 register
//     tile each (the partial and the accumulator), U staged 16 columns at a
//     time through a double-buffered shared-memory ring with the next
//     step's global loads in flight during the current step's products.
//   Zero padding never changes a sum: a padded column is 0 in both
//   operands, its product is +0, and a partial that starts at +0 is never
//   -0, so adding +0 leaves it bit for bit as it was (NaN and inf too).
//
// Each kernel has two instances.  FUSED false is the staged similarity: it
// writes V.  FUSED true is the fused adjacency's tile pass: where a tile's
// V is final it is clamped to >= 0 if `clamp` is set and written into R's
// own buffer (the split plan's partial launch is the same in both; its sum
// launch of the last window is where V is final), every block folds the
// order-preserving keys (common.cuh f2key) of its valid entries into lo/hi
// and meets the others in a 16-byte state (arrive()): the last block to
// arrive writes stats = [lo, hi], re-zeroes the state and, with
// `epilogue`, turns every V of R into R in place itself.  min and max are
// associative, so lo/hi are exact whatever the block order.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "tile32.cuh"

namespace fedgs {
namespace sim {

using namespace tile32;

// ------------------------------------------------------ the fused tile pass
// What the fused adjacency adds to a similarity launch.
struct Fuse {
    unsigned int* state;   // 4 x uint32, zero at rest: ~lo key, hi key,
                           // arrivals, unused (kernels/solver.py keeps one
                           // per stream and per CUDA-graph capture)
    float* stats;          // (2,) out: [lo, hi]
    int clamp;             // V = max(V, 0) (Eq. 11/12's functional similarity)
    int epilogue;          // 1: the last block to arrive turns V into R
    float eps, sigma2;
};

// One thread's lo/hi keys over the entries of V it holds.
struct Keys {
    uint32_t lo = 0xffffffffu, hi = 0u;
    __device__ __forceinline__ void add(float v) {
        const uint32_t k = f2key(v);
        lo = min(lo, k);
        hi = max(hi, k);
    }
};

__device__ __forceinline__ float clamped(float v, const Fuse& fz) {
    return fz.clamp ? fmaxf(v, 0.0f) : v;
}

// V -> R in place over all n x n entries of r by one block: L entries of a
// thread in flight at a time, read through L2 (other blocks wrote them).
__device__ __forceinline__ void epilogue_block(float* r, int n, float lo,
                                               float hi, float eps,
                                               float sigma2) {
    constexpr int L = 8;
    const float range = fmaxf(__fsub_rn(hi, lo), 1e-12f);
    const uint32_t nn = static_cast<uint32_t>(n) * static_cast<uint32_t>(n);
    const uint32_t step = blockDim.x * L;
    for (uint32_t base = threadIdx.x; base < nn; base += step) {
        float v[L];
#pragma unroll
        for (int e = 0; e < L; ++e) {
            const uint32_t f = base + e * blockDim.x;
            v[e] = f < nn ? __ldcg(r + f) : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < L; ++e) {
            const uint32_t f = base + e * blockDim.x;
            if (f < nn) {
                const uint32_t i = f / static_cast<uint32_t>(n);
                r[f] = adjacency_entry(v[e], lo, range, eps, sigma2,
                                       f == i * static_cast<uint32_t>(n) + i);
            }
        }
    }
}

// Every thread of the block calls it after its last write of V, with its
// keys (1-D blocks of whole warps).  Each thread fences its own writes of V
// before the block's arrival, so the last block to arrive sees all of V.
__device__ __forceinline__ void arrive(Keys k, const Fuse& fz, int n,
                                       float* r) {
    __shared__ uint32_t slo[32], shi[32];
    __shared__ float sstat[2];
    __shared__ int slast;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t lo = __reduce_min_sync(0xffffffffu, k.lo);
    const uint32_t hi = __reduce_max_sync(0xffffffffu, k.hi);
    if (lane == 0) {
        slo[warp] = lo;
        shi[warp] = hi;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t blo = slo[0], bhi = shi[0];
        for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
            blo = min(blo, slo[w]);
            bhi = max(bhi, shi[w]);
        }
        atomicMax(&fz.state[0], ~blo);        // max of ~key: min of key
        atomicMax(&fz.state[1], bhi);
        __threadfence();
        slast = atomicAdd(&fz.state[2], 1u) == gridDim.x * gridDim.y - 1;
        if (slast) {
            __threadfence();
            const float flo = key2f(~atomicExch(&fz.state[0], 0u));
            const float fhi = key2f(atomicExch(&fz.state[1], 0u));
            atomicExch(&fz.state[2], 0u);
            fz.stats[0] = sstat[0] = flo;
            fz.stats[1] = sstat[1] = fhi;
        }
    }
    __syncthreads();
    if (slast && fz.epilogue)
        epilogue_block(r, n, sstat[0], sstat[1], fz.eps, fz.sigma2);
}

// V -> R with common.cuh's adjacency_entry and lo/hi read from stats (2,)
// on the device, over the flat n x n array, a thread for every access and
// no loop around it: single entries (W = 1) up to ADJ_ENTRIES_MOST
// entries, 16-byte vectors (W = 4) beyond, with a scalar head up to v's
// first 16-byte boundary and a scalar tail (W = 1 also where v and r are
// not 16-byte aligned alike).  On an H100 one access a thread beats a
// grid-stride loop on a few blocks per SM at every N timed, and single
// entries beat vectors at small N (PERF.md §6): each
// entry's two IEEE divisions branch to their slow path, so a thread's
// entries run one after another.  Entry f is on the diagonal exactly when
// f % (n + 1) == 0: one residue a thread (32-bit while f < 2^32), no
// division per entry; the head's diagonal entry is f = 0, the tail's
// f = n² − 1 (n² ≡ 1 mod n + 1).  The staged route reads V from its own
// buffer; the fused route passes r == v and turns V into R in place (each
// thread reads its access, then writes the same one, so v and r carry no
// __restrict__).  What bounds it: the bytes, V in and R out.
constexpr int ADJ_THREADS = 256;
constexpr long long ADJ_ENTRIES_MOST = 1 << 18;   // single entries up to N = 512

// The adjacency kernel's grid for n (kernels/pairwise_similarity.py
// adjacency_grid mirrors it): (W, blocks), a thread for every access;
// `width` 1 forces single entries.  Blocks fit an int for any n x n array
// that fits in memory.
struct AdjGrid {
    int width, blocks;
};

inline AdjGrid adjacency_grid(int n, int width = 0) {
    const long long nn = (long long)n * n;
    if (width == 0) width = nn <= ADJ_ENTRIES_MOST ? 1 : 4;
    const long long acc = (nn + width - 1) / width;
    return {width, static_cast<int>(
                       std::max(1ll, (acc + ADJ_THREADS - 1) / ADJ_THREADS))};
}

template <int W> struct AdjVec;
template <> struct AdjVec<1> { using T = float; };
template <> struct AdjVec<4> { using T = float4; };

// head < 4 scalar entries, then nvec vectors of W, then the scalar tail;
// the grid has a thread for every vector.
template <int W>
__global__ void __launch_bounds__(ADJ_THREADS)
adjacency_kernel(const float* v, int n, int head, long long nvec,
                 const float* __restrict__ stats, float eps, float sigma2,
                 float* r) {
    using V = typename AdjVec<W>::T;
    const float lo = stats[0], hi = stats[1];
    const float range = fmaxf(__fsub_rn(hi, lo), 1e-12f);
    const uint32_t np1 = static_cast<uint32_t>(n) + 1u;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if constexpr (W == 4) {                      // (single entries: none)
        const long long nn = (long long)n * n, tail = head + W * nvec;
        if (t < head)
            r[t] = adjacency_entry(v[t], lo, range, eps, sigma2, t == 0);
        if (t < nn - tail) {
            const long long f = tail + t;
            r[f] = adjacency_entry(v[f], lo, range, eps, sigma2, f == nn - 1);
        }
    }
    if (t >= nvec) return;
    V x = reinterpret_cast<const V*>(v + head)[t];
    const unsigned long long f0 = head + (unsigned long long)W * t;
    const uint32_t q = f0 >> 32 ? static_cast<uint32_t>(f0 % np1)
                                : static_cast<uint32_t>(f0) % np1;
    float* e = reinterpret_cast<float*>(&x);
    e[0] = adjacency_entry(e[0], lo, range, eps, sigma2, q == 0);
#pragma unroll
    for (int k = 1; k < W; ++k)          // (q + k) % (n + 1) == 0, q <= n
        e[k] = adjacency_entry(e[k], lo, range, eps, sigma2, q + k == np1);
    reinterpret_cast<V*>(r + head)[t] = x;
}

inline int launch_adjacency(const float* v, int n, const float* stats,
                            float eps, float sigma2, float* r,
                            cudaStream_t s) {
    const long long nn = (long long)n * n;
    const uintptr_t av = reinterpret_cast<uintptr_t>(v);
    const uintptr_t ar = reinterpret_cast<uintptr_t>(r);
    const AdjGrid g = adjacency_grid(n);
    if (g.width == 4 && av % 4 == 0 && (av - ar) % 16 == 0) {
        const int head = static_cast<int>(
            std::min<long long>(nn, ((16 - av % 16) % 16) / 4));
        adjacency_kernel<4><<<g.blocks, ADJ_THREADS, 0, s>>>(
            v, n, head, (nn - head) / 4, stats, eps, sigma2, r);
    } else {
        adjacency_kernel<1><<<adjacency_grid(n, 1).blocks, ADJ_THREADS, 0,
                              s>>>(v, n, 0, nn, stats, eps, sigma2, r);
    }
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- split / serial plans
// (the tile, its staging and its chunk sums: tile32.cuh)
constexpr int R_ROWS = 8;            // tile rows per block of the ordered sum
constexpr int RB = 32;               // partials in flight per thread there
constexpr size_t SCRATCH_MAX = 64u << 20;   // bytes of one window's partials

// One 32 x 32 upper-triangle tile per block (tile32_chunks).
// part null, serial plan: grid (upper tiles, 1); each block runs the chunks
//   in series and writes V_ij and, through a transpose in shared memory,
//   V_ji;
// part given, split plan: grid (upper tiles, chunks of the window); block
//   (t, y) writes the partial of chunk c0 + y of tile t to part (tiles,
//   gridDim.y, ST, ST) (FUSED false: the fused route's partials are the
//   staged route's).
template <bool FUSED>
__global__ void __launch_bounds__(S_THREADS)
similarity_tile32_kernel(const float* __restrict__ u, int n, int d, int el,
                         int nt, int nchunks, int c0,
                         float* __restrict__ part, float* __restrict__ v,
                         Fuse fz) {
    extern __shared__ __align__(16) float smem[];
    int ti, tj;
    upper_tile(blockIdx.x, nt, ti, tj);
    const int i0 = ti * ST, j0 = tj * ST;
    const bool diag = ti == tj, split = part != nullptr;
    const int tid = threadIdx.x, tx = tid >> 3, ty = tid & 7;
    const int c_lo = split ? c0 + blockIdx.y : 0;
    const int c_hi = split ? c_lo + 1 : nchunks;
    float acc[4][2];
    tile32_chunks(u, n, d, el, i0, j0, diag, c_lo, c_hi, smem, acc);
    if (split) {                             // acc is 0 + P_c = P_c
        float* mine = part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * (ST * ST);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
                mine[(ty + 8 * a) * ST + tx + 16 * b] = acc[a][b];
        return;
    }
    Keys keys;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
            const int i = i0 + ty + 8 * a, j = j0 + tx + 16 * b;
            if (FUSED) acc[a][b] = clamped(acc[a][b], fz);
            if (i < n && j < n) {
                v[(size_t)i * n + j] = acc[a][b];
                if (FUSED) keys.add(acc[a][b]);
            }
        }
    if (!diag) {
        float* ts = smem;                    // ST x (ST + 1): V_ji
        __syncthreads();                     // the staged rows are consumed
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
                ts[(tx + 16 * b) * (ST + 1) + ty + 8 * a] = acc[a][b];
        __syncthreads();
        for (int e = tid; e < ST * ST; e += S_THREADS) {
            const int jr = e / ST, ic = e % ST;  // V[j0 + jr][i0 + ic]
            if (j0 + jr < n && i0 + ic < n)
                v[(size_t)(j0 + jr) * n + i0 + ic] = ts[jr * (ST + 1) + ic];
        }
    }
    if constexpr (FUSED) arrive(keys, fz, n, v);
}

// The split plan's second launch: the window's wc partials added in
// ascending chunk order onto 0 (the first window) or onto the V_ij the last
// window wrote (the running sum), one thread per entry of R_ROWS rows of a
// tile (grid (upper tiles, ST / R_ROWS)), RB partials in flight per thread;
// then V_ij and, through shared memory, V_ji.  No float atomics: the sum
// does not depend on the order the first launch's blocks ran in.  FUSED:
// the last window's launch (`last`) clamps, folds and arrives.
template <bool FUSED>
__global__ void __launch_bounds__(R_ROWS * ST)
similarity_sum_kernel(const float* __restrict__ part, int n, int nt,
                      int wc, bool first, bool last, float* __restrict__ v,
                      Fuse fz) {
    __shared__ float ts[ST][R_ROWS + 1];
    int ti, tj;
    upper_tile(blockIdx.x, nt, ti, tj);
    const int rq = blockIdx.y * R_ROWS;      // the block's first tile row
    const int r = rq + threadIdx.x / ST, c = threadIdx.x % ST;
    const float* pe = part + (size_t)blockIdx.x * wc * (ST * ST) + r * ST + c;
    const int i = ti * ST + r, j = tj * ST + c;
    const bool in = i < n && j < n;
    float acc = (first || !in) ? 0.0f : v[(size_t)i * n + j];
    for (int c0 = 0; c0 < wc; c0 += RB) {
        float buf[RB];
#pragma unroll
        for (int cc = 0; cc < RB; ++cc)
            buf[cc] = c0 + cc < wc ? __ldg(pe + (size_t)(c0 + cc) * (ST * ST)) : 0.0f;
#pragma unroll
        for (int cc = 0; cc < RB; ++cc)
            if (c0 + cc < wc) acc = __fadd_rn(acc, buf[cc]);
    }
    Keys keys;
    if (FUSED && last) {
        acc = clamped(acc, fz);
        if (in) keys.add(acc);
    }
    if (in) v[(size_t)i * n + j] = acc;
    if (ti != tj) {
        ts[c][r - rq] = acc;
        __syncthreads();
        const int jr = threadIdx.x / R_ROWS, ic = threadIdx.x % R_ROWS;
        const int jj = tj * ST + jr, ii = ti * ST + rq + ic;   // V[jj][ii]
        if (jj < n && ii < n) v[(size_t)jj * n + ii] = ts[jr][ic];
    }
    if constexpr (FUSED) {
        if (last) arrive(keys, fz, n, v);
    }
}

// ------------------------------------------------------------ big plan
constexpr int BT = 128;              // output tile edge
constexpr int BK = 16;               // columns of U per shared-memory step
constexpr int B_THREADS = 256;       // 16 x 16 threads, 8 x 8 outputs each
constexpr int BSTR = BT + 4;         // shared row stride: float4 reads aligned
static_assert(KS % BK == 0, "a chunk of KS columns is whole steps of BK");

// thread (ty, tx) holds rows ty*4 + a and 64 + ty*4 + a (a < 4), columns
// tx*4 + b and 64 + tx*4 + b (b < 4): row index R(x) = (x & 4 ? 64 : 0) +
// ty*4 + (x & 3) for x < 8, likewise for columns.
template <bool FUSED>
__global__ void __launch_bounds__(B_THREADS, 1)
similarity_big_kernel(const float* __restrict__ u, int n, int d, int nt,
                      float* __restrict__ v, Fuse fz) {
    // [operand][buffer][column][row]: operand 0 rows i0.., 1 rows j0..
    __shared__ __align__(16) float ring[2][2][BK][BSTR];
    int ti, tj;
    upper_tile(blockIdx.x, nt, ti, tj);
    const int i0 = ti * BT, j0 = tj * BT;
    const bool diag = ti == tj;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

    // loader: element e = tid + 256*q is (row e / BK, column e % BK)
    constexpr int NQ = BT * BK / B_THREADS;
    float ra[NQ], rb[NQ];
    auto load = [&](int k0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const int e = tid + B_THREADS * q, r = e / BK, k = k0 + e % BK;
            ra[q] = (i0 + r < n && k < d) ? __ldg(u + (size_t)(i0 + r) * d + k) : 0.0f;
            rb[q] = (j0 + r < n && k < d) ? __ldg(u + (size_t)(j0 + r) * d + k) : 0.0f;
        }
    };
    auto store = [&](int buf) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const int e = tid + B_THREADS * q;
            ring[0][buf][e % BK][e / BK] = ra[q];
            ring[1][buf][e % BK][e / BK] = rb[q];
        }
    };

    float acc[8][8], p[8][8];
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = p[x][y] = 0.0f;
    const int nsteps = (d + BK - 1) / BK;
    load(0);
    store(0);
    __syncthreads();
    for (int s = 0; s < nsteps; ++s) {
        const int buf = s & 1;
        if (s + 1 < nsteps) load((s + 1) * BK);   // in flight during the products
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&ring[0][buf][k][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&ring[0][buf][k][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&ring[1][buf][k][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&ring[1][buf][k][64 + tx * 4]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int x = 0; x < 8; ++x)
#pragma unroll
                for (int y = 0; y < 8; ++y)
                    p[x][y] = __fadd_rn(p[x][y], __fmul_rn(av[x], bv[y]));
        }
        if ((s + 1) * BK % KS == 0 || s + 1 == nsteps) {   // a chunk ends
#pragma unroll
            for (int x = 0; x < 8; ++x)
#pragma unroll
                for (int y = 0; y < 8; ++y) {
                    acc[x][y] = __fadd_rn(acc[x][y], p[x][y]);
                    p[x][y] = 0.0f;
                }
        }
        if (s + 1 < nsteps) store(buf ^ 1);   // buf ^ 1 was consumed last step
        __syncthreads();
    }

    Keys keys;
    if constexpr (FUSED) {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
            const int i = i0 + (x & 4 ? 64 : 0) + ty * 4 + (x & 3);
#pragma unroll
            for (int y = 0; y < 8; ++y) {
                const int j = j0 + (y & 4 ? 64 : 0) + tx * 4 + (y & 3);
                acc[x][y] = clamped(acc[x][y], fz);
                if (i < n && j < n) keys.add(acc[x][y]);
            }
        }
    }
    const bool vec = (n & 3) == 0;            // rows of V 16-byte aligned
#pragma unroll
    for (int x = 0; x < 8; ++x) {
        const int i = i0 + (x & 4 ? 64 : 0) + ty * 4 + (x & 3);
        if (i >= n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int j = j0 + h * 64 + tx * 4;
            float* dst = v + (size_t)i * n + j;
            if (vec && j + 3 < n) {
                *reinterpret_cast<float4*>(dst) = make_float4(
                    acc[x][4 * h], acc[x][4 * h + 1], acc[x][4 * h + 2],
                    acc[x][4 * h + 3]);
            } else {
#pragma unroll
                for (int y = 0; y < 4; ++y)
                    if (j + y < n) dst[y] = acc[x][4 * h + y];
            }
        }
    }
    if (!diag) {
        // V_ji through shared memory, a slab of 32 tile rows at a time: slab
        // s holds rows (s & 2 ? 64 : 0) + (s & 1 ? 32 : 0) + [0, 32), owned by
        // the threads with ty / 8 == (s & 1) through their x & 4 == (s & 2)*2
        float* ts = &ring[0][0][0][0];        // 32 x (BT + 1) floats
        static_assert(32 * (BT + 1) <= 2 * 2 * BK * BSTR, "a slab fits the ring");
        for (int s = 0; s < 4; ++s) {
            const int rbase = (s & 2 ? 64 : 0) + (s & 1 ? 32 : 0);
            if ((ty >> 3) == (s & 1)) {
#pragma unroll
                for (int x = 0; x < 8; ++x) {
                    if (((x & 4) != 0) != ((s & 2) != 0)) continue;
                    const int r = (ty & 7) * 4 + (x & 3);     // row within the slab
#pragma unroll
                    for (int y = 0; y < 8; ++y) {
                        const int c = (y & 4 ? 64 : 0) + tx * 4 + (y & 3);
                        ts[r * (BT + 1) + c] = acc[x][y];
                    }
                }
            }
            __syncthreads();
            for (int e = tid; e < 32 * BT; e += B_THREADS) {
                const int c = e >> 5, r = e & 31;    // V[j0 + c][i0 + rbase + r]
                if (j0 + c < n && i0 + rbase + r < n)
                    v[(size_t)(j0 + c) * n + i0 + rbase + r] = ts[r * (BT + 1) + c];
            }
            __syncthreads();
        }
    }
    if constexpr (FUSED) arrive(keys, fz, n, v);
}

// -------------------------------------------------------------- the plan
enum Kind { SERIAL = 0, SPLIT = 1, BIG = 2 };

struct Plan {
    int kind;
    int nt, tiles, nchunks, window;   // window: chunks per launch pair (split)
    size_t scratch;                   // bytes of one window's partials
};

inline int sm_count() {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

inline Plan serial_plan(int n, int d) {
    Plan p{};
    p.kind = SERIAL;
    p.nchunks = (d + KS - 1) / KS;
    p.nt = (n + ST - 1) / ST;
    p.tiles = p.nt * (p.nt + 1) / 2;
    return p;
}

// the chunks split over blocks, as many at a time as SCRATCH_MAX bytes of
// partials hold (d >= 1)
inline Plan split_plan(int n, int d) {
    Plan p = serial_plan(n, d);
    p.kind = SPLIT;
    const size_t per_chunk = (size_t)p.tiles * ST * ST * sizeof(float);
    p.window = static_cast<int>(std::min<size_t>(
        {(size_t)p.nchunks, std::max<size_t>(1, SCRATCH_MAX / per_chunk),
         65535}));
    p.scratch = per_chunk * p.window;
    return p;
}

inline Plan big_plan(int n, int d) {
    Plan p{};
    p.kind = BIG;
    p.nchunks = (d + KS - 1) / KS;
    p.nt = (n + BT - 1) / BT;
    p.tiles = p.nt * (p.nt + 1) / 2;
    return p;
}

// The plan for (n, d) on the current device: big where the 128-tiles fill
// the card twice, else split while the 32-tiles alone are under 4 blocks
// per SM and there is more than one chunk, else serial.
inline Plan plan(int n, int d) {
    const int sms = sm_count();
    const int nt128 = (n + BT - 1) / BT;
    if (nt128 * (nt128 + 1) / 2 >= 2 * sms) return big_plan(n, d);
    const Plan p = serial_plan(n, d);
    return (p.nchunks > 1 && p.tiles < 4 * sms) ? split_plan(n, d) : p;
}

// Launch plan p: V into v (FUSED false), or the fused tile pass into r = v.
// scratch: p.scratch bytes (the split plan).  Returns cudaGetLastError().
template <bool FUSED>
int launch(const Plan& p, const float* u, int n, int d, float* v,
           void* scratch, cudaStream_t s, const Fuse& fz) {
    if (p.kind == BIG) {
        similarity_big_kernel<FUSED><<<p.tiles, B_THREADS, 0, s>>>(
            u, n, d, p.nt, v, fz);
        return static_cast<int>(cudaGetLastError());
    }
    cudaError_t err = cudaFuncSetAttribute(
        similarity_tile32_kernel<FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int el = copy_width(u, d);
    if (p.kind == SERIAL) {
        similarity_tile32_kernel<FUSED><<<p.tiles, S_THREADS, S_SMEM, s>>>(
            u, n, d, el, p.nt, p.nchunks, 0, nullptr, v, fz);
        return static_cast<int>(cudaGetLastError());
    }
    if (p.window < 1) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(
        similarity_tile32_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    float* part = static_cast<float*>(scratch);
    for (int c0 = 0; c0 < p.nchunks; c0 += p.window) {
        const int wc = std::min(p.window, p.nchunks - c0);
        similarity_tile32_kernel<false><<<dim3(p.tiles, wc), S_THREADS, S_SMEM, s>>>(
            u, n, d, el, p.nt, p.nchunks, c0, part, v, fz);
        similarity_sum_kernel<FUSED><<<dim3(p.tiles, ST / R_ROWS), R_ROWS * ST, 0, s>>>(
            part, n, p.nt, wc, c0 == 0, c0 + wc == p.nchunks, v, fz);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace sim
}  // namespace fedgs
