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
// similarity: V is summed in the order common.cuh fixes (chunks of KS
//   columns, each chunk's partial in ascending k with __fmul_rn/__fadd_rn,
//   the partials added in ascending chunk order from 0): the order of the
//   fused kernel and of `kernels/ref.similarity_ref`, so V is bitwise
//   theirs.  What bounds it: the N(N+1)/2·d multiply-adds of the upper
//   triangle (the bytes are U in and V out); with no FMA and no TF32 each
//   multiply-add is two instructions, so the f32 CUDA-core issue rate is
//   the ceiling.  Only the upper triangle's tiles are computed; each
//   off-diagonal tile writes V_ij and, through a transpose in shared
//   memory, V_ji (the same products in the same order, so the mirror is
//   exact).  Three plans, chosen from N, d and the SM count:
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
//   split plan shares): it stages half a chunk of its rows at a time in shared
//   memory with cp.async copies (16, 8 or 4 bytes, as U's row alignment
//   allows), all in flight at once (128 threads, a 4x2 register tile per
//   thread read as float4 over 4 columns; 33 KB, so 6 blocks share an SM
//   and hide each other's loads), and a warp whose columns all lie past N
//   skips the products.
//   * big: when the upper triangle's 128x128 tiles fill the card twice
//     (N >= ~2900), one block per tile, 256 threads with an 8x8 register
//     tile each (the partial and the accumulator), U staged 16 columns at a
//     time through a double-buffered shared-memory ring with the next
//     step's global loads in flight during the current step's products.
//   Zero padding never changes a sum: a padded column is 0 in both
//   operands, its product is +0, and a partial that starts at +0 is never
//   -0, so adding +0 leaves it bit for bit as it was (NaN and inf too).
// adjacency: one thread per entry, common.cuh's adjacency_entry (the fused
//   kernel's epilogue), with lo/hi read from a device buffer (reduced by
//   the caller, no host sync).  Given the same V and lo/hi, R is bitwise the
//   fused kernel's.  What bounds it: the bytes, V in and R out.
#include <algorithm>

#include "common.cuh"
#include "tile32.cuh"

namespace {

using fedgs::KS;
using namespace fedgs::tile32;

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
//   gridDim.y, ST, ST).
__global__ void __launch_bounds__(S_THREADS)
similarity_tile32_kernel(const float* __restrict__ u, int n, int d, int el,
                         int nt, int nchunks, int c0,
                         float* __restrict__ part, float* __restrict__ v) {
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
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
            const int i = i0 + ty + 8 * a, j = j0 + tx + 16 * b;
            if (i < n && j < n) v[(size_t)i * n + j] = acc[a][b];
        }
    if (diag) return;
    float* ts = smem;                        // ST x (ST + 1): V_ji
    __syncthreads();                         // the staged rows are consumed
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

// The split plan's second launch: the window's wc partials added in
// ascending chunk order onto 0 (the first window) or onto the V_ij the last
// window wrote (the running sum), one thread per entry of R_ROWS rows of a
// tile (grid (upper tiles, ST / R_ROWS)), RB partials in flight per thread;
// then V_ij and, through shared memory, V_ji.  No float atomics: the sum
// does not depend on the order the first launch's blocks ran in.
__global__ void __launch_bounds__(R_ROWS * ST)
similarity_sum_kernel(const float* __restrict__ part, int n, int nt,
                      int wc, bool first, float* __restrict__ v) {
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
    if (in) v[(size_t)i * n + j] = acc;
    if (ti == tj) return;
    ts[c][r - rq] = acc;
    __syncthreads();
    const int jr = threadIdx.x / R_ROWS, ic = threadIdx.x % R_ROWS;
    const int jj = tj * ST + jr, ii = ti * ST + rq + ic;   // V[jj][ii]
    if (jj < n && ii < n) v[(size_t)jj * n + ii] = ts[jr][ic];
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
__global__ void __launch_bounds__(B_THREADS, 1)
similarity_big_kernel(const float* __restrict__ u, int n, int d, int nt,
                      float* __restrict__ v) {
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
    if (diag) return;
    // V_ji through shared memory, a slab of 32 tile rows at a time: slab
    // s holds rows (s & 2 ? 64 : 0) + (s & 1 ? 32 : 0) + [0, 32), owned by
    // the threads with ty / 8 == (s & 1) through their x & 4 == (s & 2)*2
    float* ts = &ring[0][0][0][0];            // 32 x (BT + 1) floats
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

// The plan for (n, d) on the current device.
struct Plan {
    bool big;
    int nt, tiles, nchunks, window;   // window: chunks per launch pair (split)
    size_t scratch;                   // bytes of one window's partials
};

Plan plan(int n, int d) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    Plan p{};
    p.nchunks = (d + KS - 1) / KS;
    const int nt128 = (n + BT - 1) / BT;
    if (nt128 * (nt128 + 1) / 2 >= 2 * sms) {      // 128-tiles fill the card twice
        p.big = true;
        p.nt = nt128;
        p.tiles = nt128 * (nt128 + 1) / 2;
        return p;
    }
    p.nt = (n + ST - 1) / ST;
    p.tiles = p.nt * (p.nt + 1) / 2;
    // split the chunks over blocks while the tiles alone are under 4 blocks
    // per SM, as many chunks at a time as SCRATCH_MAX bytes of partials hold
    if (p.nchunks > 1 && p.tiles < 4 * sms) {
        const size_t per_chunk = (size_t)p.tiles * ST * ST * sizeof(float);
        p.window = static_cast<int>(std::min<size_t>(
            {(size_t)p.nchunks, std::max<size_t>(1, SCRATCH_MAX / per_chunk),
             65535}));
        p.scratch = per_chunk * p.window;
    }
    return p;
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

int launch(const Plan& p, const float* u, int n, int d, float* v,
           void* scratch, cudaStream_t s) {
    if (p.big) {
        similarity_big_kernel<<<p.tiles, B_THREADS, 0, s>>>(u, n, d, p.nt, v);
        return static_cast<int>(cudaGetLastError());
    }
    cudaError_t err = cudaFuncSetAttribute(
        similarity_tile32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int el = copy_width(u, d);
    if (p.window == 0) {
        similarity_tile32_kernel<<<p.tiles, S_THREADS, S_SMEM, s>>>(
            u, n, d, el, p.nt, p.nchunks, 0, nullptr, v);
        return static_cast<int>(cudaGetLastError());
    }
    float* part = static_cast<float*>(scratch);
    for (int c0 = 0; c0 < p.nchunks; c0 += p.window) {
        const int wc = std::min(p.window, p.nchunks - c0);
        similarity_tile32_kernel<<<dim3(p.tiles, wc), S_THREADS, S_SMEM, s>>>(
            u, n, d, el, p.nt, p.nchunks, c0, part, v);
        similarity_sum_kernel<<<dim3(p.tiles, ST / R_ROWS), R_ROWS * ST, 0, s>>>(
            part, n, p.nt, wc, c0 == 0, v);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch similarity_launch needs for u (n, d) on the current
// device (0 when the plan does not split).
extern "C" long long similarity_scratch_bytes(int n, int d) {
    return static_cast<long long>(plan(n, d).scratch);
}

// The plan similarity_launch takes for (n, d) on the current device:
// 0 serial, 1 split, 2 big.
extern "C" int similarity_plan_kind(int n, int d) {
    const Plan p = plan(n, d);
    return p.big ? 2 : p.window ? 1 : 0;
}

// u (n, d) f32 row-major; v (n, n) f32 out; scratch: similarity_scratch_
// bytes(n, d) bytes (may be null when that is 0).
// Returns cudaGetLastError().
extern "C" int similarity_launch(const float* u, int n, int d, float* v,
                                 void* scratch, void* stream) {
    return launch(plan(n, d), u, n, d, v, scratch,
                  static_cast<cudaStream_t>(stream));
}

// The serial plan at any (n, d): the same V as similarity_launch, bit for
// bit; it exists to time the plans against each other.
extern "C" int similarity_serial_launch(const float* u, int n, int d,
                                        float* v, void* stream) {
    Plan p{};
    p.nchunks = (d + KS - 1) / KS;
    p.nt = (n + ST - 1) / ST;
    p.tiles = p.nt * (p.nt + 1) / 2;
    return launch(p, u, n, d, v, nullptr, static_cast<cudaStream_t>(stream));
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
