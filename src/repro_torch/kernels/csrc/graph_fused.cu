// Fused 3DG adjacency: similarity -> min-max stats -> adjacency, with the
// similarity V = U·Uᵀ never in a buffer of its own.
//
// Replaces repro/kernels/graph_fused.py `_fused_kernel` /
// `fused_adjacency_pallas` (a two-phase sequential TPU grid whose phase-0
// stats sit in a resident accumulator block, and whose phase 1 recomputes
// every V tile).  CUDA blocks run in no order and nothing carries over
// between them, so here:
//   tile pass  computes each product once: only the upper triangle's tiles,
//              each mirrored (similarity.cuh, the staged similarity's own
//              tile kernels and plan, in their FUSED instances).  Where a
//              tile's V is final it goes, clamped to >= 0 for the
//              functional similarity, straight into the R output, and the
//              block folds its entries' order-preserving keys into lo/hi.
//              The blocks meet in a 16-byte (~lo, hi, arrivals) state that
//              kernels/solver.py keeps per stream and per CUDA-graph
//              capture: the last block to arrive writes stats = [lo, hi]
//              and re-zeroes the state, so no call needs a memset.
//   epilogue   turns V into R in place with common.cuh's adjacency_entry:
//              for small N the last block to arrive does it itself, and the
//              call is one launch; beyond EPI_LAST_MOST entries the staged
//              route's own adjacency kernel (similarity.cuh), a bytes-bound
//              launch over R, does it in place.
// Plans of the tile pass (fused_adjacency_plan_kind): the staged
// similarity's serial, split and big (similarity.cuh), and `small`, for
// the quickstart's (30, 610): 465 upper entries x 3 chunks of at most 256
// dependent mul+adds each.  There a block stages the rows of U its entries
// need in shared memory (16-, 8- or 4-byte async copies as U's rows allow,
// all in flight, read back as wide at a pitch that keeps a warp's rows in
// distinct banks) and every (entry, chunk)
// chain runs on a thread of its own, the chunks of an entry in one block,
// whose partials are then added in ascending chunk order: many short
// blocks whose chains overlap, instead of one block stepping through the
// columns behind barriers.
// V accumulates in the order common.cuh fixes (chunks of KS columns, each
// partial in ascending k with __fmul_rn/__fadd_rn, the partials added in
// ascending chunk order from 0) on every plan, so R is bitwise the staged
// R and lo/hi bitwise the plain version's.
//
// What bounds it on the card: the N(N+1)/2·d multiply-adds of the product
// (the bytes are only U in and R out, V written and read once more in R's
// own buffer where a second launch does the epilogue).
#include <type_traits>

#include "similarity.cuh"

namespace {

using fedgs::KS;
using namespace fedgs::sim;

constexpr int SMALL = 3;             // plan kinds: SERIAL, SPLIT, BIG, SMALL
constexpr int SM_THREADS = 256;      // (entry, chunk) lanes of a small block
constexpr int SM_MOST_CHUNKS = 16;   // the small plan takes d <= 4,096
constexpr int SM_MOST_N = 1024;      // and N <= 1,024
constexpr size_t SM_SMEM_MOST = 232448;   // a block's shared memory, at most
// The small plan is taken wherever it fits up to N = SMALL_N: on an H100
// it beats split and serial at every N it takes that was timed (30–65 at
// d = 610, 100 at d = 10; chip_smoke.py's fused_adjacency plan rows).
constexpr int SMALL_N = 128;
// The last block does the epilogue up to this many entries of R (N = 33):
// on an H100 it saves its launch up to N = 33 at d = 610 and costs more
// than the launch from N = 48 (a block of 256 threads over N² entries).
constexpr long long EPI_LAST_MOST = 33 * 33;

struct Small {
    int nchunks, eb, threads;
    size_t smem;
};

// the small plan's blocks for (n, d): eb entries x nchunks chunk lanes, the
// rows of U (at a pitch of at most d + 4 floats), then eb x nchunks partials
Small small_shape(int n, int d) {
    Small s{};
    s.nchunks = std::max(1, (d + KS - 1) / KS);
    s.eb = std::max(1, SM_THREADS / s.nchunks);
    s.threads = (s.eb * s.nchunks + 31) / 32 * 32;
    s.smem = ((size_t)n * (d + 4) + (size_t)s.eb * s.nchunks) * sizeof(float);
    return s;
}

// The shared row pitch for EL-float copies and reads: pitch / EL odd, so
// EL-wide reads of consecutive rows by consecutive lanes fall in distinct
// banks (for EL = 4 a quarter warp's 8 rows, for 2 a half warp's 16, for 1
// a warp's 32).
int small_pitch(int d, int el) {
    int p = (d + el - 1) / el;
    return (p | 1) * el;
}

bool small_takes(int n, int d) {
    const Small s = small_shape(n, d);
    return n <= SM_MOST_N && s.nchunks <= SM_MOST_CHUNKS &&
           s.smem <= SM_SMEM_MOST;
}

// (i, j), i <= j, of upper-triangle entry e of an n x n matrix, row by row:
// row i starts at entry i·n − i(i−1)/2
__device__ __forceinline__ void upper_entry(int e, int n, int& i, int& j) {
    const float b = 2.0f * n + 1.0f;
    int r = static_cast<int>(0.5f * (b - sqrtf(fmaxf(b * b - 8.0f * e, 0.0f))));
    r = max(0, min(n - 1, r));
    while (r > 0 && r * n - r * (r - 1) / 2 > e) --r;
    while (r + 1 < n && (r + 1) * n - (r + 1) * r / 2 <= e) ++r;
    i = r;
    j = r + e - (r * n - r * (r - 1) / 2);
}

// p + a·b over the EL columns of one read, in ascending order (two
// roundings per term: the similarity's order)
__device__ __forceinline__ float madd(float p, float a, float b) {
    return __fadd_rn(p, __fmul_rn(a, b));
}
__device__ __forceinline__ float madd(float p, float2 a, float2 b) {
    return madd(madd(p, a.x, b.x), a.y, b.y);
}
__device__ __forceinline__ float madd(float p, float4 a, float4 b) {
    return fedgs::tile32::madd4<false>(p, a, b);
}

// The small plan: block b takes upper entries [b·eb, (b+1)·eb).  It stages
// rows i_first .. n − 1 of U (its entries' rows and columns) at `pitch`
// (small_pitch) in EL-float async copies, all in flight; thread t = c·eb +
// le runs chunk c of entry le in EL-float shared reads; thread le < eb adds
// its entry's partials in ascending chunk order from 0, writes V_ij and
// V_ji into r and arrives.
template <int EL>
__global__ void __launch_bounds__(SM_THREADS)
fused_small_kernel(const float* __restrict__ u, int n, int d, int nchunks,
                   int eb, int pitch, float* __restrict__ r, Fuse fz) {
    using V = typename std::conditional<
        EL == 4, float4, typename std::conditional<EL == 2, float2, float>::type>::type;
    extern __shared__ __align__(16) float us[];
    const int entries = n * (n + 1) / 2;
    const int e0 = blockIdx.x * eb;
    int r0, jd;
    upper_entry(e0, n, r0, jd);
    const int rows = n - r0;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(us));
    for (int rr = warp; rr < rows; rr += nwarps) {
        const float* src = u + (size_t)(r0 + rr) * d;
        for (int k = lane * EL; k < d; k += 32 * EL)
            asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                         :: "r"(base + 4u * (rr * pitch + k)), "l"(src + k),
                            "n"(4 * EL));
    }
    asm volatile("cp.async.wait_all;\n");
    __syncthreads();

    float* part = us + (size_t)n * pitch;
    const int c = threadIdx.x / eb, le = threadIdx.x - c * eb;
    const int e = e0 + le;
    int i = 0, j = 0;
    if (e < entries) upper_entry(e, n, i, j);
    if (c < nchunks) {
        float p = 0.0f;
        if (e < entries) {
            const V* a = reinterpret_cast<const V*>(us + (i - r0) * pitch + c * KS);
            const V* b = reinterpret_cast<const V*>(us + (j - r0) * pitch + c * KS);
            const int kc = min(KS, d - c * KS) / EL;   // d % EL == 0
#pragma unroll 8
            for (int k = 0; k < kc; ++k) p = madd(p, a[k], b[k]);
        }
        part[c * eb + le] = p;
    }
    __syncthreads();
    Keys keys;
    if (threadIdx.x < eb && e < entries) {
        float acc = 0.0f;
        for (int cc = 0; cc < nchunks; ++cc) acc = __fadd_rn(acc, part[cc * eb + le]);
        acc = clamped(acc, fz);
        r[(size_t)i * n + j] = acc;
        r[(size_t)j * n + i] = acc;
        keys.add(acc);
    }
    arrive(keys, fz, n, r);
}

template <int EL>
int launch_small(const float* u, int n, int d, float* r, cudaStream_t s,
                 const Fuse& fz) {
    const Small sh = small_shape(n, d);
    const cudaError_t e = cudaFuncSetAttribute(
        fused_small_kernel<EL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sh.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int entries = n * (n + 1) / 2;
    fused_small_kernel<EL><<<(entries + sh.eb - 1) / sh.eb, sh.threads,
                             sh.smem, s>>>(u, n, d, sh.nchunks, sh.eb,
                                           small_pitch(d, EL), r, fz);
    return static_cast<int>(cudaGetLastError());
}

Plan fused_plan(int kind, int n, int d) {
    switch (kind) {
        case SERIAL: return serial_plan(n, d);
        case SPLIT: return split_plan(n, d);
        case BIG: return big_plan(n, d);
        case SMALL: { Plan p{}; p.kind = SMALL; return p; }
        default: break;
    }
    if (n <= SMALL_N && small_takes(n, d)) return fused_plan(SMALL, n, d);
    return plan(n, d);
}

}  // namespace

// The plan fused_adjacency_launch takes for (n, d) on the current device:
// 0 serial, 1 split, 2 big, 3 small.
extern "C" int fused_adjacency_plan_kind(int n, int d) {
    return fused_plan(-1, n, d).kind;
}

// 1 when plan `kind` takes (n, d) if forced, else 0.
extern "C" int fused_adjacency_plan_takes(int n, int d, int kind) {
    switch (kind) {
        case SERIAL: case BIG: return 1;
        case SPLIT: return d >= 1;
        case SMALL: return small_takes(n, d);
        default: return 0;
    }
}

// 1 when the last block of the tile pass does the epilogue for n (the
// call is one launch), 0 when a launch of its own does.
extern "C" int fused_adjacency_epilogue_kind(int n) {
    return static_cast<long long>(n) * n <= EPI_LAST_MOST;
}

// Bytes of scratch plan `kind` (-1: the planned one) needs for (n, d).
extern "C" long long fused_adjacency_scratch_bytes(int n, int d, int kind) {
    return static_cast<long long>(fused_plan(kind, n, d).scratch);
}

// u (n, d) f32 row-major, n >= 1; r (n, n) f32 out; kind: -1 the planned
// tile pass, else the one to force (fused_adjacency_plan_takes); epilogue:
// -1 as planned, 0 a launch of its own, 1 the last block; scratch:
// fused_adjacency_scratch_bytes(n, d, kind) bytes (null when 0); state: 4
// x uint32, zero, used on `stream` alone; stats (2,) f32 out = [lo, hi].
// Returns cudaGetLastError().
extern "C" int fused_adjacency_launch(const float* u, int n, int d, int clamp,
                                      float eps, float sigma2, int kind,
                                      int epilogue, float* r, void* scratch,
                                      unsigned int* state, float* stats,
                                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 1 || state == nullptr || (kind >= 0 &&
            !fused_adjacency_plan_takes(n, d, kind)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (epilogue < 0) epilogue = fused_adjacency_epilogue_kind(n);
    if (epilogue && static_cast<long long>(n) * n > (1ll << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const Fuse fz{state, stats, clamp, epilogue, eps, sigma2};
    const Plan p = fused_plan(kind, n, d);
    int err;
    if (p.kind == SMALL) {
        const int el = fedgs::tile32::copy_width(u, d);
        err = el == 4 ? launch_small<4>(u, n, d, r, s, fz)
            : el == 2 ? launch_small<2>(u, n, d, r, s, fz)
                      : launch_small<1>(u, n, d, r, s, fz);
    } else {
        err = launch<true>(p, u, n, d, r, scratch, s, fz);
    }
    if (err != 0 || epilogue) return err;
    return launch_adjacency(r, n, stats, eps, sigma2, r, s);   // in place
}
