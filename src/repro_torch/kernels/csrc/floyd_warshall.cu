// Floyd–Warshall all-pairs shortest paths, in place, in the per-pivot
// order, on one of three plans (floyd_warshall_plan_kind): single, or
// blocked with pivot blocks of T = 32 or 64.
//
// Replaces repro/kernels/floyd_warshall.py `_fw_round_kernel` /
// `floyd_warshall_pallas`, a blocked min-plus APSP whose rounds (pivot
// tile, then pivot panels, then the rest) update the rest from the FINAL
// pivot panels of the round.  That is another order of operations than the
// per-pivot h = min(h, h[:, k] + h[k, :]) of `kernels/ref.floyd_warshall_ref`
// (its own test holds it to atol 1e-4); the port's contract is bitwise.
//
// The per-pivot order on a cell (i, j) is a chain of steps k = 0, 1, ..:
// h_ij = min(h_ij, h_ik + h_kj) with h_ik and h_kj as they stand at step k.
// With no negative entry and no NaN, h_kk >= 0, so row k and column k do not
// change at step k: each may be read, and updated in place, by every cell
// of step k.  Both plans run exactly that chain on every cell:
//   * single (N <= kSingleMost): one block holds the whole matrix in its
//     threads' registers and steps k = 0 .. N-1, row and column k passed
//     through shared memory, a __syncthreads() per pivot.  One launch.
//   * blocked: pivots in blocks K of T consecutive indices, two launches per
//     block.  fw_panels_kernel: every block steps through K on the pivot
//     tile (K x K, redundantly, in registers) and on its own panel tile (a
//     row panel tile K x J or a column panel tile I x K), which needs only
//     the pivot tile's column or row k and its own row or column k at step
//     k; the panel's row k (column k) AT STEP k goes to a snapshot,
//     rowsnap[k][j] (colsnap[k][i]), T x N each.  fw_rest_kernel: every
//     other tile steps through K with h_ik and h_kj read from the
//     snapshots, which are exactly their values at step k.  (The final
//     panels, which the TPU kernel reads, are not: a later pivot of K may
//     have lowered them.)
//
// What bounds it on the card: 2N³ operations (an add and a min per cell
// and pivot) against 8N² bytes, so operations from N ≈ 100 on.  The old
// design launched once per pivot and streamed the matrix each time (2
// operations per 12 bytes, 1,024 launches at N = 1024); the blocked plan
// reads and writes each cell twice per pivot block (2·N²·4·N/T bytes in
// all), keeps a thread's cells in registers and the T x T snapshot slabs
// in shared memory, and launches 2·N/T times.
//
// The compare: min.NaN (the smaller; NaN if either is NaN), torch.minimum's
// rule, in one instruction (the old kernel's `c < cur || (isnan(c) &&
// !isnan(cur))` took 1.7-3x the time of the blocked plan on an H100).  It
// gives the plain version's bits on every input the precondition admits;
// on a tie of +0.0 against -0.0 torch's own CPU result depends on its
// vector path, which is why the precondition excludes -0.0 too.  Additions
// are __fadd_rn (no FMA contraction).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSingleMost = 256;    // 32 x 32 threads, at most 8 x 8 cells
// The plans' switches, measured on an H100 (PERF.md): single up to N = 64
// (R = 2; at R = 3 one block's pivot step costs more than the blocked
// plan's launches), T = 32 up to N = 2048, T = 64 beyond (half the tile
// traffic; its 64-step panel launches cost more below).
constexpr int kSingleMax = 64;
constexpr int kBlocked32Max = 2048;

__device__ __forceinline__ float fw_min(float c, float cur) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(c), "f"(cur));
    return r;
}

// Single plan: one block of 1024 threads as 32 x 32; thread (tx, ty) owns
// the cells (ty + 32a, tx + 32b), a, b < R = ceil(n / 32), in registers.
// At step k the owners of row k and column k publish them into shared
// memory (double-buffered by k's parity: one __syncthreads() a step), then
// every thread updates its cells.  R <= 6 (N <= 192) fits 1024 threads'
// registers; R = 7, 8 spill.
template <int R>
__global__ void __launch_bounds__(1024)
fw_single_kernel(float* __restrict__ h, int n) {
    __shared__ float row[2][32 * R], col[2][32 * R];
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float x[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
            const int i = ty + 32 * a, j = tx + 32 * b;
            x[a][b] = (i < n && j < n) ? h[(size_t)i * n + j] : INFINITY;
        }
    for (int k = 0; k < n; ++k) {
        const int buf = k & 1, kq = k >> 5, kl = k & 31;
#pragma unroll
        for (int q = 0; q < R; ++q) {
            if (q != kq) continue;
#pragma unroll
            for (int e = 0; e < R; ++e) {
                if (ty == kl) row[buf][tx + 32 * e] = x[q][e];
                if (tx == kl) col[buf][ty + 32 * e] = x[e][q];
            }
        }
        __syncthreads();
        float rk[R];
#pragma unroll
        for (int b = 0; b < R; ++b) rk[b] = row[buf][tx + 32 * b];
#pragma unroll
        for (int a = 0; a < R; ++a) {
            const float ck = col[buf][ty + 32 * a];
#pragma unroll
            for (int b = 0; b < R; ++b)
                x[a][b] = fw_min(__fadd_rn(ck, rk[b]), x[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
            const int i = ty + 32 * a, j = tx + 32 * b;
            if (i < n && j < n) h[(size_t)i * n + j] = x[a][b];
        }
}

// Blocked plan, launch 1 of pivot block kb (pivots k0 .. k0 + kc - 1):
// 2·nb - 1 blocks of 1024 threads (32 x 32, each RT x RT cells of a tile,
// RT = T / 32, in registers).  Block 0 takes the pivot tile alone, blocks 1 ..
// nb-1 the row panel tiles (kb, jb != kb), the rest the column panel tiles
// (ib != kb, kb).  At step k the owners publish the pivot tile's row and
// column k and the panel's own row (or column) k into shared memory,
// double-buffered by k's parity so one __syncthreads() a step suffices,
// and keep the panel's in a shared-memory snapshot slab, written out after
// the last step.  Cells past n hold +inf and are never
// stored; they feed only cells past n.  Every block reads the pivot tile
// from h, so block 0 writes its result to `pivot` (T x T) and the rest
// kernel copies it into h, unless block 0 is the only block.
template <int T>
__global__ void __launch_bounds__(1024)
fw_panels_kernel(float* __restrict__ h, int n, int kb,
                 float* __restrict__ rowsnap, float* __restrict__ colsnap,
                 float* __restrict__ pivot) {
    constexpr int RT = T / 32;
    __shared__ float prow[2][T], pcol[2][T], own[2][T];
    __shared__ float snap[T][T];   // the panel's row (column) k at step k
    const int nb = (n + T - 1) / T, k0 = kb * T, kc = min(T, n - k0);
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int kind = blockIdx.x == 0 ? 0 : (blockIdx.x < nb ? 1 : 2);
    int other = kind == 1 ? blockIdx.x - 1 : blockIdx.x - nb;
    other += other >= kb;
    const int r0 = kind == 2 ? other * T : k0;     // the block's own tile
    const int c0 = kind == 1 ? other * T : k0;
    float p[RT][RT], x[RT][RT];
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int b = 0; b < RT; ++b) {
            const int pi = k0 + ty + 32 * a, pj = k0 + tx + 32 * b;
            const int i = r0 + ty + 32 * a, j = c0 + tx + 32 * b;
            p[a][b] = (pi < n && pj < n) ? h[(size_t)pi * n + pj] : INFINITY;
            x[a][b] = (kind != 0 && i < n && j < n) ? h[(size_t)i * n + j]
                                                    : INFINITY;
        }
    for (int k = 0; k < kc; ++k) {
        const int buf = k & 1, kq = k >> 5, kl = k & 31;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
            if (q != kq) continue;
#pragma unroll
            for (int e = 0; e < RT; ++e) {
                if (ty == kl) {                        // row k of the tiles
                    prow[buf][tx + 32 * e] = p[q][e];
                    if (kind == 1)
                        own[buf][tx + 32 * e] = snap[k][tx + 32 * e] = x[q][e];
                }
                if (tx == kl) {                        // column k
                    pcol[buf][ty + 32 * e] = p[e][q];
                    if (kind == 2)
                        own[buf][ty + 32 * e] = snap[k][ty + 32 * e] = x[e][q];
                }
            }
        }
        __syncthreads();
#pragma unroll
        for (int a = 0; a < RT; ++a) {
            const float pc = pcol[buf][ty + 32 * a];
            const float xc = kind == 2 ? own[buf][ty + 32 * a] : pc;
#pragma unroll
            for (int b = 0; b < RT; ++b) {
                const float pr = prow[buf][tx + 32 * b];
                const float xr = kind == 1 ? own[buf][tx + 32 * b] : pr;
                p[a][b] = fw_min(__fadd_rn(pc, pr), p[a][b]);
                x[a][b] = fw_min(__fadd_rn(xc, xr), x[a][b]);
            }
        }
    }
    if (kind != 0) {       // the snapshot, written once (in the loop: 7-25%)
        __syncthreads();
        float* dst = kind == 1 ? rowsnap + c0 : colsnap + r0;
        const int lim = n - (kind == 1 ? c0 : r0);
        for (int e = threadIdx.x; e < kc * T; e += 1024) {
            const int k = e / T, c = e % T;
            if (c < lim) dst[(size_t)k * n + c] = snap[k][c];
        }
    }
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int b = 0; b < RT; ++b) {
            const int i = r0 + ty + 32 * a, j = c0 + tx + 32 * b;
            if (kind == 0 && nb > 1)
                pivot[(ty + 32 * a) * T + tx + 32 * b] = p[a][b];
            else if (i < n && j < n)
                h[(size_t)i * n + j] = kind == 0 ? p[a][b] : x[a][b];
        }
}

// Blocked plan, launch 2 of pivot block kb: (nb-1)² blocks of (T / M)²
// threads, one per tile (ib, jb) with ib, jb != kb; thread (tx, ty) owns
// the M x M cells (i0 + ty·M + a, j0 + tx·M + b) in registers, M = 2 for
// T = 32 (256 threads) and 4 for T = 64 (256 threads; 4 x 4 at T = 32 and
// 8 x 8 at T = 64 were slower on an H100).  The snapshot slabs colsnap[K][I]
// and rowsnap[K][J] sit in shared memory, read M at a time (one vector
// load each per step).  Block (0, 0) also copies the pivot tile's result
// into h: no block of this launch reads it.
template <int T, int M>
__global__ void __launch_bounds__((T / M) * (T / M))
fw_rest_kernel(float* __restrict__ h, int n, int kb,
               const float* __restrict__ rowsnap,
               const float* __restrict__ colsnap,
               const float* __restrict__ pivot) {
    constexpr int D = T / M, THREADS = D * D;
    using V = typename std::conditional<M == 4, float4, float2>::type;
    __shared__ __align__(16) float cs[T][T];   // cs[k][ii] = h[i0 + ii][k0 + k]
    __shared__ __align__(16) float rs[T][T];   // rs[k][jj] = h[k0 + k][j0 + jj]
    const int k0 = kb * T, kc = min(T, n - k0);
    const int ib = blockIdx.y + (blockIdx.y >= kb);
    const int jb = blockIdx.x + (blockIdx.x >= kb);
    const int i0 = ib * T, j0 = jb * T;
    for (int e = threadIdx.x; e < T * T; e += THREADS) {
        const int k = e / T, c = e % T;
        cs[k][c] = (k < kc && i0 + c < n) ? colsnap[(size_t)k * n + i0 + c] : 0.0f;
        rs[k][c] = (k < kc && j0 + c < n) ? rowsnap[(size_t)k * n + j0 + c] : 0.0f;
    }
    if (blockIdx.x == 0 && blockIdx.y == 0)
        for (int e = threadIdx.x; e < T * T; e += THREADS) {
            const int i = k0 + e / T, j = k0 + e % T;
            if (i < n && j < n) h[(size_t)i * n + j] = pivot[e];
        }
    const int tx = threadIdx.x % D, ty = threadIdx.x / D;
    float x[M][M];
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
        for (int b = 0; b < M; ++b) {
            const int i = i0 + ty * M + a, j = j0 + tx * M + b;
            x[a][b] = (i < n && j < n) ? h[(size_t)i * n + j] : INFINITY;
        }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
        const V cv = *reinterpret_cast<const V*>(&cs[k][ty * M]);
        const V rv = *reinterpret_cast<const V*>(&rs[k][tx * M]);
        const float* c = reinterpret_cast<const float*>(&cv);
        const float* r = reinterpret_cast<const float*>(&rv);
#pragma unroll
        for (int a = 0; a < M; ++a)
#pragma unroll
            for (int b = 0; b < M; ++b)
                x[a][b] = fw_min(__fadd_rn(c[a], r[b]), x[a][b]);
    }
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
        for (int b = 0; b < M; ++b) {
            const int i = i0 + ty * M + a, j = j0 + tx * M + b;
            if (i < n && j < n) h[(size_t)i * n + j] = x[a][b];
        }
}

template <int R>
cudaError_t launch_single(float* h, int n, cudaStream_t s) {
    fw_single_kernel<R><<<1, 1024, 0, s>>>(h, n);
    return cudaGetLastError();
}

// scratch: rowsnap (T x n), colsnap (T x n), pivot (T x T), in that order
template <int T>
cudaError_t launch_blocked(float* h, int n, float* scratch, cudaStream_t s) {
    float* rowsnap = scratch;
    float* colsnap = scratch + (size_t)T * n;
    float* pivot = colsnap + (size_t)T * n;
    const int nb = (n + T - 1) / T;
    for (int kb = 0; kb < nb; ++kb) {
        fw_panels_kernel<T><<<2 * nb - 1, 1024, 0, s>>>(h, n, kb, rowsnap,
                                                        colsnap, pivot);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        if (nb == 1) break;
        constexpr int M = T == 32 ? 2 : 4;
        fw_rest_kernel<T, M><<<dim3(nb - 1, nb - 1), (T / M) * (T / M), 0,
                                s>>>(h, n, kb, rowsnap, colsnap, pivot);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// The plan floyd_warshall_launch takes for an (n, n) matrix: 0 single, 1
// blocked (T = 32), 2 blocked (T = 64).
extern "C" int floyd_warshall_plan_kind(int n) {
    return n <= kSingleMax ? 0 : (n <= kBlocked32Max ? 1 : 2);
}

// h (n, n) f32 row-major, updated in place; kind: 0 single (n <= 256), 1
// blocked T = 32, 2 blocked T = 64; scratch: the blocked plans' snapshots
// and pivot tile, at least (2·64·n + 64·64) f32, no zeroing needed (null
// for single).  Returns the first launch error.
extern "C" int floyd_warshall_launch(float* h, int n, int kind,
                                     float* scratch, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (kind == 0) {
        if (n > kSingleMost) return static_cast<int>(cudaErrorInvalidValue);
        switch ((n + 31) / 32) {
            case 1: return static_cast<int>(launch_single<1>(h, n, s));
            case 2: return static_cast<int>(launch_single<2>(h, n, s));
            case 3: return static_cast<int>(launch_single<3>(h, n, s));
            case 4: return static_cast<int>(launch_single<4>(h, n, s));
            case 5: return static_cast<int>(launch_single<5>(h, n, s));
            case 6: return static_cast<int>(launch_single<6>(h, n, s));
            case 7: return static_cast<int>(launch_single<7>(h, n, s));
            default: return static_cast<int>(launch_single<8>(h, n, s));
        }
    }
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (kind == 1) return static_cast<int>(launch_blocked<32>(h, n, scratch, s));
    if (kind == 2) return static_cast<int>(launch_blocked<64>(h, n, scratch, s));
    return static_cast<int>(cudaErrorInvalidValue);
}
