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
// What bounds it on the card: bytes (the panel's N - m untouched rows and
// the m updates read once, the m rows written once), against 2·N·P
// operations; at the main path's sizes, latency.  So the design fills the
// card and keeps every block to a few dependent round trips:
//   * a grid over (column tiles, row slabs): a block of 32 x 8 threads owns
//     32 column vectors (16-, 8- or 4-byte, as the rows' pitch and the
//     pointers allow) of `slab` consecutive rows;
//   * no read-after-write: the block first builds an inverse map, row ->
//     slot, of its rows in shared memory from sel/valid (the first 1,024
//     slots loaded before the map is cleared), then reads each of its rows
//     once, from upd where the row takes an update (and writes it into the
//     panel) and from the panel elsewhere; the copy and the sum need no
//     barrier between them.  The map holds kMapRows rows: a longer slab
//     takes its rows in windows of that many, one map each, which leaves
//     every thread's order of rows as it was, so any N is taken;
//   * thread (x, y) sums rows y, y + 8, ... of its slab in ascending order
//     (fmaf, w[r] held in a register for the vector's columns), eight rows
//     in flight; the 8 row groups meet in shared memory in ascending y.
// Plans (kernels/aggregate.py memagg_plan, which passes the plan and
// `slab`):
//   small    one slab of all N rows: one launch, the block's sum is red
//            (the quickstart's (30, 610, 6));
//   cluster  2..16 slabs, the slabs of a column tile one thread block
//            cluster: every other block stores its slab's sum into block
//            0's shared memory and arrives on block 0's mbarrier, then
//            exits; block 0 waits for them and adds them to its own in
//            ascending slab order.
// Neither keeps any state outside the launch, so no call needs a memset
// and calls on two streams or replayed from CUDA graphs share nothing.
// Every order is fixed by the plan and the shape, so `red` repeats bit for
// bit from launch to launch.  The panel is updated in place.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTX = 32;                  // column vectors per block
constexpr int kTY = 8;                   // row groups per block
constexpr int kThreads = kTX * kTY;
constexpr int kPre = 4;                  // slots a thread loads up front
constexpr int kMapRows = 8192;           // rows of one row map (32 KiB)
constexpr int kClusterMost = 16;         // the cluster plan's slabs, at most
enum Mode { SMALL = 0, CLUSTER = 1 };

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int VEC>
__device__ __forceinline__ float& at(typename Vec<VEC>::T& x, int e) {
    return reinterpret_cast<float*>(&x)[e];
}

// ------------------------------------------------ the cluster plan's meeting
// One mbarrier in block 0's shared memory counts the other blocks' sums
// (one arrival per writing thread): block 0 initializes it and every block
// arrives (relaxed) on the cluster barrier at its start; a block waits on
// the cluster barrier only before its remote store, by when every block of
// the cluster has long started, so block 0's mbarrier is initialized.  A
// writer's store into block 0's shared memory is ordered before its
// arrival by the arrival's release at cluster scope, and block 0's wait
// acquires at cluster scope before it reads them.
__shared__ alignas(8) uint64_t cluster_bar;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Columns of this block's tile that a thread holds (its writers).
__device__ __forceinline__ int n_on(int cvs) {
    return min(kTX, cvs - static_cast<int>(blockIdx.x) * kTX);
}

__device__ __forceinline__ void cluster_start(int writers) {
    if (blockIdx.y == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
        const uint32_t count = (gridDim.y - 1) * writers;
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                     :: "r"(smem_addr(&cluster_bar)), "r"(count) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_started() {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ void arrive_on_block0(uint64_t* bar) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(smem_addr(bar)), "r"(0));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
                 :: "r"(remote) : "memory");
}

__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], 0;\n"
        "@!done bra WAIT;\n"
        "}\n" :: "r"(smem_addr(bar)) : "memory");
}

template <int VEC, int MODE>
__global__ void __launch_bounds__(kThreads, 4)
memagg_kernel(float* __restrict__ mem, const float* __restrict__ upd,
              const int64_t* __restrict__ sel,
              const uint8_t* __restrict__ valid,
              const float* __restrict__ w, int n, int p, int m, int slab,
              float* __restrict__ red) {
    using V = typename Vec<VEC>::T;
    constexpr int kU = 8;                         // rows a thread has in flight
    static_assert(kMapRows % (kTY * kU) == 0, "a window ends a batch");
    // [min(slab, kMapRows)]: the slot of row b0 + i of the window
    extern __shared__ int slot[];
    __shared__ float psum[kTY][kTX * VEC];
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTX + tx;
    const int r0 = blockIdx.y * slab;
    const int rows = min(slab, n - r0);

    if constexpr (MODE == CLUSTER) cluster_start(n_on(p / VEC));

    // 1. the inverse map of the slab's first window of rows: invalid slots
    //    and rows outside [0, n) never enter it; the first kPre * kThreads
    //    slots are loaded before the map is cleared
    int64_t pre[kPre];
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
        const int k = tid + q * kThreads;
        const int64_t s = k < m ? sel[k] : -1;
        const bool v = k < m && valid[k];
        pre[q] = (v && s >= 0) ? s - r0 : -1;
    }
    int b0 = r0, wrows = min(kMapRows, rows), k0 = tid + kPre * kThreads;
    for (int i = tid; i < wrows; i += kThreads) slot[i] = -1;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPre; ++q)
        if (pre[q] >= 0 && pre[q] < wrows) slot[pre[q]] = tid + q * kThreads;

    const int cv = blockIdx.x * kTX + tx;
    const bool on = cv < p / VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (;;) {
        for (int k = k0; k < m; k += kThreads) {
            const int64_t s = sel[k];
            if (valid[k] && s >= b0 && s - b0 < wrows) slot[s - b0] = k;
        }
        __syncthreads();

        // 2. copy and sum: rows ty, ty + kTY, ... of the window, ascending
        if (on) {
            for (int i0 = ty; i0 < wrows; i0 += kTY * kU) {
                V x[kU];
                float wr[kU];
                int sl[kU];
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    const int i = i0 + u * kTY;
                    sl[u] = -1;
                    if (i < wrows) {
                        sl[u] = slot[i];
                        const float* src = sl[u] >= 0
                            ? upd + static_cast<int64_t>(sl[u]) * p
                            : mem + static_cast<int64_t>(b0 + i) * p;
                        x[u] = reinterpret_cast<const V*>(src)[cv];
                        wr[u] = w[b0 + i];
                    }
                }
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    const int i = i0 + u * kTY;
                    if (i >= wrows) continue;
                    if (sl[u] >= 0)
                        reinterpret_cast<V*>(
                            mem + static_cast<int64_t>(b0 + i) * p)[cv] = x[u];
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        acc[e] = fmaf(wr[u], at<VEC>(x[u], e), acc[e]);
                }
            }
        }

        // the next window's map (slabs past kMapRows rows), once every
        // thread has read this one's
        if (b0 + wrows >= r0 + rows) break;
        b0 += wrows;
        wrows = min(kMapRows, r0 + rows - b0);
        k0 = tid;
        __syncthreads();
        for (int i = tid; i < wrows; i += kThreads) slot[i] = -1;
        __syncthreads();
    }

    // 3. the slab's sum: the row groups in ascending ty
#pragma unroll
    for (int e = 0; e < VEC; ++e) psum[ty][tx * VEC + e] = acc[e];
    __syncthreads();
    V s;
    if (ty == 0 && on) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            at<VEC>(s, e) = psum[0][tx * VEC + e];
#pragma unroll
            for (int g = 1; g < kTY; ++g) at<VEC>(s, e) += psum[g][tx * VEC + e];
        }
    }
    if constexpr (MODE == SMALL) {                // one slab: that is red
        if (ty == 0 && on) reinterpret_cast<V*>(red)[cv] = s;
        return;
    }

    if constexpr (MODE == CLUSTER) {
        // 4. the tile's slabs are one cluster: every other block stores its
        //    sum into block 0's shared memory and arrives on block 0's
        //    barrier (and may exit); block 0 waits, then adds them to its
        //    own in ascending slab order
        __shared__ V gather[kClusterMost][kTX];
        cluster_wait_started();
        const int slabs = gridDim.y;
        if (blockIdx.y != 0) {
            if (ty == 0 && on) {
                cg::this_cluster().map_shared_rank(&gather[0][0], 0)
                    [blockIdx.y * kTX + tx] = s;
                arrive_on_block0(&cluster_bar);
            }
            return;
        }
        if (ty == 0 && on) {
            wait_phase0(&cluster_bar);
            for (int j = 1; j < slabs; ++j)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    at<VEC>(s, e) += at<VEC>(gather[j][tx], e);
            reinterpret_cast<V*>(red)[cv] = s;
        }
        return;
    }
}

template <int VEC, int MODE>
int launch(float* mem, const float* upd, const int64_t* sel,
           const uint8_t* valid, const float* w, int n, int p, int m,
           int slab, int slabs, float* red, cudaStream_t s) {
    const dim3 grid((p / VEC + kTX - 1) / kTX, slabs);
    const size_t smem =
        static_cast<size_t>(slab < kMapRows ? slab : kMapRows) * sizeof(int);
    if constexpr (MODE == SMALL) {
        memagg_kernel<VEC, MODE><<<grid, dim3(kTX, kTY), smem, s>>>(
            mem, upd, sel, valid, w, n, p, m, slab, red);
        return static_cast<int>(cudaGetLastError());
    } else {
        static bool wide[64] = {};            // per device: clusters past 8
        int dev = 0;
        if (slabs > 8 && (cudaGetDevice(&dev) != cudaSuccess || dev >= 64 ||
                          !wide[dev])) {
            const cudaError_t err = cudaFuncSetAttribute(
                memagg_kernel<VEC, MODE>,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != cudaSuccess) return static_cast<int>(err);
            if (dev < 64) wide[dev] = true;
        }
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(kTX, kTY);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = s;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = 1;
        attr[0].val.clusterDim.y = slabs;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        const cudaError_t err = cudaLaunchKernelEx(
            &cfg, memagg_kernel<VEC, MODE>, mem, upd, sel, valid, w, n, p, m,
            slab, red);
        if (err != cudaSuccess) return static_cast<int>(err);
        return static_cast<int>(cudaGetLastError());
    }
}

template <int MODE>
int launch_mode(float* mem, const float* upd, const int64_t* sel,
                const uint8_t* valid, const float* w, int n, int p, int m,
                int slab, int slabs, float* red, cudaStream_t s) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(mem) |
                        reinterpret_cast<uintptr_t>(upd) |
                        reinterpret_cast<uintptr_t>(red);
    if (p % 4 == 0 && a % 16 == 0)
        return launch<4, MODE>(mem, upd, sel, valid, w, n, p, m, slab, slabs,
                               red, s);
    if (p % 2 == 0 && a % 8 == 0)
        return launch<2, MODE>(mem, upd, sel, valid, w, n, p, m, slab, slabs,
                               red, s);
    return launch<1, MODE>(mem, upd, sel, valid, w, n, p, m, slab, slabs, red,
                           s);
}

}  // namespace

// mem (n, p) f32, updated in place; upd (m, p) f32; sel (m,) int64 target
// rows; valid (m,) bool; w (n,) f32; red (p,) f32 out; p > 0.  plan: 0
// small (slab >= max(n, 1): one slab), 1 cluster (2..16 slabs of `slab`
// rows).  Returns cudaGetLastError().
extern "C" int memagg_launch(float* mem, const float* upd, const int64_t* sel,
                             const uint8_t* valid, const float* w, int n,
                             int p, int m, int plan, int slab, float* red,
                             void* stream) {
    if (p < 1 || slab < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int slabs = n > slab ? (n + slab - 1) / slab : 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (plan == SMALL && slabs == 1)
        return launch_mode<SMALL>(mem, upd, sel, valid, w, n, p, m, slab, 1,
                                  red, s);
    if (plan == CLUSTER && slabs >= 2 && slabs <= kClusterMost)
        return launch_mode<CLUSTER>(mem, upd, sel, valid, w, n, p, m, slab,
                                    slabs, red, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
