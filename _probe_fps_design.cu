// Measurements behind the design of patchaugnet_tpu_torch/csrc/fps.cu (K1),
// run by _probe_fps_design.py on an H100. Plain C entry points, built with
// nvcc on their own; nothing of the port launches them.
//
// - probe_latency: cycles per step of dependent chains of the primitives a
//   pick can be made of (redux.sync, shuffles, ballots, block barriers,
//   shared loads), and the SM clock over a spin (clock64 against the
//   global timer);
// - probe_cluster: a thread-block cluster's barrier (cluster.sync, and the
//   relaxed arrive/wait without memory ordering) and a load from another
//   block's shared memory, the primitives of a multi-SM FPS;
// - fps_variant: K1's register kernel in two forms, the pick's coordinates
//   read from a shared copy of the cloud (as csrc/fps.cu does) or passed
//   through the winners' slots from the winning lanes' registers.
#include <cooperative_groups.h>

#include "patchaugnet_tpu_torch/csrc/common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// out[0..6]: cycles over `iters` steps of each chain; out[7], out[8]: cycles
// and ns over a spin.
__global__ void probe_latency(long long* out, int iters) {
    __shared__ int s[1024];
    const int lane = threadIdx.x & 31;
    s[threadIdx.x] = (threadIdx.x + 1) & 1023;
    __syncthreads();
    int v = threadIdx.x;
    long long t0 = clock64();
    for (int i = 0; i < iters; ++i) v = __reduce_max_sync(kFull, v ^ lane);
    long long t1 = clock64();
    if (threadIdx.x == 0) out[0] = t1 - t0;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) v = max(v, __shfl_xor_sync(kFull, v, 1)) ^ lane;
    t1 = clock64();
    if (threadIdx.x == 0) out[1] = t1 - t0;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) v = __ballot_sync(kFull, (v & 1) ^ lane);
    t1 = clock64();
    if (threadIdx.x == 0) out[2] = t1 - t0;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
        v += s[(v + i) & 1023];
        __syncthreads();
    }
    t1 = clock64();
    if (threadIdx.x == 0) out[3] = t1 - t0;
    int p = threadIdx.x;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) p = s[p];
    t1 = clock64();
    if (threadIdx.x == 0) out[4] = t1 - t0;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
        const int b = __reduce_max_sync(kFull, v ^ lane);
        v = __reduce_min_sync(kFull, v == b ? lane : INT_MAX) + b;
    }
    t1 = clock64();
    if (threadIdx.x == 0) out[5] = t1 - t0;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
        for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
        v ^= lane;
    }
    t1 = clock64();
    if (threadIdx.x == 0) out[6] = t1 - t0;
    const unsigned long long g0 = global_ns();
    t0 = clock64();
    float f = static_cast<float>(v);
    for (int i = 0; i < iters * 100; ++i) f = f * 1.0000001f + 0.5f;
    t1 = clock64();
    const unsigned long long g1 = global_ns();
    if (threadIdx.x == 0) {
        out[7] = t1 - t0;
        out[8] = static_cast<long long>(g1 - g0);
    }
    if (f == 12345.f) out[9] = v + p;
}

// out[0]: cycles over `iters` shared loads + cluster.sync; out[1]: loads from
// the next block's shared memory, chased; out[2]: the same from its own;
// out[3]: shared loads + relaxed cluster arrive/wait.
__global__ void probe_cluster(long long* out, int iters) {
    __shared__ int s[1024];
    cg::cluster_group cl = cg::this_cluster();
    const unsigned r = cl.block_rank();
    s[threadIdx.x] = (threadIdx.x + 1) & (blockDim.x - 1);
    cl.sync();
    int v = threadIdx.x;
    long long t0 = clock64();
    for (int i = 0; i < iters; ++i) {
        v += s[(v + i) & 255];
        cl.sync();
    }
    long long t1 = clock64();
    if (threadIdx.x == 0 && r == 0) out[0] = t1 - t0;
    const int* remote = cl.map_shared_rank(s, (r + 1) % cl.num_blocks());
    int p = threadIdx.x;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) p = remote[p];
    t1 = clock64();
    if (threadIdx.x == 0 && r == 0) out[1] = t1 - t0;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) p = s[p];
    t1 = clock64();
    if (threadIdx.x == 0 && r == 0) out[2] = t1 - t0;
    t0 = clock64();
    for (int i = 0; i < iters; ++i) {
        v += s[(v + i) & 255];
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
    t1 = clock64();
    if (threadIdx.x == 0 && r == 0) out[3] = t1 - t0;
    cl.sync();
    if (v == -1) out[4] = p;
}

template <int PPT>
__device__ __forceinline__ float slot(const float (&a)[PPT], int t) {
    float r = a[0];
#pragma unroll
    for (int u = 1; u < PPT; ++u) r = t == u ? a[u] : r;
    return r;
}

// K1's register kernel (csrc/fps.cu) with the pick's coordinates from the
// shared copy of the cloud (kSlots false) or from the winning lanes'
// registers through the slots, at T = 32 by shuffles (kSlots true).
template <int T, int PPT, bool kSlots>
__global__ void __launch_bounds__(T)
fps_variant(const float* __restrict__ xyz, int* __restrict__ idx, int n, int m) {
    __shared__ int s_key[2][32], s_idx[2][32];
    __shared__ float4 s_pt[2][32];
    extern __shared__ float4 cloud[];
    const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
    int* out = idx + static_cast<size_t>(blockIdx.x) * m;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float x[PPT], y[PPT], z[PPT], md[PPT];
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
        const int j = threadIdx.x + t * T;
        if (j < n) {
            x[t] = p[3 * j];
            y[t] = p[3 * j + 1];
            z[t] = p[3 * j + 2];
            md[t] = 1e10f;
            if (!kSlots) cloud[j] = make_float4(x[t], y[t], z[t], 0.f);
        } else {
            x[t] = y[t] = z[t] = 0.f;
            md[t] = -pan::pos_inf();
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) out[0] = 0;
    float4 q = make_float4(p[0], p[1], p[2], 0.f);
    for (int s = 1; s < m; ++s) {
        int key[PPT], at[PPT];
#pragma unroll
        for (int t = 0; t < PPT; ++t) {
            md[t] = fminf(md[t], pan::sqdist3(x[t], y[t], z[t], q.x, q.y, q.z));
            key[t] = __float_as_int(md[t]);
            at[t] = t;
        }
#pragma unroll
        for (int h = 1; h < PPT; h *= 2) {
#pragma unroll
            for (int t = 0; t + h < PPT; t += 2 * h) {
                if (key[t + h] > key[t]) {
                    key[t] = key[t + h];
                    at[t] = at[t + h];
                }
            }
        }
        const int bt = at[0], bi = static_cast<int>(threadIdx.x) + bt * T;
        const int wkey = __reduce_max_sync(kFull, key[0]);
        const int widx = __reduce_min_sync(kFull, key[0] == wkey ? bi : INT_MAX);
        int gi = widx;
        if constexpr (T == 32) {
            if constexpr (kSlots) {
                const int src = widx & 31;
                q = make_float4(__shfl_sync(kFull, slot(x, bt), src), __shfl_sync(kFull, slot(y, bt), src),
                                __shfl_sync(kFull, slot(z, bt), src), 0.f);
            }
        } else {
            const int buf = s & 1;
            if (bi == widx) {
                s_key[buf][warp] = wkey;
                s_idx[buf][warp] = widx;
                if constexpr (kSlots) s_pt[buf][warp] = make_float4(slot(x, bt), slot(y, bt), slot(z, bt), 0.f);
            }
            __syncthreads();
            const int k = lane < T / 32 ? s_key[buf][lane] : INT_MIN;
            const int i = lane < T / 32 ? s_idx[buf][lane] : INT_MAX;
            const int gkey = __reduce_max_sync(kFull, k);
            gi = __reduce_min_sync(kFull, k == gkey ? i : INT_MAX);
            if constexpr (kSlots) q = s_pt[buf][(gi & (T - 1)) >> 5];
        }
        if constexpr (!kSlots) q = cloud[gi];
        if (threadIdx.x == 0) out[s] = gi;
    }
}

template <int T, int PPT, bool kSlots>
int launch_variant(const float* x, int* out, int b, int n, int m) {
    const int smem = kSlots ? 0 : static_cast<int>(sizeof(float4)) * n;
    cudaError_t err = cudaFuncSetAttribute(fps_variant<T, PPT, kSlots>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fps_variant<T, PPT, kSlots><<<b, T, smem>>>(x, out, n, m);
    return static_cast<int>(cudaGetLastError());
}

template <bool kSlots>
int dispatch_variant(const float* x, int* out, int b, int n, int m, int threads, int ppt) {
    switch (threads * 100 + ppt) {
        case 3204: return launch_variant<32, 4, kSlots>(x, out, b, n, m);
        case 25604: return launch_variant<256, 4, kSlots>(x, out, b, n, m);
        case 25616: return launch_variant<256, 16, kSlots>(x, out, b, n, m);
        case 51202: return launch_variant<512, 2, kSlots>(x, out, b, n, m);
        case 51208: return launch_variant<512, 8, kSlots>(x, out, b, n, m);
        case 102401: return launch_variant<1024, 1, kSlots>(x, out, b, n, m);
        case 102404: return launch_variant<1024, 4, kSlots>(x, out, b, n, m);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" int run_latency(void* out, int threads, int iters) {
    probe_latency<<<1, threads>>>(static_cast<long long*>(out), iters);
    return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int run_cluster(void* out, int cluster, int threads, int iters) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, probe_cluster, static_cast<long long*>(out), iters);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaDeviceSynchronize());
}

// (threads, ppt) in {(32, 4), (256, 4), (256, 16), (512, 2), (512, 8), (1024, 1), (1024, 4)}
extern "C" int run_fps_variant(const void* xyz, void* idx, int b, int n, int m, int threads, int ppt,
                               int slots) {
    const float* x = static_cast<const float*>(xyz);
    int* out = static_cast<int*>(idx);
    return slots ? dispatch_variant<true>(x, out, b, n, m, threads, ppt)
                 : dispatch_variant<false>(x, out, b, n, m, threads, ppt);
}
