// Farthest point sampling (kernel K1).
//
// Replaces farthest_point_sample_pallas (patchaugnet_tpu/ops/pallas/fps.py,
// _fps_kernel). Semantics: idx[0] = 0; a running min-distance per point,
// initialised to 1e10, is lowered by the squared distance to the point just
// picked (formed as ops/pairwise.py forms it); the next pick is its arg-max,
// the lowest index among equal values; m > n repeats picks.
//
// What bounds it on the H100: m - 1 dependent steps per cloud, each an O(n)
// update of the min-distances and an arg-max over them, and no step can start
// before the previous pick is known. The bytes (the cloud, read once) and the
// f32 operations (about ten per point and step) are far below what the card
// moves or computes in that time. Two costs add up in every step:
// - the dependent chain: the arg-max across the cloud's threads and the
//   hand-over of the pick's coordinates to every thread;
// - the update, which one block runs on one SM: n points x about 12
//   instructions (3 sub, 3 mul, 2 add, a min, and the thread's arg-max: a
//   max, a compare and a select) over the SM's 4 schedulers, each starting
//   one instruction a cycle: about 384 cycles a step at n = 4096 whatever
//   the thread count.
// No tensor core fits: the work is a min and an arg-max, not a product, and
// the distances must be rounded term by term to keep the picks bit-equal to
// the plain version. No TMA either: the cloud is read once.
//
// Design: one block of T threads per cloud, each thread holding PPT points'
// coordinates and min-distances in registers (point j on thread j mod T,
// slot j / T). ops/fps.py's layout_for chooses (T, PPT) per level; the
// layouts built below are those it can choose.
// - Arg-max on bits: a min-distance is fminf of 1e10 and a sum of squares
//   rounded to nearest, never below +0, so its bits order as ints. A warp's
//   arg-max is two redux.sync instructions: the largest key, then the lowest
//   index among the lanes that hold it. A thread reduces its own points as
//   a tree in which the higher slot of a pair wins only when strictly
//   larger, so it keeps its lowest index on ties. Padding slots hold -inf
//   (negative bits) and never win.
// - One barrier per pick: each warp's winning lane writes its key and index
//   into a shared slot, double-buffered by step parity; after the one
//   __syncthreads every warp reduces the winners itself with the same two
//   redux, so no warp waits for another to broadcast.
// - The pick's coordinates come from a copy of the cloud in shared memory,
//   one 16-byte read at the pick's index. (Passing them through the slots
//   from the winning lanes' registers costs each warp a chain of selects
//   per step: 9-21% slower above one warp, _probe_fps_design.py, PERF.md.)
// - A cloud that fits one warp (T = 32) needs no barrier at all.
// So nothing on the chain touches global memory. Clouds larger than the
// register layouts (n > 8192) keep the min-distances in a global scratch row
// and stride over it, with the same pick, and read the pick's coordinates
// back from the cloud in global memory.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScratchThreads = 1024;
constexpr int kSmemOptIn = 48 * 1024;   // dynamic shared memory above this needs an opt-in
constexpr int kMaxDevices = 64;

// The warps' winners of a step, double-buffered by step parity.
struct Winners {
    int key[2][32];
    int idx[2][32];
};

// Arg-max over the warp: the largest key, then the lowest index among the
// lanes holding it. Returns the index; ``best`` gets the key.
__device__ __forceinline__ int warp_argmax(int key, int idx, int& best) {
    best = __reduce_max_sync(kFull, key);
    return __reduce_min_sync(kFull, key == best ? idx : INT_MAX);
}

// The block's pick from every thread's best (key, idx), in every thread.
// Step s uses the winners' buffer s & 1.
template <int T>
__device__ __forceinline__ int block_pick(int key, int idx, int s, Winners& w) {
    int wkey;
    const int widx = warp_argmax(key, idx, wkey);
    if constexpr (T == 32) {
        return widx;
    } else {
        constexpr int kWarps = T / 32;
        const int lane = threadIdx.x & 31;
        const int buf = s & 1;
        if (idx == widx) {
            const int warp = threadIdx.x >> 5;
            w.key[buf][warp] = wkey;
            w.idx[buf][warp] = widx;
        }
        __syncthreads();
        const int k = lane < kWarps ? w.key[buf][lane] : INT_MIN;
        const int i = lane < kWarps ? w.idx[buf][lane] : INT_MAX;
        int gkey;
        return warp_argmax(k, i, gkey);
    }
}

template <int T, int PPT>
__global__ void __launch_bounds__(T)
fps_registers(const float* __restrict__ xyz, int* __restrict__ idx, int n, int m) {
    __shared__ Winners w;
    extern __shared__ float4 cloud[];   // (n,)
    const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
    int* out = idx + static_cast<size_t>(blockIdx.x) * m;

    float x[PPT], y[PPT], z[PPT], md[PPT];
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
        const int j = threadIdx.x + t * T;
        if (j < n) {
            x[t] = p[3 * j];
            y[t] = p[3 * j + 1];
            z[t] = p[3 * j + 2];
            md[t] = 1e10f;
            cloud[j] = make_float4(x[t], y[t], z[t], 0.f);
        } else {
            x[t] = y[t] = z[t] = 0.f;
            md[t] = -pan::pos_inf();   // never picked, and fminf keeps it
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) out[0] = 0;
    float4 q = cloud[0];
    for (int s = 1; s < m; ++s) {
        int key[PPT], at[PPT];
#pragma unroll
        for (int t = 0; t < PPT; ++t) {
            md[t] = fminf(md[t], pan::sqdist3(x[t], y[t], z[t], q.x, q.y, q.z));
            key[t] = __float_as_int(md[t]);
            at[t] = t;
        }
        // the thread's arg-max as a tree of depth log2(PPT); the higher
        // slot of a pair wins only if strictly larger
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
        const int gi = block_pick<T>(key[0], static_cast<int>(threadIdx.x) + at[0] * T, s, w);
        q = cloud[gi];
        if (threadIdx.x == 0) out[s] = gi;
    }
}

// Any n: the min-distances in a (b, n) global scratch row; thread i takes
// points i, i + T, ...
__global__ void __launch_bounds__(kScratchThreads)
fps_scratch(const float* __restrict__ xyz, float* __restrict__ mind, int* __restrict__ idx,
            int n, int m) {
    __shared__ Winners w;
    const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
    float* md = mind + static_cast<size_t>(blockIdx.x) * n;
    int* out = idx + static_cast<size_t>(blockIdx.x) * m;
    for (int j = threadIdx.x; j < n; j += kScratchThreads) md[j] = 1e10f;
    if (threadIdx.x == 0) out[0] = 0;
    float4 q = make_float4(p[0], p[1], p[2], 0.f);
    for (int s = 1; s < m; ++s) {
        int key = INT_MIN, bi = INT_MAX;
        for (int j = threadIdx.x; j < n; j += kScratchThreads) {
            const float v = fminf(md[j], pan::sqdist3(p[3 * j], p[3 * j + 1], p[3 * j + 2], q.x, q.y, q.z));
            md[j] = v;
            if (__float_as_int(v) > key) {
                key = __float_as_int(v);
                bi = j;
            }
        }
        const int gi = block_pick<kScratchThreads>(key, bi, s, w);
        q = make_float4(__ldg(p + 3 * gi), __ldg(p + 3 * gi + 1), __ldg(p + 3 * gi + 2), 0.f);
        if (threadIdx.x == 0) out[s] = gi;
    }
}

// K1's dependent-step floor, a measurement (profile_torch.py --kernels),
// never launched by the port: m - 1 picks of block_pick and the read of the
// pick's coordinates from shared memory, on K1's grid and block (two redux
// per warp, one barrier, two redux over the winners, two shared reads; at
// T = 32 the two redux and one read), each depending on the one before, with
// no update and no global memory.
template <int T>
__global__ void __launch_bounds__(T) step_floor(float* out, int steps) {
    __shared__ Winners w;
    __shared__ float4 cloud[T];
    cloud[threadIdx.x] = make_float4(static_cast<float>(threadIdx.x), 0.f, 0.f, 0.f);
    __syncthreads();
    float4 q = cloud[0];
    int gi = 0;
    for (int s = 0; s < steps; ++s) {
        const int key = (__float_as_int(q.x) & 0xffff) ^ static_cast<int>(threadIdx.x);
        gi = block_pick<T>(key, threadIdx.x, s, w);
        q = cloud[gi];
    }
    if (threadIdx.x == 0) out[blockIdx.x] = q.x + static_cast<float>(gi);
}

template <int T, int PPT>
int launch(int b, const float* x, int* out, int n, int m, cudaStream_t st) {
    const size_t smem = sizeof(float4) * n;
    if (smem > kSmemOptIn) {
        // once per device: allow the largest copy this layout holds
        static bool raised[kMaxDevices] = {};
        int dev = 0;
        cudaGetDevice(&dev);
        if (dev >= kMaxDevices || !raised[dev]) {
            const cudaError_t err = cudaFuncSetAttribute(fps_registers<T, PPT>,
                                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                         static_cast<int>(sizeof(float4)) * T * PPT);
            if (err != cudaSuccess) return static_cast<int>(err);
            if (dev < kMaxDevices) raised[dev] = true;
        }
    }
    fps_registers<T, PPT><<<b, T, smem, st>>>(x, out, n, m);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz: (b, n, 3) f32 contiguous; idx: (b, m) i32, every entry written;
// m >= 1, n >= 1. (threads, ppt) is the layout, one of ops/fps.py's LAYOUTS:
// threads per cloud and points per thread with threads * ppt >= n, or
// (1024, 0) for the scratch path, whose mind is a (b, n) f32 row (null
// otherwise).
extern "C" int pan_fps(const void* xyz, void* mind, void* idx, int b, int n, int m, int threads,
                       int ppt, void* stream) {
    const float* x = static_cast<const float*>(xyz);
    int* out = static_cast<int*>(idx);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (ppt == 0 && threads == kScratchThreads && mind != nullptr) {
        fps_scratch<<<b, kScratchThreads, 0, st>>>(x, static_cast<float*>(mind), out, n, m);
        return static_cast<int>(cudaGetLastError());
    }
    if (static_cast<long long>(threads) * ppt < n) return static_cast<int>(cudaErrorInvalidValue);
    if (threads == 32) {
        switch (ppt) {
            case 1: return launch<32, 1>(b, x, out, n, m, st);
            case 2: return launch<32, 2>(b, x, out, n, m, st);
            case 4: return launch<32, 4>(b, x, out, n, m, st);
            case 8: return launch<32, 8>(b, x, out, n, m, st);
        }
    } else if (ppt == 1) {
        switch (threads) {
            case 512: return launch<512, 1>(b, x, out, n, m, st);
            case 1024: return launch<1024, 1>(b, x, out, n, m, st);
        }
    } else if (ppt == 8) {
        switch (threads) {
            case 256: return launch<256, 8>(b, x, out, n, m, st);
            case 512: return launch<512, 8>(b, x, out, n, m, st);
            case 1024: return launch<1024, 8>(b, x, out, n, m, st);
        }
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// out: (b,) f32. The floor of pan_fps on b clouds with m picks, at `threads`
// threads per cloud.
extern "C" int pan_fps_step_floor(void* out, int b, int m, int threads, void* stream) {
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (threads) {
        case 32: step_floor<32><<<b, 32, 0, st>>>(o, m - 1); break;
        case 256: step_floor<256><<<b, 256, 0, st>>>(o, m - 1); break;
        case 512: step_floor<512><<<b, 512, 0, st>>>(o, m - 1); break;
        case 1024: step_floor<1024><<<b, 1024, 0, st>>>(o, m - 1); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
