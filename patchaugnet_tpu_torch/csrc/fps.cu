// Farthest point sampling (kernel K1).
//
// Replaces farthest_point_sample_pallas (patchaugnet_tpu/ops/pallas/fps.py,
// _fps_kernel). Semantics: idx[0] = 0; a running min-distance per point,
// initialised to 1e10, is lowered by the squared distance to the point just
// picked; the next pick is its arg-max, the lowest index among equal values.
//
// Bound on the H100: m - 1 dependent steps per cloud. Each step is an O(n)
// update and a block-wide arg-max, and no step can start before the previous
// pick is known, so latency (two barriers and a dependent load per step), not
// bytes or FLOPs, sets the time. Design: one block per cloud; each thread
// keeps PPT points' coordinates and min-distances in registers (no memory
// traffic per step), reduces its own points, then a warp-shuffle arg-max
// and one across warps through shared memory give the pick to every thread.
// The picked point's coordinates are re-read through the read-only cache.
// Clouds larger than 1024 * kMaxPPT points keep the min-distances in a
// global scratch row instead of registers.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPPT = 8;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
    return v > bv || (v == bv && i < bi);
}

// Arg-max of (v, i) over the block, lowest index among equal values.
// Every thread gets the winning index. blockDim.x is a multiple of 32.
__device__ __forceinline__ int block_argmax(float v, int i, float* s_v, int* s_i) {
    const unsigned full = 0xffffffffu;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(full, v, off);
        const int oi = __shfl_down_sync(full, i, off);
        if (better(ov, oi, v, i)) {
            v = ov;
            i = oi;
        }
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        s_v[warp] = v;
        s_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
        const int nwarps = blockDim.x >> 5;
        v = lane < nwarps ? s_v[lane] : -pan::pos_inf();
        i = lane < nwarps ? s_i[lane] : INT_MAX;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(full, v, off);
            const int oi = __shfl_down_sync(full, i, off);
            if (better(ov, oi, v, i)) {
                v = ov;
                i = oi;
            }
        }
        if (lane == 0) s_i[32] = i;
    }
    __syncthreads();
    return s_i[32];
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_registers(const float* __restrict__ xyz, int* __restrict__ idx, int n, int m) {
    __shared__ float s_v[32];
    __shared__ int s_i[33];
    const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
    int* out = idx + static_cast<size_t>(blockIdx.x) * m;

    float x[PPT], y[PPT], z[PPT], md[PPT];
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
        const int j = threadIdx.x + t * blockDim.x;
        if (j < n) {
            x[t] = p[3 * j];
            y[t] = p[3 * j + 1];
            z[t] = p[3 * j + 2];
            md[t] = 1e10f;
        } else {
            x[t] = y[t] = z[t] = 0.f;
            md[t] = -pan::pos_inf();  // never picked
        }
    }
    if (threadIdx.x == 0) out[0] = 0;
    int last = 0;
    for (int s = 1; s < m; ++s) {
        const float px = __ldg(p + 3 * last);
        const float py = __ldg(p + 3 * last + 1);
        const float pz = __ldg(p + 3 * last + 2);
        float bv = -pan::pos_inf();
        int bi = INT_MAX;
#pragma unroll
        for (int t = 0; t < PPT; ++t) {
            const int j = threadIdx.x + t * blockDim.x;
            if (j < n) {
                md[t] = fminf(md[t], pan::sqdist3(x[t], y[t], z[t], px, py, pz));
                if (better(md[t], j, bv, bi)) {
                    bv = md[t];
                    bi = j;
                }
            }
        }
        last = block_argmax(bv, bi, s_v, s_i);
        if (threadIdx.x == 0) out[s] = last;
    }
}

// Any n: min-distances in a (b, n) global scratch row; each thread strides.
__global__ void __launch_bounds__(kThreads)
fps_scratch(const float* __restrict__ xyz, float* __restrict__ mind, int* __restrict__ idx,
            int n, int m) {
    __shared__ float s_v[32];
    __shared__ int s_i[33];
    const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
    float* md = mind + static_cast<size_t>(blockIdx.x) * n;
    int* out = idx + static_cast<size_t>(blockIdx.x) * m;
    for (int j = threadIdx.x; j < n; j += blockDim.x) md[j] = 1e10f;
    if (threadIdx.x == 0) out[0] = 0;
    int last = 0;
    for (int s = 1; s < m; ++s) {
        const float px = __ldg(p + 3 * last);
        const float py = __ldg(p + 3 * last + 1);
        const float pz = __ldg(p + 3 * last + 2);
        float bv = -pan::pos_inf();
        int bi = INT_MAX;
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
            const float v = fminf(md[j], pan::sqdist3(p[3 * j], p[3 * j + 1], p[3 * j + 2], px, py, pz));
            md[j] = v;
            if (better(v, j, bv, bi)) {
                bv = v;
                bi = j;
            }
        }
        last = block_argmax(bv, bi, s_v, s_i);
        if (threadIdx.x == 0) out[s] = last;
    }
}

int threads_for(int n, int ppt) {
    const int per = (n + ppt - 1) / ppt;
    return ((per + 31) / 32) * 32;
}

// Points per thread for a cloud of n points; 0 takes the scratch row.
int ppt_for(int n) {
    if (n <= kThreads) return 1;
    if (n <= 2 * kThreads) return 2;
    if (n <= 4 * kThreads) return 4;
    return n <= kMaxPPT * kThreads ? kMaxPPT : 0;
}

// K1's latency floor, a measurement (profile_torch.py --kernels), never
// launched by the port. Each of K1's m - 1 picks waits on the one before,
// and a pick needs at least a shuffle tree over each warp, one block barrier
// to publish the warps' winners, and a shuffle tree over those winners. This
// kernel runs exactly that, m - 1 times, on K1's grid and block for the same
// cloud: one shuffle and one max per round (an arg-max moves its index in a
// second, independent shuffle), the winners double-buffered so that one
// barrier per step is enough, and no loads, distances or stores. Its time is
// a lower bound on K1's at that shape.
template <int R>   // rounds of the tree over the warps' winners
__global__ void __launch_bounds__(kThreads) step_floor(float* out, int steps) {
    __shared__ float s_v[2][32];
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    float v = static_cast<float>(threadIdx.x);
    for (int s = 0; s < steps; ++s) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(full, v, off));
        if (lane == 0) s_v[s & 1][warp] = v;
        __syncthreads();
        float w = lane < nwarps ? s_v[s & 1][lane] : -pan::pos_inf();
#pragma unroll
        for (int off = (1 << R) >> 1; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(full, w, off));
        v = w - static_cast<float>(threadIdx.x);   // the next step depends on this pick
    }
    if (threadIdx.x == 0) out[blockIdx.x] = v;
}

}  // namespace

// xyz: (b, n, 3) f32 contiguous; idx: (b, m) i32; mind: (b, n) f32 scratch,
// used only when n > 1024 * kMaxPPT. m >= 1.
extern "C" int pan_fps(const void* xyz, void* mind, void* idx, int b, int n, int m,
                       void* stream) {
    const float* x = static_cast<const float*>(xyz);
    int* out = static_cast<int*>(idx);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int ppt = ppt_for(n);
    const int threads = ppt ? threads_for(n, ppt) : kThreads;
    switch (ppt) {
        case 1: fps_registers<1><<<b, threads, 0, st>>>(x, out, n, m); break;
        case 2: fps_registers<2><<<b, threads, 0, st>>>(x, out, n, m); break;
        case 4: fps_registers<4><<<b, threads, 0, st>>>(x, out, n, m); break;
        case kMaxPPT: fps_registers<kMaxPPT><<<b, threads, 0, st>>>(x, out, n, m); break;
        default: fps_scratch<<<b, kThreads, 0, st>>>(x, static_cast<float*>(mind), out, n, m);
    }
    return static_cast<int>(cudaGetLastError());
}

// out: (b,) f32. The floor of pan_fps on b clouds of n points, m picks.
extern "C" int pan_fps_step_floor(void* out, int b, int n, int m, void* stream) {
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int ppt = ppt_for(n);
    const int threads = ppt ? threads_for(n, ppt) : kThreads;
    int rounds = 0;   // ceil(log2(warps per block))
    while ((32 << rounds) < threads) ++rounds;
    switch (rounds) {
        case 0: step_floor<0><<<b, threads, 0, st>>>(o, m - 1); break;
        case 1: step_floor<1><<<b, threads, 0, st>>>(o, m - 1); break;
        case 2: step_floor<2><<<b, threads, 0, st>>>(o, m - 1); break;
        case 3: step_floor<3><<<b, threads, 0, st>>>(o, m - 1); break;
        case 4: step_floor<4><<<b, threads, 0, st>>>(o, m - 1); break;
        default: step_floor<5><<<b, threads, 0, st>>>(o, m - 1);
    }
    return static_cast<int>(cudaGetLastError());
}
