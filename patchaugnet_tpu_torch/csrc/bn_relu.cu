// Eval BatchNorm followed by ReLU over a channels-last f32 tensor, in one pass.
//
// A port-only kernel (the JAX package leaves this to XLA's fusion). Semantics:
// y = relu((x - mean[c]) * mul[c] + bias[c]) over a (rows, C) row-major
// tensor, c = i % C, the expression of nn/core.py's eval BatchNorm and of
// torch.relu. torch runs it as four passes over the tensor (a subtraction, a
// product and a sum, each broadcasting a (C,) vector, then the clamp); here
// each element is read once and written once.
//
// Bit for bit: the three steps round one by one (__fsub_rn, __fmul_rn and
// __fadd_rn are never contracted into a fused multiply-add), and the clamp is
// torch's (a NaN passes through, anything else is fmaxf(v, 0)), so y equals
// the four passes' result in every bit, NaN and infinities included.
//
// Bound on the H100: bytes, 8 per element (one f32 read, one written); the
// per-channel vectors (C <= 1024 at every site) stay in L1 through the
// read-only path.
//
// Design: one float4 a thread where C % 4 == 0 and every pointer is 16-byte
// aligned, else one float, over a grid that covers the tensor (a grid-stride
// loop past 2^30 blocks); the channel is the unit's index modulo C. On an H100
// at the first SA level's shapes this reaches 89-90% of the bytes bound, what
// torch's copy_ reaches on the same bytes; a grid that only fills the SMs
// (8 or as many blocks per SM as fit), each block looping over tiles of 1-8
// units a thread, reached 82-86% (PERF.md).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 30;

__device__ __forceinline__ float bn_relu1(float x, float mean, float mul, float bias) {
    const float v = __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
    return isnan(v) ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ float bn_relu1(float x, const float* mean, const float* mul,
                                          const float* bias, int c) {
    return bn_relu1(x, __ldg(mean + c), __ldg(mul + c), __ldg(bias + c));
}

__device__ __forceinline__ float4 bn_relu1(float4 x, const float4* mean, const float4* mul,
                                           const float4* bias, int c) {
    const float4 m = __ldg(mean + c), s = __ldg(mul + c), b = __ldg(bias + c);
    return make_float4(bn_relu1(x.x, m.x, s.x, b.x), bn_relu1(x.y, m.y, s.y, b.y),
                       bn_relu1(x.z, m.z, s.z, b.z), bn_relu1(x.w, m.w, s.w, b.w));
}

// T is float or float4: n units of x and y, c units in a row.
template <typename T>
__global__ void __launch_bounds__(kThreads) bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ mean,
                                                           const T* __restrict__ mul, const T* __restrict__ bias,
                                                           T* __restrict__ y, long long n, int c) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride)
        y[i] = bn_relu1(x[i], mean, mul, bias, static_cast<int>(i % c));
}

template <typename T>
int launch(const void* x, const void* mean, const void* mul, const void* bias, void* y, long long n, int c,
           cudaStream_t stream) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
    bn_relu_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(mean), static_cast<const T*>(mul),
        static_cast<const T*>(bias), static_cast<T*>(y), n, c);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n / c, c) f32 contiguous; mean, mul, bias: (c,) f32 contiguous; y: the
// (n / c, c) f32 output, not overlapping x. n > 0 elements, c > 0 channels,
// n % c == 0. vec = 1 takes float4s: c % 4 == 0 and every pointer 16-byte
// aligned (the caller checks).
extern "C" int pan_bn_relu(const void* x, const void* mean, const void* mul, const void* bias, void* y,
                           long long n, int c, int vec, void* stream) {
    if (n <= 0 || c <= 0 || n % c != 0 || (vec && c % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec) return launch<float4>(x, mean, mul, bias, y, n / 4, c / 4, st);
    return launch<float>(x, mean, mul, bias, y, n, c, st);
}
