// Shared helpers of the port's point-op kernels.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace pan {

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Squared distance formed exactly as ops/pairwise.py forms it for d <= 4:
// ((0 + dx*dx) + dy*dy) + dz*dz, every product and sum rounded on its own.
// The _rn intrinsics are never contracted into fused multiply-adds, so the
// bits equal the plain torch version's and near-tied picks stay put. The
// leading 0 + dx*dx is dx*dx exactly and is left out.
__device__ __forceinline__ float sqdist3(float ax, float ay, float az,
                                         float bx, float by, float bz) {
    const float dx = __fsub_rn(ax, bx);
    const float dy = __fsub_rn(ay, by);
    const float dz = __fsub_rn(az, bz);
    float d = __fmul_rn(dx, dx);
    d = __fadd_rn(d, __fmul_rn(dy, dy));
    d = __fadd_rn(d, __fmul_rn(dz, dz));
    return d;
}

__device__ __forceinline__ bool lex_less(float v, int i, float w, int j) {
    return v < w || (v == w && i < j);
}

// Offer (v, i) to a list of the K smallest (value, index) pairs seen so far,
// kept sorted by value, then index. Empty slots hold (+inf, INT_MAX), so
// +inf values still fill them. The order is strict and total over distinct
// indices, so the list holds the K smallest pairs offered, the lowest index
// first on ties, whatever the order of the offers. Every array index is a
// compile-time constant after unrolling, so the list stays in registers.
template <int K>
__device__ __forceinline__ void offer(float (&val)[K], int (&idx)[K], float v, int i) {
    if (!lex_less(v, i, val[K - 1], idx[K - 1])) return;
    val[K - 1] = v;
    idx[K - 1] = i;
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
        if (lex_less(val[s], idx[s], val[s - 1], idx[s - 1])) {
            const float tv = val[s];
            val[s] = val[s - 1];
            val[s - 1] = tv;
            const int ti = idx[s];
            idx[s] = idx[s - 1];
            idx[s - 1] = ti;
        }
    }
}

}  // namespace pan

extern "C" const char* pan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
