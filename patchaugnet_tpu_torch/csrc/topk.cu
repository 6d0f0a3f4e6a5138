// k smallest per row of a given matrix (kernel K3), and of a matrix plus a
// per-column price row (kernel K6).
//
// K3 replaces topk_extract_pallas (patchaugnet_tpu/ops/pallas/knn.py,
// _extract_kernel + _extract_sweeps). Semantics: for each row of a
// (rows, n) f32 matrix, the k smallest values in ascending order with their
// column indices, the lowest index among equal values. It also serves K4
// (topk_extract_chunked, two launches) and K5 (topk_extract_pair_pallas,
// the same function as K3).
//
// K6 replaces topk_extract_price_pallas (_extract_price_kernel and its k=2
// form _extract_price2_kernel): the same extraction over base + price, where
// base is (b, m, n) and price is (b, n), the row's batch element being
// row / m. The add is one __fadd_rn, the f32 add of the plain version, so
// values and picks equal extraction from the materialised sum bit for bit.
// The auction-EMD sweep (ops/emd.py) calls it once per iteration with k=2.
//
// Bound on the H100: bytes. Each element is read once and costs one compare
// (and one add for K6; the price row, 16 KB at n=4096, stays in L1/L2), so
// the kernel can go no faster than the matrix streams from memory. Design:
// one warp per row, so every load instruction reads 128 contiguous bytes.
// Lane l scans columns l, l + 32, ... in increasing order (four loads in
// flight per lane) and keeps a sorted top-K of its slice in registers, ties
// to the lower index. Then k rounds of a warp-shuffle minimum over the lanes'
// list heads, ordered by (value, index), emit the row's result; the lane that
// owned the winner pops its head. The k passes over the matrix of the TPU
// kernel become one.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 rows per block

template <int K, bool kPrice>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ dist, const float* __restrict__ price,
            int* __restrict__ idx, float* __restrict__ val, long long rows, int m, int n,
            int k) {
    const int lane = threadIdx.x & 31;
    const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
    if (row >= rows) return;  // uniform across the warp
    const float* r = dist + row * n;
    const float* p = kPrice ? price + (row / m) * n : nullptr;  // this row's price row

    float bd[K];
    int bi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
        bd[s] = pan::pos_inf();
        bi[s] = INT_MAX;
    }
    int j = lane;
    for (; j + 96 < n; j += 128) {
        float v0 = __ldg(r + j);
        float v1 = __ldg(r + j + 32);
        float v2 = __ldg(r + j + 64);
        float v3 = __ldg(r + j + 96);
        if constexpr (kPrice) {
            v0 = __fadd_rn(v0, __ldg(p + j));
            v1 = __fadd_rn(v1, __ldg(p + j + 32));
            v2 = __fadd_rn(v2, __ldg(p + j + 64));
            v3 = __fadd_rn(v3, __ldg(p + j + 96));
        }
        pan::offer<K>(bd, bi, v0, j);
        pan::offer<K>(bd, bi, v1, j + 32);
        pan::offer<K>(bd, bi, v2, j + 64);
        pan::offer<K>(bd, bi, v3, j + 96);
    }
    for (; j < n; j += 32) {
        float v = __ldg(r + j);
        if constexpr (kPrice) v = __fadd_rn(v, __ldg(p + j));
        pan::offer<K>(bd, bi, v, j);
    }

    const unsigned full = 0xffffffffu;
    const size_t o = static_cast<size_t>(row) * k;
    for (int s = 0; s < k; ++s) {
        float v = bd[0];
        int i = bi[0];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(full, v, off);
            const int oi = __shfl_xor_sync(full, i, off);
            if (pan::lex_less(ov, oi, v, i)) {
                v = ov;
                i = oi;
            }
        }
        if (bi[0] == i) {  // column indices are unique across lanes
#pragma unroll
            for (int t = 0; t < K - 1; ++t) {
                bd[t] = bd[t + 1];
                bi[t] = bi[t + 1];
            }
            bd[K - 1] = pan::pos_inf();
            bi[K - 1] = INT_MAX;
        }
        if (lane == 0) {
            idx[o + s] = i;
            val[o + s] = v;
        }
    }
}

template <int K, bool kPrice>
void launch(const float* dist, const float* price, int* idx, float* val, long long rows, int m,
            int n, int k, cudaStream_t st) {
    const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    topk_kernel<K, kPrice><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        dist, price, idx, val, rows, m, n, k);
}

// The register list is sized to the smallest instantiation that holds k.
template <bool kPrice>
int dispatch(const void* dist, const void* price, void* idx, void* val, long long rows, int m,
             int n, int k, void* stream) {
    const float* d = static_cast<const float*>(dist);
    const float* p = static_cast<const float*>(price);
    int* oi = static_cast<int*>(idx);
    float* ov = static_cast<float*>(val);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (k <= 1) {
        launch<1, kPrice>(d, p, oi, ov, rows, m, n, k, st);
    } else if (k <= 2) {
        launch<2, kPrice>(d, p, oi, ov, rows, m, n, k, st);
    } else if (k <= 3) {
        launch<3, kPrice>(d, p, oi, ov, rows, m, n, k, st);
    } else if (k <= 8) {
        launch<8, kPrice>(d, p, oi, ov, rows, m, n, k, st);
    } else if (k <= 16) {
        launch<16, kPrice>(d, p, oi, ov, rows, m, n, k, st);
    } else if (k <= 20) {
        launch<20, kPrice>(d, p, oi, ov, rows, m, n, k, st);
    } else if (k <= 32) {
        launch<32, kPrice>(d, p, oi, ov, rows, m, n, k, st);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dist: (rows, n) f32 contiguous; idx: (rows, k) i32 and val: (rows, k) f32
// outputs. 1 <= k <= min(n, 32).
extern "C" int pan_topk_extract(const void* dist, void* idx, void* val, long long rows, int n,
                                int k, void* stream) {
    return dispatch<false>(dist, nullptr, idx, val, rows, 1, n, k, stream);
}

// base: (b, m, n) f32 contiguous, rows = b * m; price: (b, n) f32
// contiguous; idx: (rows, k) i32 and val: (rows, k) f32 outputs, the k
// smallest of base[row] + price[row / m]. 1 <= k <= min(n, 32).
extern "C" int pan_topk_extract_price(const void* base, const void* price, void* idx, void* val,
                                      long long rows, int m, int n, int k, void* stream) {
    return dispatch<true>(base, price, idx, val, rows, m, n, k, stream);
}
