// k smallest per row of a given matrix (kernels K3 and K4), and of a matrix
// plus a per-column price row (kernel K6), whose rows may be read through a
// list of row ids (K6's active-set tail).
//
// Replaces, in patchaugnet_tpu/ops/pallas/knn.py:
// - topk_extract_pallas (K3; _extract_kernel + _extract_sweeps): for each
//   row of a (rows, n) f32 matrix, the k smallest values in ascending order
//   with their column indices, the lowest index among equal values. It also
//   serves topk_extract_pair_pallas (K5), the same function;
// - topk_extract_chunked (K4): the same result, which the TPU took in two
//   levels of chunks because a wide row outgrew its VMEM tile. Here the
//   chunks are the S warps of one launch (below), so no candidate list
//   makes a round trip through device memory;
// - topk_extract_price_pallas (K6; _extract_price_kernel and its k=2 form
//   _extract_price2_kernel): the same extraction over base + price, where
//   base is (b, m, n) and price is (b, n). The add is one __fadd_rn, the f32
//   add of the plain version, so values and picks equal extraction from the
//   materialised sum bit for bit. The auction-EMD sweep (ops/emd.py) calls
//   it once per iteration with k=2. Its active-set tail reads R rows per
//   batch element through their ids, clamping the padding sentinel m to row
//   m - 1 itself: the take_along_axis + extraction of the JAX active step
//   (patchaugnet_tpu/ops/emd.py:316-323) in one launch, with no gathered
//   copy of the rows written and read back.
//
// Bound on the H100: bytes. Each element is read once and costs one compare
// (and one add for K6; the price row, 16 KB at n=4096, stays in L1/L2), so
// the kernel can go no faster than the rows stream from memory. At the
// few-row shapes one warp per row leaves too few loads in flight to reach
// the memory rate: the auction's active-set tail (1024 rows of 4096) puts
// about 8 warps on each of the 132 SMs, and is limited by warps in flight.
// Design: S warps per row (S in {1, 2, 4, 8}; ops/topk.py::warps_for picks S
// from the row count, measured), warp w taking the w-th contiguous chunk of
// the row. Within a chunk each lane reads 16-byte float4s, one in flight at
// S = 1 and two where the row is split (4-byte loads where the row is not
// 16-byte aligned or the chunk is narrow), and keeps a sorted top-K of what
// it saw in registers, so one pass over the matrix replaces the TPU
// kernel's k.
// k rounds of a warp-shuffle minimum over the lanes' list heads give the
// warp's k best. With S = 1 the warp writes them as the row's result; with
// S > 1 each warp leaves them in shared memory and, after one barrier, the
// row's first warp merges the S * k candidates the same way.
//
// Exactness: every list orders (value, index) pairs by value, then index, a
// strict total order, so the k smallest pairs do not depend on how the row
// is cut into chunks or lanes or on the order of offers: every S gives the
// plain version's result bit for bit. A warp whose chunk holds fewer than k
// columns (n / S < k, or the short last chunk) yields (+inf, INT_MAX) for
// its missing picks, which the merge never takes over a real column.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // a block holds 8 / S rows

// Offers columns [begin, end) of row r (plus price row p where kPrice) to
// the lane's list, with D 16-byte loads in flight per lane where the chunk
// is 16-byte aligned and gives each lane four float4s or more; narrower
// chunks keep every lane busy with 4-byte loads (on an H100, float4s cost
// the FP levels' 128- and 16-wide rows 8-28% in device time).
template <int K, bool kPrice, int D>
__device__ __forceinline__ void scan(const float* __restrict__ r, const float* __restrict__ p,
                                     int begin, int end, int lane, float (&bd)[K], int (&bi)[K]) {
    uintptr_t addr = reinterpret_cast<uintptr_t>(r + begin);
    if constexpr (kPrice) addr |= reinterpret_cast<uintptr_t>(p + begin);
    if ((addr & 15) == 0 && end - begin >= 4 * 4 * 32) {  // the same for every lane of the warp
        const int nv = (end - begin) >> 2;  // whole float4s in the chunk
        const float4* r4 = reinterpret_cast<const float4*>(r + begin);
        const float4* p4 = nullptr;
        if constexpr (kPrice) p4 = reinterpret_cast<const float4*>(p + begin);
        int q = lane;
        for (; q + 32 * (D - 1) < nv; q += 32 * D) {
            float4 a[D];
#pragma unroll
            for (int u = 0; u < D; ++u) a[u] = __ldg(r4 + q + 32 * u);
            if constexpr (kPrice) {
#pragma unroll
                for (int u = 0; u < D; ++u) {
                    const float4 pa = __ldg(p4 + q + 32 * u);
                    a[u] = make_float4(__fadd_rn(a[u].x, pa.x), __fadd_rn(a[u].y, pa.y),
                                       __fadd_rn(a[u].z, pa.z), __fadd_rn(a[u].w, pa.w));
                }
            }
#pragma unroll
            for (int u = 0; u < D; ++u) {
                const int j = begin + 4 * (q + 32 * u);
                pan::offer<K>(bd, bi, a[u].x, j);
                pan::offer<K>(bd, bi, a[u].y, j + 1);
                pan::offer<K>(bd, bi, a[u].z, j + 2);
                pan::offer<K>(bd, bi, a[u].w, j + 3);
            }
        }
        for (; q < nv; q += 32) {
            float4 a = __ldg(r4 + q);
            if constexpr (kPrice) {
                const float4 pa = __ldg(p4 + q);
                a = make_float4(__fadd_rn(a.x, pa.x), __fadd_rn(a.y, pa.y), __fadd_rn(a.z, pa.z),
                                __fadd_rn(a.w, pa.w));
            }
            const int j = begin + 4 * q;
            pan::offer<K>(bd, bi, a.x, j);
            pan::offer<K>(bd, bi, a.y, j + 1);
            pan::offer<K>(bd, bi, a.z, j + 2);
            pan::offer<K>(bd, bi, a.w, j + 3);
        }
        const int j = begin + 4 * nv + lane;  // the chunk's last (end - begin) % 4 columns
        if (j < end) {
            float v = __ldg(r + j);
            if constexpr (kPrice) v = __fadd_rn(v, __ldg(p + j));
            pan::offer<K>(bd, bi, v, j);
        }
        return;
    }
    int j = begin + lane;
    for (; j + 96 < end; j += 128) {  // four 4-byte loads in flight per lane
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
    for (; j < end; j += 32) {
        float v = __ldg(r + j);
        if constexpr (kPrice) v = __fadd_rn(v, __ldg(p + j));
        pan::offer<K>(bd, bi, v, j);
    }
}

template <int K>
__device__ __forceinline__ void clear(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
        bd[s] = pan::pos_inf();
        bi[s] = INT_MAX;
    }
}

// The smallest (value, index) pair over the warp's list heads, by shuffles
// under the full mask; the lane that held it pops its head. Column indices
// are unique across lanes, so one lane pops, unless the warp has run out of
// columns and the minimum is the empty (+inf, INT_MAX): then every lane
// holding it pops one, and its list stays empty.
template <int K>
__device__ __forceinline__ void pop_min(float (&bd)[K], int (&bi)[K], float& v, int& i) {
    v = bd[0];
    i = bi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (pan::lex_less(ov, oi, v, i)) {
            v = ov;
            i = oi;
        }
    }
    if (bi[0] == i) {
#pragma unroll
        for (int t = 0; t < K - 1; ++t) {
            bd[t] = bd[t + 1];
            bi[t] = bi[t + 1];
        }
        bd[K - 1] = pan::pos_inf();
        bi[K - 1] = INT_MAX;
    }
}

// Output row `row` (of `rows`) reads source row `row`, or with kRowIds
// source row e * m + clamp(ids[e, row % r], 0, m - 1) of batch element
// e = row / r; the price row is that of the output row's batch element
// (row / m, or with kRowIds row / r).
template <int K, bool kPrice, bool kRowIds, int S>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ src, const float* __restrict__ price,
            const long long* __restrict__ ids, long long ids_stride, int* __restrict__ idx,
            float* __restrict__ val, long long rows, int m, int r, int n, int k) {
    // 16-byte loads in flight per lane: one where a warp streams a whole row
    // (two cost K6's full sweep 2% on an H100, in registers and occupancy),
    // two where the row is split (four were no faster there, and spilled)
    constexpr int kLoads = S == 1 ? 1 : 2;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long row = static_cast<long long>(blockIdx.x) * (kWarps / S) + warp / S;
    const bool live = row < rows;  // uniform across the row's S warps

    float bd[K];
    int bi[K];
    clear<K>(bd, bi);
    if (live) {
        long long src_row = row;
        const float* p = nullptr;
        if constexpr (kRowIds) {
            const long long e = row / r;
            const long long id = __ldg(ids + e * ids_stride + (row - e * r));
            src_row = e * m + (id < 0 ? 0 : id < m ? id : static_cast<long long>(m - 1));
            p = price + e * n;
        } else if constexpr (kPrice) {
            p = price + (row / m) * n;
        }
        // chunks of a multiple of 4 columns keep every chunk 16-byte aligned
        const int chunk = ((n + S - 1) / S + 3) & ~3;
        const int begin = min((warp % S) * chunk, n);
        scan<K, kPrice, kLoads>(src + src_row * n, p, begin, min(begin + chunk, n), lane, bd, bi);
    }

    const size_t o = static_cast<size_t>(row) * k;
    float v;
    int i;
    if constexpr (S == 1) {
        if (!live) return;
        for (int s = 0; s < k; ++s) {
            pop_min<K>(bd, bi, v, i);
            if (lane == 0) {
                idx[o + s] = i;
                val[o + s] = v;
            }
        }
    } else {
        __shared__ float sv[kWarps][K];
        __shared__ int si[kWarps][K];
        if (live) {
            for (int s = 0; s < k; ++s) {
                pop_min<K>(bd, bi, v, i);
                if (lane == 0) {
                    sv[warp][s] = v;
                    si[warp][s] = i;
                }
            }
        }
        __syncthreads();
        if (!live || warp % S != 0) return;
        clear<K>(bd, bi);
        for (int c = lane; c < S * k; c += 32) {
            pan::offer<K>(bd, bi, sv[warp + c / k][c % k], si[warp + c / k][c % k]);
        }
        for (int s = 0; s < k; ++s) {
            pop_min<K>(bd, bi, v, i);
            if (lane == 0) {
                idx[o + s] = i;
                val[o + s] = v;
            }
        }
    }
}

struct Args {
    const float* src;
    const float* price;
    const long long* ids;
    long long ids_stride;
    int* idx;
    float* val;
    long long rows;
    int m, r, n, k;
};

template <int K, bool kPrice, bool kRowIds, int S>
void launch(const Args& a, cudaStream_t st) {
    const long long blocks = (a.rows + kWarps / S - 1) / (kWarps / S);
    topk_kernel<K, kPrice, kRowIds, S><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        a.src, a.price, a.ids, a.ids_stride, a.idx, a.val, a.rows, a.m, a.r, a.n, a.k);
}

template <int K, bool kPrice, bool kRowIds>
bool launch_warps(const Args& a, int warps, cudaStream_t st) {
    switch (warps) {
        case 1: launch<K, kPrice, kRowIds, 1>(a, st); return true;
        case 2: launch<K, kPrice, kRowIds, 2>(a, st); return true;
        case 4: launch<K, kPrice, kRowIds, 4>(a, st); return true;
        case 8: launch<K, kPrice, kRowIds, 8>(a, st); return true;
        default: return false;
    }
}

// The register list is sized to the smallest instantiation that holds k;
// S must be one the build instantiates.
template <bool kPrice, bool kRowIds>
int dispatch(const Args& a, int warps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    bool ok;
    if (a.k <= 1) {
        ok = launch_warps<1, kPrice, kRowIds>(a, warps, st);
    } else if (a.k <= 2) {
        ok = launch_warps<2, kPrice, kRowIds>(a, warps, st);
    } else if (a.k <= 3) {
        ok = launch_warps<3, kPrice, kRowIds>(a, warps, st);
    } else if (a.k <= 8) {
        ok = launch_warps<8, kPrice, kRowIds>(a, warps, st);
    } else if (a.k <= 16) {
        ok = launch_warps<16, kPrice, kRowIds>(a, warps, st);
    } else if (a.k <= 20) {
        ok = launch_warps<20, kPrice, kRowIds>(a, warps, st);
    } else if (a.k <= 32) {
        ok = launch_warps<32, kPrice, kRowIds>(a, warps, st);
    } else {
        ok = false;
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3 and K4. dist: (rows, n) f32 contiguous; idx: (rows, k) i32 and val:
// (rows, k) f32 outputs. 1 <= k <= min(n, 32); warps (S) in {1, 2, 4, 8}.
extern "C" int pan_topk_extract(const void* dist, void* idx, void* val, long long rows, int n,
                                int k, int warps, void* stream) {
    const Args a{static_cast<const float*>(dist), nullptr, nullptr, 0, static_cast<int*>(idx),
                 static_cast<float*>(val), rows, 1, 1, n, k};
    return dispatch<false, false>(a, warps, stream);
}

// K6. base: (b, m, n) f32 contiguous, rows = b * m; price: (b, n) f32
// contiguous; idx: (rows, k) i32 and val: (rows, k) f32 outputs, the k
// smallest of base[row] + price[row / m]. 1 <= k <= min(n, 32).
extern "C" int pan_topk_extract_price(const void* base, const void* price, void* idx, void* val,
                                      long long rows, int m, int n, int k, int warps,
                                      void* stream) {
    const Args a{static_cast<const float*>(base), static_cast<const float*>(price), nullptr, 0,
                 static_cast<int*>(idx), static_cast<float*>(val), rows, m, 1, n, k};
    return dispatch<true, false>(a, warps, stream);
}

// K6 through row ids. base: (b, m, n) f32 contiguous; price: (b, n) f32
// contiguous; ids: (b, r) int64 with unit column stride and row stride
// ids_stride, each in [0, m] (m, the padding sentinel, reads row m - 1;
// an id outside [0, m - 1] is clamped into it); rows = b * r; idx: (rows, k)
// i32 and val: (rows, k) f32 outputs, row e * r + j the k smallest of
// base[e, clamp(ids[e, j], 0, m - 1)] + price[e].
extern "C" int pan_topk_extract_price_rows(const void* base, const void* price, const void* ids,
                                           long long ids_stride, void* idx, void* val,
                                           long long rows, int r, int m, int n, int k, int warps,
                                           void* stream) {
    const Args a{static_cast<const float*>(base), static_cast<const float*>(price),
                 static_cast<const long long*>(ids), ids_stride, static_cast<int*>(idx),
                 static_cast<float*>(val), rows, m, r, n, k};
    return dispatch<true, true>(a, warps, stream);
}
