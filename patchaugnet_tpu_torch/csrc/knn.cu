// Exact k nearest neighbours of 3-d points (kernel K2).
//
// Replaces knn_fused_pallas (patchaugnet_tpu/ops/pallas/knn.py,
// _fused_knn_kernel + _extract_sweeps). Semantics: d^2 formed as
// ops/pairwise.py forms it, with its clamp at 0; the k smallest per query in
// ascending (d^2, index) order, the lowest candidate index among equal
// distances; any b, any n, any 1 <= k <= n.
//
// Bound on the H100: f32 operations. Every (query, candidate) pair costs a
// distance (3 sub, 3 mul, 2 add) and a compare against the current k-th,
// while the inputs are a few MB.
//
// Why one thread per query was slow (the first port of this kernel): at the
// first SA level, B=32 gives 32 x 1024 queries, 1024 warps for 132 SMs, about
// 8 resident warps per SM, an eighth of what an SM holds. Each thread then
// walked 4096 candidates in a serial chain of shared-memory loads and
// insertions into a 20-deep register list, and nothing hid the latency.
// Splitting the candidates over G lanes that each keep their own k-list
// (the top-k kernel's layout) would fill the card, but by reasoning, not
// measurement (that layout was not built), it would not cut the work: 32
// lanes with independent lists give a warp an insertion (k compare-swaps)
// on most steps while the lists fill, since each fills on its own.
//
// Design: G lanes per query (G in {4, 8, 16, 32}, chosen per shape by
// ops/knn.py), 256 / G queries of one cloud per 256-thread block.
// - Candidate tiles in shared memory, shared by all the block's queries:
//   the flat (n*3) f32 row is read with coalesced 16-byte loads where it is
//   16-byte aligned and stored as one (x, y, z, pad) float4 per candidate, so
//   a lane reads a candidate with one 16-byte load.
// - Lane l of a group takes tile positions l, l + G, ... and forms their
//   distances; a step of the group thus covers G consecutive candidates.
// - The group keeps ONE sorted list of its query's best (d^2, index) pairs,
//   spread over its lanes: lane l holds positions l*P .. l*P + P - 1 in
//   registers (P = ceil(k / G)). Its k-th entry is the reject threshold of
//   every lane, so a lane inserts only what beats the best k of all
//   candidates the group has seen, not of its own slice.
// - The merge of a step's accepted candidates into the list is G-wide:
//   a ballot names the lanes whose candidate beats the threshold; one at a
//   time, the candidate is broadcast by a shuffle, every lane inserts it
//   into its P slots (each slot takes its predecessor, the candidate or
//   itself; the predecessor of a lane's first slot comes from the lane
//   below by a shuffle), and the new k-th entry is shuffled back out as the
//   threshold. An insertion costs P slot updates per lane, not k, and
//   after the list has filled few candidates get that far.
// - The group merges its candidates in increasing index order (step by
//   step, lowest lane first), so a candidate's index is above every index
//   in the list: it goes after entries of equal d^2, and the comparisons
//   need d^2 alone. A d^2 is a sum of squares rounded term by term, never
//   below +0 (the clamp at 0 of ops/pairwise.py never fires), and a float
//   >= +0 orders as its unsigned bits, so each comparison is one unsigned
//   compare; an empty slot holds the bits just above +inf, and a NaN,
//   whose bits lie at or above those, is never taken.
// The list thus holds the k smallest (d^2, index) pairs in ascending order,
// the lowest index on ties. The scan streams the tiles, so there is no tile
// limit on n as on the TPU.
// - A list holds G * P <= 96 entries (P <= kMaxSlots). A larger k runs at
//   G = 32, P = 3 in passes over the candidates, all in the one launch: pass
//   p extracts the next 96 (or what is left of k) among the pairs that
//   follow the previous pass's last (d^2, index) pair in that order, a
//   strict total order, so the passes together give the k smallest exactly.
// - The grid's second axis is the cloud; a batch of more than 65535 clouds
//   launches once per 65535 (one grid of one flat axis was 8% slower at
//   the FP0 3-NN on an H100).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;   // candidates per shared-memory tile (32 KB of float4)
constexpr int kUnroll = 4;    // steps whose distances are formed before one vote
constexpr unsigned kFull = 0xffffffffu;
// An empty list slot: the bits just above +inf's, the lowest NaN pattern, so no
// NaN d^2 is ever taken.
constexpr unsigned kEmpty = 0x7f800001u;

__device__ __forceinline__ void put(float* s, int f, float v) {
    s[(f / 3) * 4 + f % 3] = v;   // float f of the flat row: candidate f / 3, coordinate f % 3
}

// Candidates [base, base + cnt) of the cloud's flat (n*3) row into s as float4s.
__device__ __forceinline__ void load_tile(const float* __restrict__ pts, int base, int cnt,
                                          float4* s) {
    const float* src = pts + static_cast<size_t>(base) * 3;
    float* dst = reinterpret_cast<float*>(s);
    const int nf = cnt * 3;
    int f = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const float4* src4 = reinterpret_cast<const float4*>(src);
        const int n4 = nf >> 2;
        for (int v = threadIdx.x; v < n4; v += kThreads) {
            const float4 w = __ldg(src4 + v);
            put(dst, 4 * v, w.x);
            put(dst, 4 * v + 1, w.y);
            put(dst, 4 * v + 2, w.z);
            put(dst, 4 * v + 3, w.w);
        }
        f = n4 << 2;
    }
    for (f += threadIdx.x; f < nf; f += kThreads) put(dst, f, __ldg(src + f));
}

// Merge the group's accepted candidates (acc, with (d, ci)) into its list,
// lowest lane first; refresh the threshold tv after each. Called by the
// whole warp; each group of G lanes works on its own list.
template <int G, int P>
__device__ __forceinline__ void merge(bool acc, unsigned d, int ci, unsigned (&lv)[P],
                                      int (&li)[P], unsigned& tv, int gl, int t_lane, int t_slot) {
    constexpr unsigned kGroup = G == 32 ? kFull : (1u << G) - 1u;
    unsigned pending = (__ballot_sync(kFull, acc) >> ((threadIdx.x & 31) & ~(G - 1))) & kGroup;
    while (__any_sync(kFull, pending != 0)) {
        // a group with nothing pending runs the loop with the warp and inserts nothing
        const bool live = pending != 0;
        const int src = live ? __ffs(pending) - 1 : 0;
        pending &= pending - 1;
        const unsigned xv = __shfl_sync(kFull, d, src, G);
        const int xi = __shfl_sync(kFull, ci, src, G);
        unsigned pv = __shfl_up_sync(kFull, lv[P - 1], 1, G);   // the lane below's last entry
        int pi = __shfl_up_sync(kFull, li[P - 1], 1, G);
        if (live && xv < tv) {   // uniform over the group
            // new[s] = old[s-1] if x precedes old[s-1], else x if x precedes old[s], else old[s]
            bool before_prev = gl != 0 && xv < pv;
#pragma unroll
            for (int j = 0; j < P; ++j) {
                const unsigned ov = lv[j];
                const int oi = li[j];
                const bool before = xv < ov;
                lv[j] = before_prev ? pv : (before ? xv : ov);
                li[j] = before_prev ? pi : (before ? xi : oi);
                pv = ov;
                pi = oi;
                before_prev = before;
            }
        }
        unsigned sv = lv[0];
#pragma unroll
        for (int j = 1; j < P; ++j) sv = t_slot == j ? lv[j] : sv;
        tv = __shfl_sync(kFull, sv, t_lane, G);
    }
}

// (d, ci) after (lo_v, lo_i) in the (d^2, index) order; d and lo_v as bits
__device__ __forceinline__ bool after(unsigned d, int ci, unsigned lo_v, int lo_i) {
    return d > lo_v || (d == lo_v && ci > lo_i);
}

// One pass: the kp smallest (d^2, index) pairs of the cloud's candidates
// for this lane's query, after (lo_v, lo_i) where kPasses, written at
// positions off .. off + kp - 1 of the query's output row o; (lo_v, lo_i)
// becomes the pass's last pair.
template <int G, int P, bool kPasses>
__device__ __forceinline__ void knn_pass(const float* __restrict__ pts, float qx, float qy,
                                         float qz, int gl, bool active, size_t o,
                                         int* __restrict__ idx, float* __restrict__ d2, int n,
                                         int off, int kp, unsigned& lo_v, int& lo_i) {
    __shared__ float4 s_pts[kTile];
    unsigned lv[P];
    int li[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        lv[j] = kEmpty;
        li[j] = INT_MAX;
    }
    // the list's entry kp - 1 (lane t_lane, slot t_slot) is the threshold
    const int t_lane = (kp - 1) / P, t_slot = (kp - 1) % P;
    unsigned tv = kEmpty;

    for (int base = 0; base < n; base += kTile) {
        const int cnt = min(kTile, n - base);
        __syncthreads();   // the previous tile is consumed
        load_tile(pts, base, cnt, s_pts);
        __syncthreads();
        const int full = cnt / G;              // steps with every lane in the tile
        const int steps = (cnt + G - 1) / G;   // both uniform over the block
        int t = 0;
        for (; t + kUnroll <= full; t += kUnroll) {
            unsigned d[kUnroll];
            unsigned least = ~0u;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const float4 p = s_pts[gl + (t + u) * G];
                d[u] = __float_as_uint(pan::sqdist3(qx, qy, qz, p.x, p.y, p.z));
                if constexpr (kPasses) {
                    if (!after(d[u], base + gl + (t + u) * G, lo_v, lo_i)) d[u] = ~0u;
                }
                least = min(least, d[u]);
            }
            if (__any_sync(kFull, least < tv)) {
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    merge<G, P>(d[u] < tv, d[u], base + gl + (t + u) * G, lv, li, tv, gl, t_lane,
                                t_slot);
                }
            }
        }
        for (; t < steps; ++t) {
            const int c = gl + t * G;
            unsigned d = ~0u;   // past the tile: never taken
            if (c < cnt) {
                const float4 p = s_pts[c];
                d = __float_as_uint(pan::sqdist3(qx, qy, qz, p.x, p.y, p.z));
                if constexpr (kPasses) {
                    if (!after(d, base + c, lo_v, lo_i)) d = ~0u;
                }
            }
            merge<G, P>(d < tv, d, base + c, lv, li, tv, gl, t_lane, t_slot);
        }
    }
    if (active) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const int pos = gl * P + j;
            if (pos < kp) {
                idx[o + off + pos] = li[j];
                d2[o + off + pos] = __uint_as_float(lv[j]);
            }
        }
    }
    if constexpr (kPasses) {   // the pass's last pair bounds the next pass
        int si = li[0];
#pragma unroll
        for (int j = 1; j < P; ++j) si = t_slot == j ? li[j] : si;
        lo_v = tv;
        lo_i = __shfl_sync(kFull, si, t_lane, G);
    }
}

template <int G, int P, bool kPasses>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
           int* __restrict__ idx, float* __restrict__ d2, int n, int m, int k) {
    constexpr int kQueries = kThreads / G;
    const int b = blockIdx.y;
    const int gl = threadIdx.x % G;                       // lane within the group
    const int q = blockIdx.x * kQueries + threadIdx.x / G;
    const bool active = q < m;
    const float* pts = xyz + static_cast<size_t>(b) * n * 3;

    // a group past the last query sees only NaN distances and takes nothing
    float qx = __int_as_float(0x7fffffff), qy = qx, qz = qx;
    if (active) {
        const float* qp = new_xyz + (static_cast<size_t>(b) * m + q) * 3;
        qx = qp[0];
        qy = qp[1];
        qz = qp[2];
    }
    const size_t o = (static_cast<size_t>(b) * m + q) * k;
    // the previous pass's last pair; the first pass takes every candidate
    unsigned lo_v = 0u;
    int lo_i = -1;
    if constexpr (kPasses) {
        for (int off = 0; off < k; off += G * P) {
            knn_pass<G, P, true>(pts, qx, qy, qz, gl, active, o, idx, d2, n, off,
                                 min(k - off, G * P), lo_v, lo_i);
        }
    } else {
        knn_pass<G, P, false>(pts, qx, qy, qz, gl, active, o, idx, d2, n, 0, k, lo_v, lo_i);
    }
}

template <int G, int P, bool kPasses>
void launch(const float* xyz, const float* new_xyz, int* idx, float* d2, int b, int n, int m,
            int k, cudaStream_t st) {
    constexpr int kQueries = kThreads / G;
    for (int b0 = 0; b0 < b; b0 += 65535) {   // a grid's second axis takes 65535 clouds
        const dim3 grid((m + kQueries - 1) / kQueries, min(b - b0, 65535));
        const size_t cloud = static_cast<size_t>(b0);
        knn_kernel<G, P, kPasses><<<grid, kThreads, 0, st>>>(
            xyz + cloud * n * 3, new_xyz + cloud * m * 3, idx + cloud * m * k, d2 + cloud * m * k,
            n, m, k);
    }
}

// The list holds G * P entries, P = ceil(k / G) slots per lane, at most
// kMaxSlots (ops/knn.py's _MAX_SLOTS, which its lanes rule keeps to); a k
// beyond 32 * kMaxSlots runs in passes at G = 32.
constexpr int kMaxSlots = 3;

template <int G, int P>
int dispatch(int p, const float* x, const float* q, int* oi, float* od, int b, int n, int m,
             int k, cudaStream_t st) {
    if (p == P) {
        launch<G, P, false>(x, q, oi, od, b, n, m, k, st);
        return static_cast<int>(cudaGetLastError());
    }
    if constexpr (P < kMaxSlots) {
        return dispatch<G, P + 1>(p, x, q, oi, od, b, n, m, k, st);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// xyz: (b, n, 3), new_xyz: (b, m, 3) f32 contiguous; idx: (b, m, k) i32 and
// d2: (b, m, k) f32 outputs. 1 <= k <= n; lanes (G) in {4, 8, 16, 32} with
// ceil(k / G) <= kMaxSlots, or G = 32 at any k (passes of 96); any b.
extern "C" int pan_knn(const void* xyz, const void* new_xyz, void* idx, void* d2, int b, int n,
                       int m, int k, int lanes, void* stream) {
    const float* x = static_cast<const float*>(xyz);
    const float* q = static_cast<const float*>(new_xyz);
    int* oi = static_cast<int*>(idx);
    float* od = static_cast<float*>(d2);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
    switch (lanes) {
        case 4: return dispatch<4, 1>((k + 3) / 4, x, q, oi, od, b, n, m, k, st);
        case 8: return dispatch<8, 1>((k + 7) / 8, x, q, oi, od, b, n, m, k, st);
        case 16: return dispatch<16, 1>((k + 15) / 16, x, q, oi, od, b, n, m, k, st);
        case 32:
            if (k > 32 * kMaxSlots) {
                launch<32, kMaxSlots, true>(x, q, oi, od, b, n, m, k, st);
                return static_cast<int>(cudaGetLastError());
            }
            return dispatch<32, 1>((k + 31) / 32, x, q, oi, od, b, n, m, k, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
