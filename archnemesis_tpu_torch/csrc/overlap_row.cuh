// One row of the random-overlap combine, run by one warp: the row code that
// the fused combine kernel (overlap_combine.cu: combine_tan_kernel) and the
// combine's A/B variants (overlap_variants.cu) share, so that the variants
// measure the parts of the combine in its own layout; the primal kernel
// (combine_primal_kernel, one thread per row) gives its bits.
// overlap_combine.cu describes the steps and what bounds them;
// combine_row's template arguments choose where a variant stops or turns
// off (kernel 1t takes the defaults: the combine as it was written for it,
// the same instructions).
//
// Every definition has internal linkage: the header is included once by
// each kernel source, which is one library of its own.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Limits;
template <> struct Limits<float> {
  __device__ static float max() { return FLT_MAX; }
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float eps() { return FLT_EPSILON; }
};
template <> struct Limits<double> {
  __device__ static double max() { return DBL_MAX; }
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double eps() { return DBL_EPSILON; }
};

// a * b + c rounded once, in both kernels alike
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

constexpr int kMaxWarps = 16;              // rows per block, at most
constexpr int kPairSlots = kWarp * kWarp;  // w2 by packed index (ia << 5) | ib
constexpr int kEdgeSlots = 40;             // NG + 1 <= 33 edges, padded
constexpr int kSlackEps = 128;             // the rebin's g-axis slack, in eps
constexpr size_t kMaxSmem = 232448;        // bytes of shared memory a block

// A sorted element: its key and its packed original index pair; and, once
// the keys are sorted, its prefix sum and weight. Both are one 8-byte
// (float) or 16-byte (double) shared-memory access.
template <typename T>
struct __align__(2 * sizeof(T)) Elem {
  T key;
  uint32_t pay;
};
template <typename T>
struct __align__(2 * sizeof(T)) Span {
  T ghi;
  T w;
};
static_assert(sizeof(Elem<float>) == 8 && sizeof(Elem<double>) == 16, "");
static_assert(sizeof(Span<float>) == 8 && sizeof(Span<double>) == 16, "");
// The element of a merge of keys alone (no index pair to carry); it takes
// the index pair in its constructor, so that the merge's code builds both.
template <typename T>
struct Key {
  T key;
  __device__ Key(T k, uint32_t) : key(k) {}
};
static_assert(sizeof(Key<float>) == 4 && sizeof(Key<double>) == 8, "");

__host__ __device__ constexpr int round_up4(int x) { return (x + 3) & ~3; }

// Shared memory of the primal kernel: per block the pair weights by packed
// index and the bin edges; per warp two element buffers of n = NG*NG
// (rounded up to 4), the row's sorted a and b and their original indices.
// Every part is a multiple of 16 bytes.
template <typename T>
__host__ __device__ size_t primal_block_bytes() {
  return (kPairSlots + kEdgeSlots) * sizeof(T);
}
template <typename T>
__host__ __device__ size_t primal_warp_bytes(int n) {
  return 2 * static_cast<size_t>(round_up4(n)) * sizeof(Elem<T>) +
         2 * kWarp * sizeof(T) + 2 * kWarp;
}

// primal_warp_bytes for a row of elements E (Elem<T> or Key<T>).
template <typename T, typename E>
__host__ __device__ size_t row_warp_bytes(int n) {
  return 2 * static_cast<size_t>(round_up4(n)) * sizeof(E) +
         2 * kWarp * sizeof(T) + 2 * kWarp;
}

// Rows per block, a power of two up to max_warps, that keeps the most rows
// resident on an SM of sm_smem bytes of shared memory (with few warps
// resident the row code is bound by latency), the smaller block on a tie;
// 0 if none fits.
inline int resident_warps(size_t block_bytes, size_t per_warp, int sm_smem,
                          int max_warps) {
  int best = 0, warps = 0;
  for (int w = kMaxWarps; w >= 1; w /= 2) {
    if (w > max_warps) continue;
    const size_t smem = block_bytes + w * per_warp;
    if (smem > kMaxSmem) continue;
    // 1 KB of each block's shared memory is the system's
    const int blocks =
        min(min(static_cast<int>(sm_smem / (smem + 1024)), 64 / w), 32);
    if (blocks >= 1 && blocks * w >= best) {
      best = blocks * w;
      warps = w;
    }
  }
  return warps;
}

// The block's weight table (w2s[(ia << 5) | ib] = w2[ia * NG + ib], the
// same bits) and bin edges, loaded by every thread; ends in a barrier.
template <typename T>
__device__ void load_tables(T* w2s, T* edge_s, const T* __restrict__ w2,
                            const T* __restrict__ edges, int ng) {
  for (int x = threadIdx.x; x < kPairSlots; x += blockDim.x) {
    const int ia = x / kWarp;
    const int ib = x - ia * kWarp;
    w2s[x] = (ia < ng && ib < ng) ? w2[ia * ng + ib] : T(0);
  }
  for (int x = threadIdx.x; x <= ng; x += blockDim.x) edge_s[x] = edges[x];
  __syncthreads();
}

// What combine_row does after the merge (step 3).
enum RowTail {
  kWalk = 0,        // steps 4-6: the scan and lane j's walk of bin j
  kMergeOnly = 1,   // nothing: lane j < NG writes the j-th smallest key
  kEdgeSearch = 2,  // edge_search_rebin
};

// S(x) and W(x), the key-weighted and the plain weight of the sorted row
// below g = x: the first element whose upper end lies above x less the
// slack (binary search), then on to the first whose upper end lies above
// x; the elements before it count whole (their prefix sums), it counts its
// clipped part. buf[e].pay holds the bits of the prefix sum of key *
// weight (float32).
__device__ __forceinline__ void edge_sums(const Elem<float>* buf,
                                          const Span<float>* span, int n,
                                          float x, float& s, float& w) {
  using T = float;
  const T first = x - T(kSlackEps) * Limits<T>::eps();
  int e = 0, top = n;
  while (e < top) {
    const int c = (e + top) >> 1;
    if (span[c].ghi > first) {
      top = c;
    } else {
      e = c + 1;
    }
  }
  while (e < n && span[e].ghi <= x) ++e;
  s = e > 0 ? __uint_as_float(buf[e - 1].pay) : T(0);
  w = e > 0 ? span[e - 1].ghi : T(0);
  if (e < n) {
    const Span<T> sp = span[e];
    T part = x - (sp.ghi - sp.w);
    part = part > T(0) ? part : T(0);
    part = part < sp.w ? part : sp.w;
    s = fma_t(buf[e].key, part, s);
    w += part;
  }
}

// Steps 4-6 of the edges variant on a merged float32 row (buf; the free
// buffer other; the lane's slice [d_begin, d_end) of step 3): in one scan
// pass the prefix sums of the weights (step 4's, the same bits) and of key *
// weight (in place of each element's spent index pair); then lane
// j < NG takes S and W at edge j + 1, lane 0 also at edge 0, and one
// shuffle gives bin j = (S(x_j+1) - S(x_j)) / max(W(x_j+1) - W(x_j),
// floor): NG + 1 searches of equal cost in place of the walks of step 5.
template <typename Floor>
__device__ float edge_search_rebin(Elem<float>* buf, Elem<float>* other,
                                   int d_begin, int d_end, const float* w2s,
                                   const float* edge_s,
                                   float* __restrict__ out, size_t base,
                                   int ng) {
  using T = float;
  const int n = ng * ng;
  const int lane = threadIdx.x & (kWarp - 1);
  Span<T>* span = reinterpret_cast<Span<T>*>(other);
  T run_w = T(0), run_kw = T(0);
  for (int e = d_begin; e < d_end; ++e) {
    const Elem<T> el = buf[e];
    const T w = w2s[el.pay];
    run_w += w;
    run_kw = fma_t(el.key, w, run_kw);
    span[e] = {run_w, w};
    buf[e].pay = __float_as_uint(run_kw);
  }
  T incl_w = run_w, incl_kw = run_kw;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const T up_w = __shfl_up_sync(kFull, incl_w, o);
    const T up_kw = __shfl_up_sync(kFull, incl_kw, o);
    if (lane >= o) {
      incl_w += up_w;
      incl_kw += up_kw;
    }
  }
  T off_w = __shfl_up_sync(kFull, incl_w, 1);
  T off_kw = __shfl_up_sync(kFull, incl_kw, 1);
  if (lane == 0) off_w = off_kw = T(0);
  for (int e = d_begin; e < d_end; ++e) {
    span[e].ghi += off_w;
    buf[e].pay = __float_as_uint(__uint_as_float(buf[e].pay) + off_kw);
  }
  __syncwarp();

  // S and W at edge j + 1 in lane j < NG; at edge 0 in lane 0 too
  T s_hi = T(0), w_hi = T(0);
  if (lane < ng) {
    edge_sums(buf, span, n, edge_s[lane + 1], s_hi, w_hi);
  }
  T s_lo = __shfl_up_sync(kFull, s_hi, 1);
  T w_lo = __shfl_up_sync(kFull, w_hi, 1);
  if (lane == 0) edge_sums(buf, span, n, edge_s[0], s_lo, w_lo);
  if (lane >= ng) return T(0);
  T den = w_hi - w_lo;
  const T tiny = Floor::tiny();
  den = den > tiny ? den : tiny;
  out[base + lane] = (s_hi - s_lo) / den;
  return den;
}

// Steps 1-6 of one row, run by its whole warp; `smem` is the warp's
// row_warp_bytes<T, E>. Lane j < NG writes out[row, j] and returns the
// floored denominator of bin j (the floor Floor::tiny()). MATS: lane j also
// adds each overlap of its walk into column j of the NG x NG matrices mat
// (MA, by ia) and mat + NG*NG (MB, by ib), row-major. TAIL kWalk is the
// combine (steps 4-6 as above); the variants stop after step 3 (kMergeOnly:
// lane j < NG writes the j-th smallest key, E may be Key<T>) or take
// edge_search_rebin in place of steps 4-6 (kEdgeSearch).
template <typename T, bool MATS, typename Floor = Limits<T>, int TAIL = kWalk,
          typename E = Elem<T>>
__device__ T combine_row(const T* __restrict__ a, const T* __restrict__ b,
                         const T* w2s, const T* edge_s, unsigned char* smem,
                         T* __restrict__ out, int row, int ng, T* mat) {
  const int n = ng * ng;
  const int lane = threadIdx.x & (kWarp - 1);
  const int cap = round_up4(n);
  E* buf = reinterpret_cast<E*>(smem);
  E* other = buf + cap;
  T* sorted_a = reinterpret_cast<T*>(other + cap);
  T* sorted_b = sorted_a + kWarp;
  unsigned char* index_a = reinterpret_cast<unsigned char*>(sorted_b + kWarp);
  unsigned char* index_b = index_a + kWarp;

  const size_t base = static_cast<size_t>(row) * ng;
  const bool live = lane < ng;
  T sa = live ? a[base + lane] : T(0);
  T sb = live ? b[base + lane] : T(0);
  int ia = lane, ib = lane;  // original g-indices of sa, sb

  // 1. a and b in ascending order: rows already sorted along g, the norm,
  // keep theirs; others are ranked by counting, ties broken by index
  const T a_up = __shfl_up_sync(kFull, sa, 1);
  const T b_up = __shfl_up_sync(kFull, sb, 1);
  if (!__all_sync(kFull, lane == 0 || !live || (a_up <= sa && b_up <= sb))) {
    int rank_a = 0, rank_b = 0;
    for (int j = 0; j < ng; ++j) {
      const T aj = __shfl_sync(kFull, sa, j);
      const T bj = __shfl_sync(kFull, sb, j);
      rank_a += (aj < sa || (aj == sa && j < lane)) ? 1 : 0;
      rank_b += (bj < sb || (bj == sb && j < lane)) ? 1 : 0;
    }
    if (live) {
      sorted_a[rank_a] = sa;
      index_a[rank_a] = static_cast<unsigned char>(lane);
      sorted_b[rank_b] = sb;
      index_b[rank_b] = static_cast<unsigned char>(lane);
    }
    __syncwarp();
    if (live) {
      sa = sorted_a[lane];
      ia = index_a[lane];
      sb = sorted_b[lane];
      ib = index_b[lane];
    }
  }

  // 2. the NG sorted runs, run i = a_(i) + b_(j) over j, lane j holding
  // column j, merged in pairs (runs 2k, 2k+1) straight from registers:
  // x_j goes to j + #{y < x_j}, y_j to j + #{x <= y_j} (equal keys: the
  // left run first), the counts by binary search across the lanes
  const int top_step = 1 << (31 - __clz(ng));  // largest power of 2 <= NG
  for (int i = 0; i < ng; i += 2) {
    const T ax = __shfl_sync(kFull, sa, i);
    const int iax = __shfl_sync(kFull, ia, i);
    const T x = ax + sb;
    const int s = i * ng;
    if (i + 1 == ng) {  // the last run of an odd NG has no partner
      if (live) buf[s + lane] = {x, static_cast<uint32_t>((iax << 5) | ib)};
      break;
    }
    const T ay = __shfl_sync(kFull, sa, i + 1);
    const int iay = __shfl_sync(kFull, ia, i + 1);
    const T y = ay + sb;
    int cx = 0, cy = 0;
    for (int step = top_step; step > 0; step >>= 1) {
      const int tx = cx + step;
      const int ty = cy + step;
      const T yv = __shfl_sync(kFull, y, (tx - 1) & (kWarp - 1));
      const T xv = __shfl_sync(kFull, x, (ty - 1) & (kWarp - 1));
      if (tx <= ng && yv < x) cx = tx;
      if (ty <= ng && xv <= y) cy = ty;
    }
    if (live) {
      buf[s + lane + cx] = {x, static_cast<uint32_t>((iax << 5) | ib)};
      buf[s + lane + cy] = {y, static_cast<uint32_t>((iay << 5) | ib)};
    }
  }
  __syncwarp();

  // 3. merge-path tree over the runs of 2 NG: at each level, runs of `run`
  // elements merge in pairs; lane l writes output positions
  // [d_begin, d_end), slices of an odd length, so that the lanes' accesses
  // at one step of their slices fall in distinct banks
  const int slice = ((n + kWarp - 1) / kWarp) | 1;
  const int d_begin = min(lane * slice, n);
  const int d_end = min(d_begin + slice, n);
  for (int run = 2 * ng; run < n; run *= 2) {
    int d = d_begin;
    while (d < d_end) {
      const int s = d / (2 * run) * (2 * run);  // the pair's first element
      const int mid = min(s + run, n);          // its right run's first
      const int end = min(s + 2 * run, n);
      const int stop = min(d_end, end);
      // co-rank: how many of the pair's first d - s outputs come from the
      // left run (equal keys: the left run first)
      const int k = d - s;
      int lo = max(0, k - (end - mid));
      int hi = min(k, mid - s);
      while (lo < hi) {
        const int c = (lo + hi) >> 1;
        if (buf[s + c].key <= buf[mid + k - c - 1].key) {
          lo = c + 1;
        } else {
          hi = c;
        }
      }
      // a run that is used up reads as the type's largest key, which the
      // other run's keys never exceed before the slice ends
      int x = s + lo;
      int y = mid + k - lo;
      const E spent = {Limits<T>::max(), 0u};
      E ex = x < mid ? buf[x] : spent;
      E ey = y < end ? buf[y] : spent;
      for (; d < stop; ++d) {
        const bool take_x = ex.key <= ey.key;
        other[d] = take_x ? ex : ey;
        x += take_x;
        y += !take_x;
        const int next = take_x ? x : y;
        const E e_next = next < (take_x ? mid : end) ? buf[next] : spent;
        if (take_x) {
          ex = e_next;
        } else {
          ey = e_next;
        }
      }
    }
    __syncwarp();
    E* t = buf;
    buf = other;
    other = t;
  }

  if constexpr (TAIL == kMergeOnly) {
    // the first NG of the sorted keys
    if (live) out[base + lane] = buf[lane].key;
    return T(0);
  } else if constexpr (TAIL == kEdgeSearch) {
    return edge_search_rebin<Floor>(buf, other, d_begin, d_end, w2s, edge_s,
                                    out, base, ng);
  } else {
    // 4. inclusive prefix sum of the sorted weights, beside each weight, in
    // the free buffer: a serial scan of the lane's slice, then a warp scan
    // of the slices' totals
    Span<T>* span = reinterpret_cast<Span<T>*>(other);
    T run_w = T(0);
    for (int e = d_begin; e < d_end; ++e) {
      const T w = w2s[buf[e].pay];
      run_w += w;
      span[e] = {run_w, w};
    }
    T incl = run_w;
  #pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const T up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    T offset = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) offset = T(0);
    for (int e = d_begin; e < d_end; ++e) span[e].ghi += offset;
    __syncwarp();

    // 5. lane j rebins bin j: from the first element whose upper end lies
    // above the bin's lower edge (less the slack) to the first whose upper
    // end lies above its upper edge (plus the slack)
    if (!live) return T(0);
    const T lo_j = edge_s[lane];
    const T hi_j = edge_s[lane + 1];
    const T slack = T(kSlackEps) * Limits<T>::eps();
    int e = 0;
    {
      const T first = lo_j - slack;
      int top = n;
      while (e < top) {
        const int c = (e + top) >> 1;
        if (span[c].ghi > first) {
          top = c;
        } else {
          e = c + 1;
        }
      }
    }
    const T last = hi_j + slack;
    T num = T(0), den = T(0);
    for (; e < n; ++e) {
      const Span<T> sp = span[e];
      const Elem<T> el = buf[e];
      const T g_lo = sp.ghi - sp.w;
      T inter = (sp.ghi < hi_j ? sp.ghi : hi_j) - (g_lo > lo_j ? g_lo : lo_j);
      inter = inter > T(0) ? inter : T(0);
      num = fma_t(el.key, inter, num);
      den += inter;
      if constexpr (MATS) {
        mat[(el.pay >> 5) * ng + lane] += inter;
        mat[n + (el.pay & 31) * ng + lane] += inter;
      }
      if (sp.ghi >= last) break;
    }
    // 6. the overlap-weighted mean
    const T tiny = Floor::tiny();
    den = den > tiny ? den : tiny;
    out[base + lane] = num / den;
    return den;
  }
}

}  // namespace
