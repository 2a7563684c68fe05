// Random-overlap resort-rebin of two correlated-k distributions, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel combine_pair_pallas
// (archnemesis_tpu/ops/overlap_pallas.py:398, body _make_kernel :101). It
// computes the same function as the plain PyTorch version in
// archnemesis_tpu_torch/ops/overlap.py (_combine_pair), the reference's
// rankg (ForwardModel_0.py:5960):
//   for each row r: the NG*NG pair sums a[r,i] + b[r,j] with weights
//   del_g[i]*del_g[j], sorted by key with the weights; inclusive prefix
//   sum of the sorted weights; each output g-bin j gets the
//   overlap-weighted mean of the keys over [edge_j, edge_j+1).
//
// What bounds it on the card: operations, by a little. One row reads 2*NG
// and writes NG values (240 B in float32 at NG=20); the function needs
// 5,753 operations per row at NG=20 with inputs sorted along g (400 pair
// sums, 2,000 comparisons to merge the 20 sorted runs of 20 keys, 400
// prefix-sum adds, 7 for each of the at most 419 (element, bin) overlaps
// of the rebin, 20 divisions; nembench/harness/bounds.py:
// combine_ops_per_row). At 581,632 rows that is 0.050 ms at the float32
// peak against 0.042 ms for the bytes at the HBM rate.
//
// The row code of one warp per row (combine_row, in overlap_row.cuh; the
// fused kernel below runs it as its phase A, and the combine's A/B
// variants take it apart) does close to that work with the row's elements
// in shared memory:
//   1. lane j < NG loads a[r, j] and b[r, j] (coalesced). Rows sorted
//      along g, the norm (overlap_pallas.py:52-63), are found so by one
//      warp vote and kept; other rows are sorted by rank counting (NG
//      shuffles a lane, ties by index), so that every row has the plain
//      version's answer;
//   2. the NG*NG pair sums form NG runs, run i = a_(i) + b_(j) over j,
//      each sorted because rounding is monotone. Each element carries its
//      original index pair packed as (ia << 5) | ib beside its key, one
//      8-byte (float) or 16-byte (double) shared-memory word;
//   3. the first merge level, runs 2k and 2k+1, is done in registers: each
//      element's place in its pair is its index plus its rank in the other
//      run, by a binary search across the lanes (shuffles). A merge-path
//      tree merges the rest in ceil(log2 NG) - 1 levels between two
//      shared-memory buffers: at each level lane l writes an output slice
//      of S = ceil(n/32) rounded up to odd elements (odd, so that the
//      lanes' stores at one step fall in distinct banks), finds where it
//      starts in the two runs by a binary search (the co-rank) and merges
//      in sequence. Equal keys take the left run first, so the order, and
//      the result, is deterministic: ascending key, then run, then
//      position in the run;
//   4. the weights w2[ia*NG + ib], looked up by original index in a
//      per-block copy of the table, are prefix-summed: a serial scan of
//      each lane's slice, then a warp scan of the slices' totals; each
//      element's prefix sum and weight go to the free buffer;
//   5. lane j rebins output bin j alone: a binary search finds the first
//      element that can overlap the bin, and the lane walks the sorted
//      elements until their upper ends pass the bin's upper edge, summing
//      key * overlap and overlap in element order. No bin is shared
//      between lanes, so there are no atomics and no cross-lane sums: two
//      launches on the same input give the same bits;
//   6. the denominator is floored at FLT_MIN / DBL_MIN.
// The search and the stop of step 5 carry a slack of 128 eps on the
// g-axis: the scan's prefix sums are monotone only to within a few eps,
// and the slack makes the walk cover every element whose overlap is
// positive (extra elements contribute exactly 0).
// What it costs beyond the bound: shared-memory bandwidth and latency.
// Every merge level moves each element through shared memory (a load and
// a store of its 8- or 16-byte word) and the co-rank searches add
// dependent random loads; the rebin's lanes walk bins of unequal length
// with NG of 32 lanes busy (PERF.md has the times).
//
// The primal kernel (combine_primal_kernel) gives the same bits with one
// thread per row and no buffer of the row's NG*NG elements. A block of W
// warps takes 32 W consecutive rows, and every per-thread array in shared
// memory is laid out [slot][thread], so that the threads' accesses to any
// slots fall in distinct banks:
//   1. the block's rows of a, then of b, are copied in with coalesced
//      loads into one row per thread at the odd stride NG | 1 (the
//      threads' reads of one column fall in distinct banks) and taken into
//      the thread's slots. A row sorted along g is found so in NG - 1
//      compares; another is sorted by a stable insertion sort (ties by
//      index: the rank count's order);
//   2. the NG runs a_(i) + b_(j) (over j) are merged as a stream by a
//      loser tree over the runs' heads: node 0, a head that loses every
//      match, and NG - 1 nodes of a key and a packed (run, position,
//      ia * NG, ia * NG + ib). Heads compare by key, then run, so the
//      elements leave in step 3's order exactly. The first heads rise with
//      the run, so the tree starts without a match played. A pop forms the
//      run's next head from a_(r) and b_(j+1), loads the run's path (5
//      nodes, node 0 past the root) at once and plays it up the path, each
//      level a compare, a predicated store and a select. A warp whose rows
//      are all sorted along g (the rows of the main path) runs a copy of
//      the stream that takes the original indices as the sorted ones;
//   3. each popped element's weight is summed with combine_row's
//      association: serially within slices of its S elements, plus the
//      offset of the slice, which the thread computes as the warp scan's
//      add tree does (shuffles up by 1, 2, 4, 8, 16 over the slices'
//      totals), from a ring of each level's last sums. The slice index is
//      the same in every thread, so a switch over it makes the ring's
//      slots constants, and the ring stays in registers. So every prefix
//      sum, and every overlap, is combine_row's to the bit;
//   4. the element's overlaps go into the bins it touches, in element
//      order, with step 5's formula: bins jb (the lowest open one) and
//      jb + 1 in registers; a bin further on (an element wider than a
//      bin, or bins narrower than the slack) into a spill in local
//      memory. Bin jb is written (key-weighted mean, the floored
//      denominator) after the first element whose upper end reaches its
//      upper edge plus the slack, where combine_row's walk of it stops.
//      Only elements of zero overlap differ between the two, and they add
//      exactly 0: no atomics, the same bits launch after launch;
//   5. the outputs go out as the inputs came in, staged at the odd stride
//      and written coalesced.
// What it does about the bound: the merge costs ceil(log2 NG) compares a
// pop, as the operation count has it, and the warp's 32 rows share every
// instruction. What it costs beyond: instruction issue, about 100
// instructions a pop on the main path at NG = 20 (the path's addresses,
// loads, compares, stores and selects, the next head, the prefix sum and
// two bins' overlaps), and the closing of bins, a branch that some lane
// of the warp takes at most pops, with an IEEE division. Shared memory,
// 420 bytes a thread at NG = 20 in float32, leaves 16 warps resident an
// SM, enough to cover the chain of a pop's matches. The launch takes the
// warps per block that keep the most rows resident (PERF.md has the
// times).
// The fused kernel keeps the warp per row: its tangents need each
// element's overlaps summed into per-row matrices MA and MB (below),
// which one thread per row cannot hold.
//
// The fused kernel (combine_tan_kernel) replaces the TPU kernel's tangent
// co-sort (_combine_pallas with tangents, overlap_pallas.py:270-329, body
// _make_kernel :101-249): the same combine and, in the same launch, T
// tangent pairs da, db (T, R, NG) pushed through the primal's permutation
// and rebinned with its overlaps and denominators,
//   dout[t, r, j] = sum_e inter[e, j] * (da[t, r, ia(e)] + db[t, r, ib(e)])
//                   / den_j
//                 = (sum_i MA[i][j] da[t, r, i] + MB[i][j] db[t, r, i])
//                   / den_j,
// with the row's overlap matrices MA[i][j] = sum_{e: ia(e) = i} inter[e, j]
// and MB[i][j] likewise over ib. A block holds W consecutive rows, one warp
// each, and works in two phases:
//   A. each warp runs combine_row's steps 1-6 above on its row (out is the
//      primal kernel's result bit for bit).
//      In step 5 lane j, which alone walks bin j, also adds each element's
//      overlap into column j of its row's MA and MB in shared memory
//      (zeroed first), at the rows given by the element's packed (ia, ib).
//      No other lane writes column j, so the adds are plain and in element
//      order, and two launches give the same bits for dout too; slack
//      elements add exactly 0. Lane j keeps 1 / den_j beside the matrices.
//   B. unit u of the block's U = W * H units (H = ceil(NG / 2)) takes bins
//      q and q + H of row u / H (q = u % H): one thread loads the unit's
//      two columns of MA and MB (4*NG values, instantiated for NG up to 8,
//      16, 20 and 32; one column in float64 above NG = 20) and 1 / den of
//      both bins into registers once. The tangents stream through shared
//      memory in tiles of TT tangents, double-buffered: tangent t's part of
//      the block, da[t, r0:r0+W, :], is W*NG contiguous values, copied with
//      16-byte cp.async; a slab that does not start or end on 16 bytes has
//      its head and tail copied by element-sized cp.async, into a slot
//      offset so that the source's 16-byte words land on 16-byte words.
//      Thread p works for unit p % U on tangents g, g + G, .. of each tile
//      (group g = p / U of G = 32 W / U), so that all warps are busy: it
//      reads its row of the staged da and db with broadcast loads of VEC
//      values (16 bytes where NG and the pointers allow it), each value
//      serving both bins, sums the 4*NG products in four chains, scales by
//      1 / den_j and stores. The staging reuses the primal's element
//      buffers, so a block issues its first tile after phase A.
// Why the matrices sit in registers, two bins a thread, counted in
// shared-memory wavefronts (128 bytes delivered to a warp's lanes, one a
// clock per SM) at NG = 20 against the HBM bound per output: an output
// moves 3 values through HBM, 12 bytes in float32 (24 in float64), which
// take 0.94 (1.88) SM clocks at 3.35 TB/s over 132 SMs at 1.98 GHz. A
// thread needs the 2*NG staged values of its row for every tangent; a
// 16-byte load delivers 16 bytes to each lane, broadcast or not, so that
// is 160 (320) bytes a tangent, 80 (160) per output with two bins a
// thread: 0.63 (1.25) wavefronts; the staging's writes add 8 (16) bytes
// per output, 0.06 (0.13). Reading the matrix column from shared memory
// for every output instead would add 2*NG values per output, 1.25 (2.5)
// wavefronts, above the HBM bound on its own, and phase A's merge, which
// shares the pipe, is bound by it already. One bin a thread (1.25 (2.5)
// wavefronts) was slower on the card in both types, and so were four bins
// a pair of threads, each holding half the matrix rows and trading partial
// sums by shuffles (half the loads, more instructions and registers).
// No tensor cores: the product does 2*NG multiply-adds per 3 values of HBM
// traffic, far below the ~300 operations per byte at which tensor cores
// would set the time; TF32 keeps 10 mantissa bits, which would break the
// float32 tangent bound (2e-5 of the peak, chip_smoke.py:tangent_f32_tol),
// and in float64 DMMA would speed up the product, which shares the time
// with the merge and the stream (PERF.md has the breakdown).
// What bounds it: bytes. At T = 81, R = 39,689, NG = 20 the three
// (T, R, NG) arrays are 0.77 GB in float32, 0.23 ms at the HBM rate,
// against 0.06 ms for the 1,258 operations per row and tangent at the
// float32 peak (nembench/harness/tangent_bounds.py:fused_combine_bound_ms).
// What it costs beyond: phase A, the primal kernel's shared-memory-bound
// merge at the few rows per SM that the matrices and registers leave
// resident (a launch with no
// tangents takes about half the time of one with 81; chip_smoke.py phase 5
// times both beside the primal kernel), and phase B's product, bound by
// instruction issue and the shared-memory pipe, which phase A also needs
// (PERF.md has the times).

#include <cmath>
#include <type_traits>

#include "overlap_row.cuh"

namespace {

// ---------------------------------------------------------------------------
// The primal kernel: one row per thread.

// A run head of the loser tree: its key and pay = (run << 26) | (position
// << 20) | (ia * NG << 10) | (ia * NG + ib), the last the pair's index in
// the weight table. Heads compare by key, then by pay, whose top bits are
// the run's, so that of two heads of one key the lower run goes first.
template <typename T>
struct __align__(2 * sizeof(T)) Head {
  T key;
  uint32_t pay;
};
static_assert(sizeof(Head<float>) == 8 && sizeof(Head<double>) == 16, "");

// x before y; bitwise, so that the compare compiles to predicates
template <typename T>
__device__ __forceinline__ bool before(const Head<T>& x, const Head<T>& y) {
  return (x.key < y.key) | ((x.key == y.key) & (x.pay < y.pay));
}

// a head that loses every match
template <typename T>
__device__ __forceinline__ Head<T> never() {
  return {static_cast<T>(INFINITY), ~0u};
}
constexpr uint32_t kSpent = 63u << 26;  // a used-up run, after every live one

// The overlap of the element [g_lo, ghi] with the bin [lo, hi], as
// combine_row takes it: min(ghi, hi) - max(g_lo, lo). The operands are never
// -0 or NaN (non-negative weights and edges, edge 0 = +0), where fmin and
// fmax would differ from combine_row's compares.
__device__ __forceinline__ float overlap(float g_lo, float ghi, float lo,
                                         float hi) {
  return fminf(ghi, hi) - fmaxf(g_lo, lo);
}
__device__ __forceinline__ double overlap(double g_lo, double ghi, double lo,
                                          double hi) {
  return fmin(ghi, hi) - fmax(g_lo, lo);
}

// The lowest run among the leaves below node c of a loser tree with NG
// leaves (internal nodes 1 .. NG - 1, leaf NG + r for run r): the first
// index at or past NG on the first level below c that reaches NG.
__device__ __forceinline__ int first_leaf(int c, int ng) {
  int lo = c, hi = c;
  while (hi < ng) {
    lo = 2 * lo;
    hi = 2 * hi + 1;
  }
  return max(lo, ng) - ng;
}

// Shared memory of the primal kernel, per block: the pair weights by
// ia * NG + ib and the bin edges; per thread, each array laid out
// [slot][thread] so that the threads' accesses to any slots fall in
// distinct banks: area A (the staged rows of a or b, one row per thread
// at the odd stride NG | 1; then the loser tree's NG nodes; at the end the
// outputs, staged as the inputs were), the sorted a and b, the bins'
// outputs as they close (first the sorted a's original indices), and the
// sorted b's original indices.
template <typename T>
__host__ __device__ size_t stream_area_bytes(int ng) {
  const size_t stage = static_cast<size_t>(ng | 1) * sizeof(T);
  const size_t tree = static_cast<size_t>(ng) * sizeof(Head<T>);
  return stage > tree ? stage : tree;
}
template <typename T>
__host__ __device__ size_t stream_thread_bytes(int ng) {
  return stream_area_bytes<T>(ng) + 3 * ng * sizeof(T) + ng;
}
template <typename T>
__host__ __device__ size_t stream_block_bytes(int ng) {
  return (static_cast<size_t>(ng * ng + ng + 1) * sizeof(T) + 15) / 16 * 16;
}

// Thread t of a block of tb threads copies src[0, count) (count = rows *
// NG) into rows of `stride` elements (dst[row * stride + k] = src[row * NG
// + k]), or back (to_rows false), the threads on consecutive elements.
template <typename T>
__device__ void copy_rows(T* dst, const T* src, int count, int ng,
                         int stride, bool to_rows) {
  const int t = threadIdx.x;
  const int tb = blockDim.x;
  const int dr = tb / ng;
  const int dk = tb - dr * ng;
  int row = t / ng;
  int k = t - row * ng;
  for (int x = t; x < count; x += tb) {
    if (to_rows) {
      dst[row * stride + k] = src[x];
    } else {
      dst[x] = src[row * stride + k];
    }
    row += dr;
    k += dk;
    if (k >= ng) {
      k -= ng;
      ++row;
    }
  }
}

// Stable insertion sort of thread t's values x[k * tb + t], k < NG, with
// their original indices in idx (ties keep their order: the rank count's
// order, ties by index).
template <typename T>
__device__ void sort_slots(T* x, unsigned char* idx, int ng, int tb, int t) {
  idx[t] = 0;
  for (int k = 1; k < ng; ++k) {
    const T v = x[k * tb + t];
    int i = k;
    while (i > 0 && x[(i - 1) * tb + t] > v) {
      x[i * tb + t] = x[(i - 1) * tb + t];
      idx[i * tb + t] = idx[(i - 1) * tb + t];
      --i;
    }
    x[i * tb + t] = v;
    idx[i * tb + t] = static_cast<unsigned char>(k);
  }
}

// Thread t's row of the staged rows into x[k * tb + t]; returns whether it
// is sorted along g.
template <typename T>
__device__ bool take_row(T* x, const T* stage, int ng, int stride, int tb,
                         int t) {
  bool sorted = true;
  T prev = stage[t * stride];
  x[t] = prev;
  for (int k = 1; k < ng; ++k) {
    const T v = stage[t * stride + k];
    sorted = sorted && prev <= v;
    x[k * tb + t] = v;
    prev = v;
  }
  return sorted;
}

// The warp scan's inclusive sum at slice M (combine_row's shuffles up by
// 1, 2, 4, 8, 16 over the slices' totals), given slice M's total: level k
// keeps its last 2^k sums, ring[2^k - 1 + x % 2^k] = v_k[x], and
// v_{k+1}[M] = v_k[M] + v_k[M - 2^k] where M >= 2^k, the shuffle's lane
// condition. M is a constant, so the ring's slots are, and it stays in
// registers.
template <int M, typename T>
__device__ __forceinline__ T scan_offset(T (&ring)[31], T total) {
  T v = total;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int slot = (1 << k) - 1 + (M & ((1 << k) - 1));
    const T old = ring[slot];
    ring[slot] = v;
    if (M >= (1 << k)) v = v + old;
  }
  return v;
}

// scan_offset at slice x (the same for every thread of the launch)
template <typename T>
__device__ __forceinline__ T scan_offset_at(T (&ring)[31], T total, int x) {
  switch (x) {
#define SCAN_CASE(M) \
  case M:            \
    return scan_offset<M>(ring, total);
#define SCAN_CASES8(M) \
  SCAN_CASE(M) SCAN_CASE(M + 1) SCAN_CASE(M + 2) SCAN_CASE(M + 3) \
  SCAN_CASE(M + 4) SCAN_CASE(M + 5) SCAN_CASE(M + 6) SCAN_CASE(M + 7)
    SCAN_CASES8(0)
    SCAN_CASES8(8)
    SCAN_CASES8(16)
    SCAN_CASES8(24)
#undef SCAN_CASES8
#undef SCAN_CASE
    default:
      return total;  // past the last slice: not read
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
combine_primal_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ w2, const T* __restrict__ edges,
                      T* __restrict__ out, int rows, int ng) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x;
  const int tb = blockDim.x;
  const int stride = ng | 1;
  T* w2s = reinterpret_cast<T*>(smem_raw);
  T* edge_s = w2s + ng * ng;
  unsigned char* area = smem_raw + stream_block_bytes<T>(ng);
  T* stage = reinterpret_cast<T*>(area);
  using H = Head<T>;
  H* tree = reinterpret_cast<H*>(area);
  T* sa = reinterpret_cast<T*>(area + tb * stream_area_bytes<T>(ng));
  T* sb = sa + ng * tb;
  T* out_s = sb + ng * tb;
  unsigned char* xa = reinterpret_cast<unsigned char*>(out_s);
  unsigned char* xb = reinterpret_cast<unsigned char*>(out_s + ng * tb);

  for (int x = t; x < ng * ng; x += tb) w2s[x] = w2[x];
  for (int x = t; x <= ng; x += tb) edge_s[x] = edges[x];
  const int r0 = blockIdx.x * tb;
  const int count = min(tb, rows - r0) * ng;
  const size_t base = static_cast<size_t>(r0) * ng;
  const bool live = r0 + t < rows;

  // 1. the rows of a, then of b, staged and taken into the thread's slots;
  // a row not sorted along g is sorted
  copy_rows(stage, a + base, count, ng, stride, true);
  __syncthreads();
  bool sorted_a = true, sorted_b = true;
  if (live) sorted_a = take_row(sa, stage, ng, stride, tb, t);
  __syncthreads();
  copy_rows(stage, b + base, count, ng, stride, true);
  __syncthreads();
  if (live) {
    sorted_b = take_row(sb, stage, ng, stride, tb, t);
    if (!sorted_a) sort_slots(sa, xa, ng, tb, t);
    if (!sorted_b) sort_slots(sb, xb, ng, tb, t);
  }
  __syncthreads();  // area A is free for the tree

  // run r's element j as a head: key a_(r) + b_(j), as combine_row sums it
  auto head = [&](int r, int j, uint32_t ia_ng) -> H {
    const uint32_t ib = sorted_b ? j : xb[j * tb + t];
    return {sa[r * tb + t] + sb[j * tb + t],
            (static_cast<uint32_t>(r) << 26) |
                (static_cast<uint32_t>(j) << 20) | (ia_ng << 10) |
                (ia_ng + ib)};
  };
  auto ia_ng = [&](int r) -> uint32_t {
    return (sorted_a ? r : xa[r * tb + t]) * ng;
  };
  // 2. the loser tree over the NG runs' first heads, thread t's node p at
  // tree[p * tb + t]. Their keys rise with the run (rounding is monotone),
  // so every match is won by the lower run: node p holds the higher of its
  // two subtrees' lowest runs. Node 0, above the root, holds a head that
  // loses every match, so that every path has 5 levels
  H win;
  if (live) {
    tree[t] = never<T>();
    for (int p = 1; p < ng; ++p) {
      const int r = max(first_leaf(2 * p, ng), first_leaf(2 * p + 1, ng));
      tree[p * tb + t] = head(r, 0, ia_ng(r));
    }
    win = head(0, 0, ia_ng(0));
  }
  __syncthreads();  // the original indices of a (xa) are read no more
  const bool warp_sorted = __all_sync(kFull, !live || (sorted_a && sorted_b));

  if (live) {
    const int n = ng * ng;
    // 2-4. the stream: pop the least head, replay its run's next one up
    // the tree, prefix-sum the element's weight, add its overlaps
    const int slice = ((n + kWarp - 1) / kWarp) | 1;
    T ring[31];
#pragma unroll
    for (int i = 0; i < 31; ++i) ring[i] = T(0);
    const T slack = T(kSlackEps) * Limits<T>::eps();
    const T tiny = Limits<T>::tiny();
    int jb = 0;  // the lowest open bin; bins jb, jb + 1 in registers
    T e0 = edge_s[0], e1 = edge_s[1], e2 = ng > 1 ? edge_s[2] : e1;
    T last = e1 + slack;
    T n0 = T(0), d0 = T(0), n1 = T(0), d1 = T(0);
    // bins past jb + 1 that an element reached (bins narrower than an
    // element or than the slack): their sums, and a bit each once started
    T spill_n[kWarp], spill_d[kWarp];
    uint32_t spilled = 0;
    // bin jb's mean out; bin jb + 1 moves down and jb + 2 comes in, from
    // the spill if an element reached it
    auto close_bin = [&]() {
      out_s[jb * tb + t] = n0 / (d0 > tiny ? d0 : tiny);
      ++jb;
      n0 = n1;
      d0 = d1;
      n1 = T(0);
      d1 = T(0);
      if (spilled != 0u) {
        if (jb + 1 < ng && ((spilled >> (jb + 1)) & 1u)) {
          n1 = spill_n[jb + 1];
          d1 = spill_d[jb + 1];
        }
      }
    };
    T off = T(0), local = T(0);
    int pos = 0, n_slice = 0;
    unsigned char* tree_bytes = reinterpret_cast<unsigned char*>(tree + t);
    const int node_stride = tb * static_cast<int>(sizeof(H));
    // the stream; kSorted: every row of the warp sorted along g, so the
    // original indices are the sorted ones and a run's next head's pair
    // index is its last one's plus one
    auto stream = [&](auto presorted) {
      constexpr bool kSorted = decltype(presorted)::value;
      for (int e = 0; e < n; ++e) {
        const T key = win.key;
        const uint32_t pay = win.pay;
        const T w = w2s[pay & 1023u];
        const int r = static_cast<int>(pay >> 26);
        const int j1 = static_cast<int>((pay >> 20) & 63u) + 1;
        // the run's next head (a used-up run's reads slot NG - 1 and is
        // replaced by the spent head)
        const bool more = j1 < ng;
        const int jn = more ? j1 : ng - 1;
        uint32_t next = pay + ((1u << 20) | 1u);
        if constexpr (!kSorted) {
          const uint32_t ib = sorted_b ? jn : xb[jn * tb + t];
          next = ((pay & ~1023u) + (1u << 20)) | (((pay >> 10) & 1023u) + ib);
        }
        H cand = {more ? sa[r * tb + t] + sb[jn * tb + t]
                       : static_cast<T>(INFINITY),
                  more ? next : kSpent};
        // the run's path to the root: the nodes' loads first (a level past
        // the root reads node 0), then the matches, each a predicated store
        // and a select
        const int q = ng + r;
        H* node[5];
        H path[5];
#pragma unroll
        for (int l = 0; l < 5; ++l) {
          node[l] = reinterpret_cast<H*>(tree_bytes +
                                         (q >> (l + 1)) * node_stride);
          path[l] = *node[l];
        }
#pragma unroll
        for (int l = 0; l < 5; ++l) {
          const bool swap = before(path[l], cand);
          if (swap) *node[l] = cand;
          cand = swap ? path[l] : cand;
        }
        win = cand;

        // the prefix sum as combine_row's scan takes it: serial within
        // slices, each slice offset by the warp scan of the totals before
        // it
        local = (pos == 0 ? T(0) : local) + w;
        const T ghi = local + off;
        const T g_lo = ghi - w;
        // once every bin is out, e0 = e1 = e2 is the top edge and last is
        // infinite: no overlap, no close
        T inter = overlap(g_lo, ghi, e0, e1);
        if (inter > T(0)) {
          n0 = fma_t(key, inter, n0);
          d0 += inter;
        }
        inter = overlap(g_lo, ghi, e1, e2);
        if (inter > T(0)) {
          n1 = fma_t(key, inter, n1);
          d1 += inter;
        }
        if (ghi > e2) {
          for (int k = jb + 2; k < ng && edge_s[k] < ghi; ++k) {
            inter = overlap(g_lo, ghi, edge_s[k], edge_s[k + 1]);
            if (inter > T(0)) {
              const bool had = (spilled >> k) & 1u;
              spill_n[k] = fma_t(key, inter, had ? spill_n[k] : T(0));
              spill_d[k] = (had ? spill_d[k] : T(0)) + inter;
              spilled |= 1u << k;
            }
          }
        }
        // combine_row's walk of bin jb stops after the first element whose
        // upper end reaches its upper edge plus the slack
        while (ghi >= last && jb < ng) {
          close_bin();
          e0 = e1;
          e1 = e2;
          e2 = jb + 2 <= ng ? edge_s[jb + 2] : e1;
          last = jb < ng ? e1 + slack : static_cast<T>(INFINITY);
        }
        if (++pos == slice) {
          off = scan_offset_at(ring, local, n_slice);
          ++n_slice;
          pos = 0;
        }
      }
    };
    if (warp_sorted) {
      stream(std::true_type{});
    } else {
      stream(std::false_type{});
    }
    while (jb < ng) close_bin();
  }
  __syncthreads();  // area A is free for the outputs

  // 5. the outputs, staged as the inputs were, written out coalesced
  if (live) {
    for (int k = 0; k < ng; ++k) stage[t * stride + k] = out_s[k * tb + t];
  }
  __syncthreads();
  copy_rows(out + base, stage, count, ng, stride, false);
}

// Blocks of the count of 16, 8, 4, 2, 1 warps of 32 rows that keeps the
// most rows resident on an SM (resident_warps).
template <typename T>
int launch_primal(const void* a, const void* b, const void* w2,
                  const void* edges, void* out, int rows, int ng, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (ng < 1 || ng > kWarp) return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_warp = kWarp * stream_thread_bytes<T>(ng);
  int sm_smem = 0;
  err = cudaDeviceGetAttribute(
      &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = resident_warps(stream_block_bytes<T>(ng), per_warp,
                                   sm_smem, kMaxWarps);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stream_block_bytes<T>(ng) + warps * per_warp;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(combine_primal_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = warps * kWarp;
  const dim3 grid((rows + threads - 1) / threads);
  combine_primal_kernel<T><<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(w2), static_cast<const T*>(edges),
      static_cast<T*>(out), rows, ng);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fused primal + tangent kernel: one warp per row in phase A, two bins
// of a row per thread in phase B.

constexpr int kMaxTanWarps = 8;  // rows per block, at most

// Per row: MA and MB (NG x NG each) and 1 / den (NG), rounded up to 16
// bytes.
__host__ __device__ constexpr int mat_row_elems(int ng) {
  return round_up4(2 * ng * ng + ng);
}
// Elements of one staged slab slot: W*NG values and up to 16 bytes of
// offset that puts the source's 16-byte words on the slot's.
template <typename T>
__host__ __device__ int tan_slot_elems(int warps, int ng) {
  constexpr int v = 16 / sizeof(T);
  return (warps * ng + 2 * v - 2) / v * v;
}
template <typename T>
__host__ __device__ size_t tan_block_bytes(int warps, int ng) {
  return primal_block_bytes<T>() +
         warps * (primal_warp_bytes<T>(ng * ng) +
                  mat_row_elems(ng) * sizeof(T));
}

// Offset in elements of p from the 16-byte word that holds it.
template <typename T>
__device__ __forceinline__ int word_offset(const T* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) / sizeof(T)) &
         (16 / static_cast<int>(sizeof(T)) - 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void async_copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
template <int BYTES>
__device__ __forceinline__ void async_copy_elem(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp copies src[0, len) into the slot at dst + word_offset(src): the
// elements before src's first 16-byte boundary and after its last one
// element by element, the rest in 16-byte words.
template <typename T>
__device__ void stage_slab(T* dst, const T* src, int len, int lane) {
  constexpr int v = 16 / sizeof(T);
  const int off = word_offset(src);
  dst += off;
  const int head = min(len, (v - off) & (v - 1));
  const int words = (len - head) / v;
  for (int k = lane; k < words; k += kWarp) {
    async_copy16(dst + head + k * v, src + head + k * v);
  }
  const int rest = len - words * v;  // head and tail elements
  for (int q = lane; q < rest; q += kWarp) {
    const int x = q < head ? q : q + words * v;
    async_copy_elem<sizeof(T)>(dst + x, src + x);
  }
}

// Outputs (bins of one row) a thread of phase B computes: two, so that each
// staged value it loads serves two bins, unless their 4 * NGC matrix
// values would pass 160 registers (float64 above NG = 20).
template <typename T>
__host__ __device__ constexpr int outputs_per_thread(int ngc) {
  return 2 * ngc * static_cast<int>(sizeof(T)) <= 320 ? 2 : 1;
}

template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Pack {
  T v[VEC];
};

// NGC: a ceiling of NG (the register columns); VEC: values per shared
// load of a staged row (NG % VEC == 0, da and db aligned to VEC values).
// `tile` tangents per staged tile, two tiles in the primal's buffers.
template <typename T, int NGC, int VEC>
__global__ void __launch_bounds__(kMaxTanWarps * kWarp)
combine_tan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ da, const T* __restrict__ db,
                   const T* __restrict__ w2, const T* __restrict__ edges,
                   T* __restrict__ out, T* __restrict__ dout, int rows,
                   int ng, int n_tan, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ng * ng;
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  T* w2s = reinterpret_cast<T*>(smem_raw);
  T* edge_s = w2s + kPairSlots;
  unsigned char* row_smem = smem_raw + primal_block_bytes<T>();
  const size_t warp_bytes = primal_warp_bytes<T>(n);
  const int mat_elems = mat_row_elems(ng);
  T* mats = reinterpret_cast<T*>(row_smem + warps * warp_bytes);
  for (int x = threadIdx.x; x < warps * mat_elems; x += blockDim.x) {
    mats[x] = T(0);
  }
  load_tables(w2s, edge_s, w2, edges, ng);

  // A. the primal, its matrices and 1 / den. Warps of rows past `rows`
  // skip it and meet the others at the barriers below.
  const int r0 = blockIdx.x * warps;
  if (r0 + warp < rows) {
    T* mat = mats + warp * mat_elems;
    const T den = combine_row<T, true>(a, b, w2s, edge_s,
                                       row_smem + warp * warp_bytes, out,
                                       r0 + warp, ng, mat);
    if (lane < ng) mat[2 * n + lane] = T(1) / den;
  }
  __syncthreads();

  // B. the tangents. Unit u = p % U of the U = W * H units (H = ceil(NG /
  // K)) takes bins q, q + H, .. (K of them) of row u / H, q = u % H; group
  // p / U of the G = 32 W / U groups takes tangents g, g + G, .. of each
  // tile. The K bins of a unit share each staged value it loads.
  constexpr int K = outputs_per_thread<T>(NGC);
  const int h = (ng + K - 1) / K;
  const int units = warps * h;
  const int groups = blockDim.x / units;  // >= 1: W * H <= 32 W
  const int p = threadIdx.x;
  const int g = p / units;
  const int rr = (p - g * units) / h;
  const int q = p - g * units - rr * h;
  const bool active = g < groups && r0 + rr < rows;
  const int len = min(warps, rows - r0) * ng;  // the block's slab
  const int slot = tan_slot_elems<T>(warps, ng);
  T* stage = reinterpret_cast<T*>(row_smem);
  const size_t t_stride = static_cast<size_t>(rows) * ng;
  const size_t block_off = static_cast<size_t>(r0) * ng;
  const int n_tiles = (n_tan + tile - 1) / tile;

  // warp w stages slabs w, w + W, ... of the tile: slab 2k is da of its
  // k-th tangent, 2k + 1 db
  auto issue = [&](int k) {
    const int t0 = k * tile;
    const int count = min(tile, n_tan - t0);
    T* buf = stage + static_cast<size_t>(k & 1) * 2 * tile * slot;
    for (int s = warp; s < 2 * count; s += warps) {
      const T* src = ((s & 1) ? db : da) +
                     static_cast<size_t>(t0 + (s >> 1)) * t_stride + block_off;
      stage_slab(buf + static_cast<size_t>(s) * slot, src, len, lane);
    }
  };
  if (n_tiles > 0) issue(0);
  async_commit();

  // the unit's columns of MA and MB and its 1 / den (zero past NG)
  T ma[K][NGC], mb[K][NGC], inv_den[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = q + k * h;
    const bool live = active && j < ng;
    const T* col = mats + rr * mat_elems + (live ? j : 0);
#pragma unroll
    for (int i = 0; i < NGC; ++i) {
      ma[k][i] = live && i < ng ? col[i * ng] : T(0);
      mb[k][i] = live && i < ng ? col[n + i * ng] : T(0);
    }
    inv_den[k] = live ? col[2 * n] : T(0);
  }

  for (int k = 0; k < n_tiles; ++k) {
    if (k + 1 < n_tiles) issue(k + 1);
    async_commit();
    async_wait<1>();  // tile k is in
    __syncthreads();
    if (active) {
      const int t0 = k * tile;
      const int count = min(tile, n_tan - t0);
      const T* buf = stage + static_cast<size_t>(k & 1) * 2 * tile * slot;
      for (int tt = g; tt < count; tt += groups) {
        const size_t off =
            static_cast<size_t>(t0 + tt) * t_stride + block_off;
        const T* xa = buf + static_cast<size_t>(2 * tt) * slot +
                      word_offset(da + off) + rr * ng;
        const T* xb = buf + static_cast<size_t>(2 * tt + 1) * slot +
                      word_offset(db + off) + rr * ng;
        T acc_a[K], acc_b[K];
#pragma unroll
        for (int o = 0; o < K; ++o) {
          acc_a[o] = T(0);
          acc_b[o] = T(0);
        }
#pragma unroll
        for (int c = 0; c < NGC / VEC; ++c) {
          if (c * VEC < ng) {
            const Pack<T, VEC> va =
                *reinterpret_cast<const Pack<T, VEC>*>(xa + c * VEC);
            const Pack<T, VEC> vb =
                *reinterpret_cast<const Pack<T, VEC>*>(xb + c * VEC);
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
#pragma unroll
              for (int o = 0; o < K; ++o) {
                acc_a[o] = fma_t(ma[o][c * VEC + v], va.v[v], acc_a[o]);
                acc_b[o] = fma_t(mb[o][c * VEC + v], vb.v[v], acc_b[o]);
              }
            }
          }
        }
        T* row_out = dout + off + rr * ng + q;
#pragma unroll
        for (int o = 0; o < K; ++o) {
          if (q + o * h < ng) {
            row_out[o * h] = (acc_a[o] + acc_b[o]) * inv_den[o];
          }
        }
      }
    }
    __syncthreads();  // tile k's buffer is free for tile k + 2
  }
}

template <typename T, int NGC, int VEC>
int launch_tan_instance(const T* a, const T* b, const T* da, const T* db,
                        const T* w2, const T* edges, T* out, T* dout,
                        int rows, int ng, int n_tan, int device,
                        cudaStream_t stream) {
  const auto kernel = combine_tan_kernel<T, NGC, VEC>;
  // the attribute is set once per device, so that a launch captured in a
  // CUDA graph makes no call but the launch itself
  static uint64_t configured = 0;
  const uint64_t bit = device < 64 ? uint64_t(1) << device : 0;
  cudaError_t err;
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  // the count of 8, 4, 2, 1 rows per block that keeps the most rows
  // resident on an SM, the larger block on a tie (longer slabs, fewer idle
  // lanes in phase B)
  int warps = 0, best = 0;
  for (int w = kMaxTanWarps; w >= 1; w /= 2) {
    const size_t smem = tan_block_bytes<T>(w, ng);
    if (smem > kMaxSmem) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, w * kWarp, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks * w > best) {
      best = blocks * w;
      warps = w;
    }
  }
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tan_block_bytes<T>(warps, ng);
  // two tiles of 2 * tile slots in the primal's element buffers
  const size_t slot_bytes = tan_slot_elems<T>(warps, ng) * sizeof(T);
  const size_t room = warps * primal_warp_bytes<T>(ng * ng);
  const int max_tile = static_cast<int>(room / (4 * slot_bytes));
  if (smem > kMaxSmem || max_tile < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // tiles of equal size, as far as n_tan allows
  const int n_tiles = (n_tan + max_tile - 1) / max_tile;
  const int tile = n_tiles > 0 ? (n_tan + n_tiles - 1) / n_tiles : 1;
  const dim3 block(warps * kWarp);
  const dim3 grid((rows + warps - 1) / warps);
  kernel<<<grid, block, smem, stream>>>(a, b, da, db, w2, edges, out, dout,
                                        rows, ng, n_tan, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tan(const void* a, const void* b, const void* da, const void* db,
               const void* w2, const void* edges, void* out, void* dout,
               int rows, int ng, int n_tan, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (ng < 1 || ng > kWarp || n_tan < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the widest shared load of a staged row: NG a multiple of it and both
  // tangent arrays aligned to it, so that every row of every slab is
  int vec = 16 / sizeof(T);
  while (vec > 1 &&
         (ng % vec != 0 ||
          reinterpret_cast<uintptr_t>(da) % (vec * sizeof(T)) != 0 ||
          reinterpret_cast<uintptr_t>(db) % (vec * sizeof(T)) != 0)) {
    vec /= 2;
  }
  const int ngc = ng <= 8 ? 8 : ng <= 16 ? 16 : ng <= 20 ? 20 : 32;
  const auto s = static_cast<cudaStream_t>(stream);
#define TAN_CASE(NGC, VEC)                                                  \
  if (ngc == NGC && vec == VEC) {                                           \
    return launch_tan_instance<T, NGC, VEC>(                                \
        static_cast<const T*>(a), static_cast<const T*>(b),                 \
        static_cast<const T*>(da), static_cast<const T*>(db),               \
        static_cast<const T*>(w2), static_cast<const T*>(edges),            \
        static_cast<T*>(out), static_cast<T*>(dout), rows, ng, n_tan,       \
        device, s);                                                         \
  }
#define TAN_CASES(VEC) \
  TAN_CASE(8, VEC) TAN_CASE(16, VEC) TAN_CASE(20, VEC) TAN_CASE(32, VEC)
  TAN_CASES(1)
  TAN_CASES(2)
  if constexpr (sizeof(T) == 4) {
    TAN_CASES(4)
  }
#undef TAN_CASES
#undef TAN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int overlap_combine_f32(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int device,
                                   void* stream) {
  return launch_primal<float>(a, b, w2, edges, out, rows, ng, device, stream);
}

extern "C" int overlap_combine_f64(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int device,
                                   void* stream) {
  return launch_primal<double>(a, b, w2, edges, out, rows, ng, device,
                               stream);
}

// Fused primal + tangent combine: da, db and dout are (n_tan, rows, ng).
extern "C" int overlap_combine_tan_f32(const void* a, const void* b,
                                       const void* da, const void* db,
                                       const void* w2, const void* edges,
                                       void* out, void* dout, int rows,
                                       int ng, int n_tan, int device,
                                       void* stream) {
  return launch_tan<float>(a, b, da, db, w2, edges, out, dout, rows, ng,
                           n_tan, device, stream);
}

extern "C" int overlap_combine_tan_f64(const void* a, const void* b,
                                       const void* da, const void* db,
                                       const void* w2, const void* edges,
                                       void* out, void* dout, int rows,
                                       int ng, int n_tan, int device,
                                       void* stream) {
  return launch_tan<double>(a, b, da, db, w2, edges, out, dout, rows, ng,
                            n_tan, device, stream);
}
