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
// of the rebin, 20 divisions; chip_smoke.py:combine_ops_per_row). At
// 581,632 rows that is 0.050 ms at the float32 peak against 0.042 ms for
// the bytes at the HBM rate.
//
// The primal kernel (combine_primal_kernel) does close to that work, one
// warp per row, with the row's elements in shared memory:
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
//      the result, is deterministic;
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
// What it costs beyond the bound: shared-memory bandwidth. Every merge
// level moves each element through shared memory once (a load and a store
// of its 8- or 16-byte word) and the co-rank searches add random loads;
// the lanes' loads fall in random banks, and the rebin's lanes walk bins of
// unequal length with NG of 32 lanes busy. With many warps resident an
// SM the kernel is bound by the shared-memory pipe, with few by latency
// (PERF.md has the times); so the launch takes the rows per block that
// keep the most warps resident.
//
// The tangent variant (TAN = true) replaces the TPU kernel's tangent
// co-sort (_combine_pallas with tangents, overlap_pallas.py:292-329, body
// _make_kernel :178-249): the same combine and, in the same pass, T tangent
// pairs da, db (T, R, NG) pushed through the primal's permutation and
// rebinned with the primal's overlaps and denominators,
//   dout[t, j] = sum_e inter[e, j] * (da[t, ia(e)] + db[t, ib(e)]) / den_j.
// The TPU kernel co-sorts T payload tiles; 81 payloads do not fit a warp's
// registers, so this kernel co-sorts ONE payload, the element's index
// pair (ia, ib) packed in an int (it also yields the weight
// w2[ia*NG+ib]). It sorts in registers with the earlier primal design: one warp per row,
// the NG*NG pair sums padded to E = next pow2 (>= 32) with keys at the
// type's largest finite value, lane l holding elements l*K .. l*K+K-1
// (K = E/32), a bitonic network whose strides below K stay inside a
// thread and whose larger strides exchange with lane ^ (stride/K) through
// __shfl_xor_sync, a serial-then-warp prefix scan, and a rebin of every
// element against every bin with a warp butterfly per bin. Equal keys may
// keep either payload; pad keys are the largest finite value, not inf:
// their overlap is exactly 0, and 0 * inf would be NaN. (The template's
// TAN = false branches, which carry the weight instead, are that earlier
// primal; only TAN = true is instantiated.) While it rebins the primal it
// scatters every positive overlap into the row's two NG x NG matrices in
// shared memory,
//   MA[i][j] = sum_{e: ia(e)=i} inter[e, j],  MB[i][j] likewise for ib,
// with shared-memory atomic adds (at most n + NG overlaps a row, two adds
// each; their order varies from run to run, so dout is reproducible to
// rounding only). Then it loops over the T tangents, four at a time,
// reading da[t, r, :] and db[t, r, :] once each (lane j holds element j,
// broadcast by shuffles) and applying the matrices: lane j accumulates
// sum_i MA[i][j] da[i] + MB[i][j] db[i], scales by 1/den_j and stores
// dout[t, r, j]. The applying product is part of this kernel, not a
// library call.
// What bounds the tangent variant: bytes. At T = 81, R = 39,689, NG = 20
// the three (T, R, NG) arrays are 0.77 GB in float32, 0.23 ms at the HBM
// rate, against 0.06 ms for the 1,258 operations per row and tangent at the
// float32 peak (chip_smoke.py:fused_bound_ms). The kernel runs about ten
// times above that bound (PERF.md has the times): beyond the primal's sort
// it pays for the scatter of the matrices (shared-memory atomics) and for
// applying them with 20 of 32 lanes busy and 2 * NG shuffles per tangent,
// reading 8 rows' worth (640 B) of each tangent at a time. A faster design
// keeps the matrices in registers, stages the tangents through shared
// memory instead of shuffling them, and reads longer contiguous runs.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadIndex = 1 << 10;  // payload of a pad element (TAN)
constexpr int kTanBatch = 4;  // tangents applied per pass over a row's matrices

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

// K elements per lane, LOG_E = log2(32 * K). TAN: also push n_tan tangent
// pairs da, db (n_tan, rows, ng) through the sort into dout; the sort then
// carries each element's index instead of its weight.
template <typename T, int K, int LOG_E, bool TAN>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
combine_kernel(const T* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ w2, const T* __restrict__ edges,
               T* __restrict__ out, int rows, int ng,
               const T* __restrict__ da, const T* __restrict__ db,
               T* __restrict__ dout, int n_tan) {
  using Payload = std::conditional_t<TAN, int, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (row >= rows) return;  // warp-uniform: the whole warp leaves together
  const int n = ng * ng;
  const size_t base = static_cast<size_t>(row) * ng;

  // this warp's two NG x NG overlap matrices, zeroed
  T* mat = nullptr;
  if constexpr (TAN) {
    mat = reinterpret_cast<T*>(smem_raw) +
          static_cast<size_t>(threadIdx.x / kWarp) * 2 * n;
    for (int x = lane; x < 2 * n; x += kWarp) mat[x] = T(0);
    __syncwarp();
  }

  const T a_l = lane < ng ? a[base + lane] : T(0);
  const T b_l = lane < ng ? b[base + lane] : T(0);

  T key[K];
  Payload pay[K];  // the weight, or with TAN the element's index
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int e = lane * K + i;
    const int ia = e / ng;
    const int ib = e - ia * ng;
    const T s = __shfl_sync(kFull, a_l, ia & (kWarp - 1)) +
                __shfl_sync(kFull, b_l, ib & (kWarp - 1));
    key[i] = e < n ? s : Limits<T>::max();
    if constexpr (TAN) {
      // (ia, ib) packed in 5 bits each (NG <= 32); pads carry kPadIndex
      pay[i] = e < n ? ((ia << 5) | ib) : kPadIndex;
    } else {
      pay[i] = w2[e];  // zero beyond n
    }
  }

  // bitonic sort, ascending, of E = 32*K keys with their payloads
#pragma unroll
  for (int ls = 1; ls <= LOG_E; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride >= K) {
        const int lstride = stride / K;
        const bool upper = (lane & lstride) != 0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const bool asc = ((lane * K + i) & size) == 0;
          const T pk = __shfl_xor_sync(kFull, key[i], lstride);
          const Payload pw = __shfl_xor_sync(kFull, pay[i], lstride);
          // the lower index of an ascending pair keeps the min, the upper
          // one the max; reversed in descending blocks
          const bool keep_min = asc != upper;
          const bool take = keep_min ? (pk < key[i]) : (pk > key[i]);
          if (take) {
            key[i] = pk;
            pay[i] = pw;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if ((i & stride) == 0) {
            const int j = i | stride;
            const bool asc = ((lane * K + i) & size) == 0;
            const bool swap = asc ? (key[i] > key[j]) : (key[i] < key[j]);
            if (swap) {
              const T t = key[i];
              key[i] = key[j];
              key[j] = t;
              const Payload u = pay[i];
              pay[i] = pay[j];
              pay[j] = u;
            }
          }
        }
      }
    }
  }

  // the sorted weights: carried by the sort, or looked up by index
  T w[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if constexpr (TAN) {
      w[i] = pay[i] == kPadIndex
                 ? T(0)
                 : w2[(pay[i] >> 5) * ng + (pay[i] & 31)];
    } else {
      w[i] = pay[i];
    }
  }

  // inclusive prefix sum of the sorted weights
  T ghi[K];
  T run = T(0);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    run += w[i];
    ghi[i] = run;
  }
  T incl = run;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const T up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  T offset = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) offset = T(0);
#pragma unroll
  for (int i = 0; i < K; ++i) ghi[i] += offset;

  // interval-overlap rebin into the NG output bins
  T my_num = T(0), my_den = T(0);
  for (int j = 0; j < ng; ++j) {
    const T lo = edges[j];
    const T hi = edges[j + 1];
    T num = T(0), den = T(0);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const T glo = ghi[i] - w[i];
      T inter = (ghi[i] < hi ? ghi[i] : hi) - (glo > lo ? glo : lo);
      inter = inter > T(0) ? inter : T(0);
      num += key[i] * inter;
      den += inter;
    }
#pragma unroll
    for (int d = kWarp / 2; d > 0; d >>= 1) {
      num += __shfl_xor_sync(kFull, num, d);
      den += __shfl_xor_sync(kFull, den, d);
    }
    if (lane == j) {
      my_num = num;
      my_den = den;
    }
  }
  const T tiny = Limits<T>::tiny();
  if (lane < ng) {
    out[base + lane] = my_num / (my_den > tiny ? my_den : tiny);
  }

  if constexpr (TAN) {
    // scatter every element's overlaps (the same arithmetic as above) into
    // the two matrices. Walking each element's own bins, from the one that
    // holds its lower end, keeps all lanes busy in each atomic instruction;
    // testing every element against every bin would issue ten times as
    // many, one or two lanes each.
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (pay[i] == kPadIndex) continue;
      const T glo = ghi[i] - w[i];
      int j = 0;  // the last bin whose lower edge is <= glo (NG <= 32)
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int c = j + step;
        if (c < ng && edges[c] <= glo) j = c;
      }
      T* ma = mat + (pay[i] >> 5) * ng;
      T* mb = mat + n + (pay[i] & 31) * ng;
      for (; j < ng; ++j) {
        const T lo = edges[j];
        if (lo >= ghi[i]) break;
        const T hi = edges[j + 1];
        const T inter = (ghi[i] < hi ? ghi[i] : hi) - (glo > lo ? glo : lo);
        if (inter > T(0)) {
          atomicAdd(&ma[j], inter);
          atomicAdd(&mb[j], inter);
        }
      }
    }
    __syncwarp();  // every lane's overlaps are in the matrices
    const T inv_den = T(1) / (my_den > tiny ? my_den : tiny);
    const size_t t_stride = static_cast<size_t>(rows) * ng;
    const int col = lane < ng ? lane : 0;
    // kTanBatch tangents at a time: their loads are in flight together,
    // their sums are independent chains, and each matrix entry is read
    // once for all of them
    for (int t0 = 0; t0 < n_tan; t0 += kTanBatch) {
      T da_l[kTanBatch], db_l[kTanBatch], acc[kTanBatch];
#pragma unroll
      for (int k = 0; k < kTanBatch; ++k) {
        const bool live = t0 + k < n_tan && lane < ng;
        const size_t off = static_cast<size_t>(t0 + k) * t_stride + base;
        da_l[k] = live ? da[off + lane] : T(0);
        db_l[k] = live ? db[off + lane] : T(0);
        acc[k] = T(0);
      }
      for (int i = 0; i < ng; ++i) {
        const T ma = mat[i * ng + col];
        const T mb = mat[n + i * ng + col];
#pragma unroll
        for (int k = 0; k < kTanBatch; ++k) {
          acc[k] += ma * __shfl_sync(kFull, da_l[k], i) +
                    mb * __shfl_sync(kFull, db_l[k], i);
        }
      }
#pragma unroll
      for (int k = 0; k < kTanBatch; ++k) {
        if (t0 + k < n_tan && lane < ng) {
          const size_t off = static_cast<size_t>(t0 + k) * t_stride + base;
          dout[off + lane] = acc[k] * inv_den;
        }
      }
    }
  }
}

template <typename T, int K, int LOG_E, bool TAN>
cudaError_t launch_one(dim3 grid, dim3 block, cudaStream_t s, const T* a,
                       const T* b, const T* w2, const T* edges, T* out,
                       int rows, int ng, const T* da, const T* db, T* dout,
                       int n_tan) {
  size_t smem = 0;
  if (TAN) {
    smem = static_cast<size_t>(kWarpsPerBlock) * 2 * ng * ng * sizeof(T);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          combine_kernel<T, K, LOG_E, TAN>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
  }
  combine_kernel<T, K, LOG_E, TAN><<<grid, block, smem, s>>>(
      a, b, w2, edges, out, rows, ng, da, db, dout, n_tan);
  return cudaGetLastError();
}

// TAN = true launches the tangent variant (the primal has its own kernel
// and launch below; TAN = false is not instantiated).
template <typename T, bool TAN>
int launch(const void* a, const void* b, const void* da, const void* db,
           const void* w2, const void* edges, void* out, void* dout,
           int rows, int ng, int e_pad, int n_tan, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  const dim3 block(kWarpsPerBlock * kWarp);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* pda = static_cast<const T*>(da);
  const T* pdb = static_cast<const T*>(db);
  const T* pw = static_cast<const T*>(w2);
  const T* pe = static_cast<const T*>(edges);
  T* po = static_cast<T*>(out);
  T* pdo = static_cast<T*>(dout);
#define LAUNCH_CASE(E, K, LOG_E)                                            \
  case E:                                                                   \
    err = launch_one<T, K, LOG_E, TAN>(grid, block, s, pa, pb, pw, pe, po,  \
                                       rows, ng, pda, pdb, pdo, n_tan);     \
    break;
  switch (e_pad) {
    LAUNCH_CASE(32, 1, 5)
    LAUNCH_CASE(64, 2, 6)
    LAUNCH_CASE(128, 4, 7)
    LAUNCH_CASE(256, 8, 8)
    LAUNCH_CASE(512, 16, 9)
    LAUNCH_CASE(1024, 32, 10)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_CASE
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// The primal kernel: one warp per row, `warps` rows per block.

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

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
combine_primal_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ w2, const T* __restrict__ edges,
                      T* __restrict__ out, int rows, int ng) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ng * ng;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;

  // the block's weight table (w2s[(ia << 5) | ib] = w2[ia * NG + ib], the
  // same bits) and bin edges
  T* w2s = reinterpret_cast<T*>(smem_raw);
  T* edge_s = w2s + kPairSlots;
  for (int x = threadIdx.x; x < kPairSlots; x += blockDim.x) {
    const int ia = x / kWarp;
    const int ib = x - ia * kWarp;
    w2s[x] = (ia < ng && ib < ng) ? w2[ia * ng + ib] : T(0);
  }
  for (int x = threadIdx.x; x <= ng; x += blockDim.x) edge_s[x] = edges[x];
  __syncthreads();

  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // warp-uniform: the whole warp leaves together

  const int cap = round_up4(n);
  Elem<T>* buf = reinterpret_cast<Elem<T>*>(
      smem_raw + primal_block_bytes<T>() + warp * primal_warp_bytes<T>(n));
  Elem<T>* other = buf + cap;
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
      const Elem<T> spent = {Limits<T>::max(), 0u};
      Elem<T> ex = x < mid ? buf[x] : spent;
      Elem<T> ey = y < end ? buf[y] : spent;
      for (; d < stop; ++d) {
        const bool take_x = ex.key <= ey.key;
        other[d] = take_x ? ex : ey;
        x += take_x;
        y += !take_x;
        const int next = take_x ? x : y;
        const Elem<T> e_next = next < (take_x ? mid : end) ? buf[next] : spent;
        if (take_x) {
          ex = e_next;
        } else {
          ey = e_next;
        }
      }
    }
    __syncwarp();
    Elem<T>* t = buf;
    buf = other;
    other = t;
  }

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
  if (!live) return;
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
    const T g_lo = sp.ghi - sp.w;
    T inter = (sp.ghi < hi_j ? sp.ghi : hi_j) - (g_lo > lo_j ? g_lo : lo_j);
    inter = inter > T(0) ? inter : T(0);
    num += buf[e].key * inter;
    den += inter;
    if (sp.ghi >= last) break;
  }
  // 6. the overlap-weighted mean
  const T tiny = Limits<T>::tiny();
  out[base + lane] = num / (den > tiny ? den : tiny);
}

// `warps` rows per block, 1 .. 16; 0 takes the count of 16, 8, 4, 2, 1
// that keeps the most rows resident on an SM (with few warps resident the
// kernel is bound by latency), the smaller block on a tie.
template <typename T>
int launch_primal(const void* a, const void* b, const void* w2,
                  const void* edges, void* out, int rows, int ng, int warps,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (ng < 1 || ng > kWarp || warps < 0 || warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_warp = primal_warp_bytes<T>(ng * ng);
  if (warps == 0) {
    int sm_smem = 0;
    err = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int best = 0;
    for (int w = kMaxWarps; w >= 1; w /= 2) {
      const size_t smem = primal_block_bytes<T>() + w * per_warp;
      if (smem > kMaxSmem) continue;
      // 1 KB of each block's shared memory is the system's
      const int blocks =
          min(min(static_cast<int>(sm_smem / (smem + 1024)), 64 / w), 32);
      if (blocks >= 1 && blocks * w >= best) {
        best = blocks * w;
        warps = w;
      }
    }
    if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = primal_block_bytes<T>() + warps * per_warp;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(combine_primal_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(warps * kWarp);
  const dim3 grid((rows + warps - 1) / warps);
  combine_primal_kernel<T><<<grid, block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(w2), static_cast<const T*>(edges),
      static_cast<T*>(out), rows, ng);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
// The primal: `warps` rows per block (1 .. 16, or 0: launch_primal's
// choice).
extern "C" int overlap_combine_f32(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int warps,
                                   int device, void* stream) {
  return launch_primal<float>(a, b, w2, edges, out, rows, ng, warps, device,
                              stream);
}

extern "C" int overlap_combine_f64(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int warps,
                                   int device, void* stream) {
  return launch_primal<double>(a, b, w2, edges, out, rows, ng, warps, device,
                               stream);
}

// Fused primal + tangent combine: da, db and dout are (n_tan, rows, ng).
extern "C" int overlap_combine_tan_f32(const void* a, const void* b,
                                       const void* da, const void* db,
                                       const void* w2, const void* edges,
                                       void* out, void* dout, int rows,
                                       int ng, int e_pad, int n_tan,
                                       int device, void* stream) {
  return launch<float, true>(a, b, da, db, w2, edges, out, dout, rows, ng,
                             e_pad, n_tan, device, stream);
}

extern "C" int overlap_combine_tan_f64(const void* a, const void* b,
                                       const void* da, const void* db,
                                       const void* w2, const void* edges,
                                       void* out, void* dout, int rows,
                                       int ng, int e_pad, int n_tan,
                                       int device, void* stream) {
  return launch<double, true>(a, b, da, db, w2, edges, out, dout, rows, ng,
                              e_pad, n_tan, device, stream);
}
