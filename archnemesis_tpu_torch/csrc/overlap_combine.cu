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
// warp per row, with the row's elements in shared memory (combine_row, in
// overlap_row.cuh, which the combine's A/B variants share):
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
//   A. each warp runs steps 1-6 above on its row (combine_row, the same
//      code and arithmetic: out is the primal kernel's result bit for bit).
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
// float32 peak (chip_smoke.py:fused_bound_ms). What it costs beyond: phase
// A, the primal kernel's shared-memory-bound merge at the few rows per SM
// that the matrices and registers leave resident (a launch with no
// tangents takes about half the time of one with 81; chip_smoke.py phase 5
// times both beside the primal kernel), and phase B's product, bound by
// instruction issue and the shared-memory pipe, which phase A also needs
// (PERF.md has the times).

#include "overlap_row.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
combine_primal_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ w2, const T* __restrict__ edges,
                      T* __restrict__ out, int rows, int ng) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w2s = reinterpret_cast<T*>(smem_raw);
  T* edge_s = w2s + kPairSlots;
  load_tables(w2s, edge_s, w2, edges, ng);
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // warp-uniform: the whole warp leaves together
  combine_row<T, false>(a, b, w2s, edge_s,
                        smem_raw + primal_block_bytes<T>() +
                            warp * primal_warp_bytes<T>(ng * ng),
                        out, row, ng, nullptr);
}

// `warps` rows per block, 1 .. 16; 0 takes the count of 16, 8, 4, 2, 1
// that keeps the most rows resident on an SM (resident_warps).
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
    warps = resident_warps(primal_block_bytes<T>(), per_warp, sm_smem,
                           kMaxWarps);
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
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
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
    cp_async16(dst + head + k * v, src + head + k * v);
  }
  const int rest = len - words * v;  // head and tail elements
  for (int q = lane; q < rest; q += kWarp) {
    const int x = q < head ? q : q + words * v;
    cp_async_elem<sizeof(T)>(dst + x, src + x);
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
  cp_async_commit();

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
    cp_async_commit();
    cp_async_wait<1>();  // tile k is in
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
                        int rows, int ng, int warps, int n_tan, int device,
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
  if (warps == 0) {
    // the count of 8, 4, 2, 1 rows per block that keeps the most rows
    // resident on an SM, the larger block on a tie (longer slabs, fewer
    // idle lanes in phase B)
    int best = 0;
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
  }
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

// `warps` rows per block, 1 .. 8, or 0: launch_tan_instance's choice.
template <typename T>
int launch_tan(const void* a, const void* b, const void* da, const void* db,
               const void* w2, const void* edges, void* out, void* dout,
               int rows, int ng, int warps, int n_tan, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (ng < 1 || ng > kWarp || warps < 0 || warps > kMaxTanWarps ||
      n_tan < 0) {
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
        static_cast<T*>(out), static_cast<T*>(dout), rows, ng, warps,       \
        n_tan, device, s);                                                  \
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
// e_pad (the padded length of the pair-weight table) is not read: the
// kernel reads w2[ia * ng + ib] only.
extern "C" int overlap_combine_tan_f32(const void* a, const void* b,
                                       const void* da, const void* db,
                                       const void* w2, const void* edges,
                                       void* out, void* dout, int rows,
                                       int ng, int e_pad, int n_tan,
                                       int device, void* stream) {
  (void)e_pad;
  return launch_tan<float>(a, b, da, db, w2, edges, out, dout, rows, ng, 0,
                           n_tan, device, stream);
}

extern "C" int overlap_combine_tan_f64(const void* a, const void* b,
                                       const void* da, const void* db,
                                       const void* w2, const void* edges,
                                       void* out, void* dout, int rows,
                                       int ng, int e_pad, int n_tan,
                                       int device, void* stream) {
  (void)e_pad;
  return launch_tan<double>(a, b, da, db, w2, edges, out, dout, rows, ng, 0,
                            n_tan, device, stream);
}

// The same with `warps` rows per block (1 .. 8, or 0 as above) in place of
// e_pad, for timing the choices.
extern "C" int overlap_combine_tan_warps_f32(
    const void* a, const void* b, const void* da, const void* db,
    const void* w2, const void* edges, void* out, void* dout, int rows,
    int ng, int warps, int n_tan, int device, void* stream) {
  return launch_tan<float>(a, b, da, db, w2, edges, out, dout, rows, ng,
                           warps, n_tan, device, stream);
}

extern "C" int overlap_combine_tan_warps_f64(
    const void* a, const void* b, const void* da, const void* db,
    const void* w2, const void* edges, void* out, void* dout, int rows,
    int ng, int warps, int n_tan, int device, void* stream) {
  return launch_tan<double>(a, b, da, db, w2, edges, out, dout, rows, ng,
                            warps, n_tan, device, stream);
}
