// Random-overlap resort-rebin of two correlated-k distributions, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel combine_pair_pallas
// (archnemesis_tpu/ops/overlap_pallas.py:398, body _make_kernel :101). It
// computes the same function as the plain PyTorch version in
// archnemesis_tpu_torch/ops/overlap.py (_combine_pair), the reference's
// rankg (ForwardModel_0.py:5960):
//   for each row r: the NG*NG pair sums a[r,i] + b[r,j] with weights
//   del_g[i]*del_g[j], padded to E = next pow2 (>= 32) with keys at the
//   type's largest finite value and zero weight; sorted by key with the
//   weights; inclusive prefix sum of the sorted weights; each output g-bin
//   j gets the overlap-weighted mean of the keys over [edge_j, edge_j+1).
//
// What bounds it on the card: operations, by a little. One row reads 2*NG
// and writes NG values (240 B in float32 at NG=20); the function needs
// 5,753 operations per row at NG=20 with inputs sorted along g (400 pair
// sums, 2,000 comparisons to merge the 20 sorted runs of 20 keys, 400
// prefix-sum adds, 7 for each of the at most 419 (element, bin) overlaps
// of the rebin, 20 divisions; chip_smoke.py:combine_ops_per_row). At
// 581,632 rows that is 0.050 ms at the float32 peak against 0.042 ms for
// the bytes at the HBM rate. This kernel does far more than that: 79,860
// operations per row (the full bitonic network on 512 padded keys, 45
// stages x 256 compare-exchanges of a min and a max, and every element
// against every bin in the rebin), plus the warp shuffles, so it runs
// well above the bound; a faster design merges the presorted runs and
// rebins only the bins an element straddles.
// The design keeps every intermediate in registers and never touches
// shared or device memory between load and store:
//   - one warp per row; lane l holds elements l*K .. l*K+K-1, K = E/32;
//   - the inputs are loaded coalesced (lane j holds a[r,j] and b[r,j]) and
//     the pair sums formed with warp shuffles;
//   - bitonic compare-exchange: strides below K stay inside a thread,
//     larger strides exchange with lane ^ (stride/K) via __shfl_xor_sync;
//   - prefix sum: a serial scan inside each thread, then a warp scan;
//   - rebin: per-bin partial numerator/denominator per lane, then a warp
//     butterfly reduction per bin; lane j stores bin j.
// Equal keys may keep either weight: the rebin does not depend on the
// order of equal keys. Pad keys are the largest finite value, not inf:
// their overlap is exactly 0, and 0 * inf would be NaN.
//
// The tangent variant (TAN = true) replaces the TPU kernel's tangent
// co-sort (_combine_pallas with tangents, overlap_pallas.py:292-329, body
// _make_kernel :178-249): the same combine and, in the same pass, T tangent
// pairs da, db (T, R, NG) pushed through the primal's permutation and
// rebinned with the primal's overlaps and denominators,
//   dout[t, j] = sum_e inter[e, j] * (da[t, ia(e)] + db[t, ib(e)]) / den_j.
// The TPU kernel co-sorts T payload tiles; 81 payloads do not fit a warp's
// registers, so this kernel co-sorts ONE payload, the element's index
// pair (ia, ib) packed in an int (it also yields the weight w2[ia*NG+ib],
// so the sort carries an int where the primal carries the weight). While it rebins the primal it
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
};
template <> struct Limits<double> {
  __device__ static double max() { return DBL_MAX; }
  __device__ static double tiny() { return DBL_MIN; }
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

// TAN = false launches the primal kernel (da, db, dout unused), TAN = true
// the tangent variant.
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

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int overlap_combine_f32(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int e_pad,
                                   int device, void* stream) {
  return launch<float, false>(a, b, nullptr, nullptr, w2, edges, out, nullptr,
                              rows, ng, e_pad, 0, device, stream);
}

extern "C" int overlap_combine_f64(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int e_pad,
                                   int device, void* stream) {
  return launch<double, false>(a, b, nullptr, nullptr, w2, edges, out,
                               nullptr, rows, ng, e_pad, 0, device, stream);
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
