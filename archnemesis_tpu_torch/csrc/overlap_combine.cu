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

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Limits;
template <> struct Limits<float> {
  __device__ static float max() { return FLT_MAX; }
  __device__ static float tiny() { return FLT_MIN; }
};
template <> struct Limits<double> {
  __device__ static double max() { return DBL_MAX; }
  __device__ static double tiny() { return DBL_MIN; }
};

// K elements per lane, LOG_E = log2(32 * K).
template <typename T, int K, int LOG_E>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
combine_kernel(const T* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ w2, const T* __restrict__ edges,
               T* __restrict__ out, int rows, int ng) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (row >= rows) return;  // warp-uniform: the whole warp leaves together
  const int n = ng * ng;
  const size_t base = static_cast<size_t>(row) * ng;

  const T a_l = lane < ng ? a[base + lane] : T(0);
  const T b_l = lane < ng ? b[base + lane] : T(0);

  T key[K], w[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int e = lane * K + i;
    const int ia = e / ng;
    const int ib = e - ia * ng;
    const T s = __shfl_sync(kFull, a_l, ia & (kWarp - 1)) +
                __shfl_sync(kFull, b_l, ib & (kWarp - 1));
    key[i] = e < n ? s : Limits<T>::max();
    w[i] = w2[e];  // zero beyond n
  }

  // bitonic sort, ascending, of E = 32*K keys with their weights
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
          const T pw = __shfl_xor_sync(kFull, w[i], lstride);
          // the lower index of an ascending pair keeps the min, the upper
          // one the max; reversed in descending blocks
          const bool keep_min = asc != upper;
          const bool take = keep_min ? (pk < key[i]) : (pk > key[i]);
          if (take) {
            key[i] = pk;
            w[i] = pw;
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
              T t = key[i];
              key[i] = key[j];
              key[j] = t;
              t = w[i];
              w[i] = w[j];
              w[j] = t;
            }
          }
        }
      }
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
  if (lane < ng) {
    const T tiny = Limits<T>::tiny();
    out[base + lane] = my_num / (my_den > tiny ? my_den : tiny);
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* w2, const void* edges,
           void* out, int rows, int ng, int e_pad, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  const dim3 block(kWarpsPerBlock * kWarp);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* pw = static_cast<const T*>(w2);
  const T* pe = static_cast<const T*>(edges);
  T* po = static_cast<T*>(out);
  switch (e_pad) {
    case 32:
      combine_kernel<T, 1, 5><<<grid, block, 0, s>>>(pa, pb, pw, pe, po, rows, ng);
      break;
    case 64:
      combine_kernel<T, 2, 6><<<grid, block, 0, s>>>(pa, pb, pw, pe, po, rows, ng);
      break;
    case 128:
      combine_kernel<T, 4, 7><<<grid, block, 0, s>>>(pa, pb, pw, pe, po, rows, ng);
      break;
    case 256:
      combine_kernel<T, 8, 8><<<grid, block, 0, s>>>(pa, pb, pw, pe, po, rows, ng);
      break;
    case 512:
      combine_kernel<T, 16, 9><<<grid, block, 0, s>>>(pa, pb, pw, pe, po, rows, ng);
      break;
    case 1024:
      combine_kernel<T, 32, 10><<<grid, block, 0, s>>>(pa, pb, pw, pe, po, rows, ng);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int overlap_combine_f32(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int e_pad,
                                   int device, void* stream) {
  return launch<float>(a, b, w2, edges, out, rows, ng, e_pad, device, stream);
}

extern "C" int overlap_combine_f64(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int e_pad,
                                   int device, void* stream) {
  return launch<double>(a, b, w2, edges, out, rows, ng, e_pad, device,
                        stream);
}
