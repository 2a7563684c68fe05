// A/B variants of the random-overlap combine, for Hopper (sm_90a): lower
// bounds of what a redesign of the combine kernel (overlap_combine.cu)
// could save, in that kernel's own layout.
//
// Replaces the TPU kernel combine_lean (tools/bench_overlap_variants.py:131,
// body make_lean_kernel :38, pallas_call :151) and computes what each of
// its modes returns, on (R, NG) float32 inputs a, b with the static pair
// weights w2[i*NG + j] = del_g[i] del_g[j] and the g-bin edges (the plain
// PyTorch versions are in ops/overlap_variants.py):
//   full     the combine: the NG*NG pair sums a[r,i] + b[r,j] padded with
//            the float32 maximum, bitonic-sorted with their weights by
//            min/max compare-exchanges, a weight moving only where its key
//            changed (so tied keys keep their own weight); the inclusive
//            prefix sum of the sorted weights; each output bin the
//            overlap-weighted mean of the keys over [edge_j, edge_j+1),
//            numerator over max(denominator, 1e-37);
//   edges    the same sort and prefix sum, rebinned through cumulative edge
//            sums S(x) = sum_e key_e clip(x - glo_e, 0, w_e) and W(x)
//            likewise at the NG + 1 edges, bin j = (S(x_j+1) - S(x_j)) /
//            max(W(x_j+1) - W(x_j), 1e-37);
//   sortonly the compare-exchange stages on the keys alone: the NG
//            smallest pair sums in ascending order;
//   rollonly the stages' data movement alone: the padded pair-sum row
//            rotated by each stage's stride in turn (jnp.roll), so by the
//            sum of the strides modulo the padded length; its first NG
//            columns.
// The stage list is the TPU kernel's: the bitonic network over e_ref, the
// next power of two of NG*NG. This kernel's rows hold E = max(32, e_ref)
// elements (at least one per lane); where E > e_ref the extra elements are
// pads that the network of e_ref never reaches (full, edges, sortonly), or
// (rollonly) the row holds the e_ref-periodic pair-sum sequence, whose
// rotation by s in E elements is the rotation of the e_ref-row by s.
//
// Layout, as overlap_combine.cu's: one row per warp, lane l holding elements
// l*K .. l*K+K-1 (K = E/32); strides below K stay inside a thread, larger
// ones exchange with lane ^ (stride/K) by __shfl_xor_sync; the prefix sum a
// serial scan per thread and a warp scan; the rebins per-lane partial sums
// and one warp butterfly per bin (full) or per edge (edges). Eight warps a
// block; ROWS rows per block (the TPU kernel's row tile), ROWS / 8 rows per
// warp one after another.
//
// What bounds it on the card: for full and edges the combine's bound
// (chip_smoke.py:combine_ops_per_row, operations); for sortonly the merge
// of NG presorted runs of NG pair sums (operations); for rollonly the bytes
// in and out. Each mode runs its part of overlap_combine.cu's work in that
// kernel's layout, so its time bounds what a redesign of that part could
// save there.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kDenFloor = 1e-37f;

enum Mode {
  kModeFull = 0,
  kModeEdges = 1,
  kModeSortOnly = 2,
  kModeRollOnly = 3
};

// The row rotated by S (compile-time): new[e] = old[(e - S) mod E].
template <int K, int S>
__device__ __forceinline__ void rotate(float (&v)[K], int lane) {
  constexpr int kE = K * kWarp;
  constexpr int kS = S % kE;
  constexpr int kQ = kS / K;
  constexpr int kR = kS % K;
  float old[K];
#pragma unroll
  for (int i = 0; i < K; ++i) old[i] = v[i];
  const int src_same = (lane - kQ) & (kWarp - 1);
  const int src_prev = (lane - kQ - 1) & (kWarp - 1);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i >= kR) {
      v[i] = kQ == 0 ? old[i - kR] : __shfl_sync(kFull, old[i - kR], src_same);
    } else {
      v[i] = __shfl_sync(kFull, old[i - kR + K], src_prev);
    }
  }
}

// One compare-exchange stage (size, stride) of the bitonic network, as the
// TPU kernel writes it: the element in a descending pair position (the
// upper one of an ascending block, the lower one of a descending block)
// keeps the max, the other the min; with a payload, an element takes its
// partner's payload exactly where its key changed.
template <int K, bool PAYLOAD>
__device__ __forceinline__ void stage(float (&key)[K], float (&w)[K],
                                      int lane, int size, int stride) {
  if (stride >= K) {
    const int lstride = stride / K;
    const bool upper = (lane & lstride) != 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const bool desc = ((lane * K + i) & size) != 0;
      const bool keep_max = upper != desc;
      const float pk = __shfl_xor_sync(kFull, key[i], lstride);
      const float nk = keep_max ? fmaxf(key[i], pk) : fminf(key[i], pk);
      if (PAYLOAD) {
        const float pw = __shfl_xor_sync(kFull, w[i], lstride);
        w[i] = nk != key[i] ? pw : w[i];
      }
      key[i] = nk;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if ((i & stride) == 0) {
        const int j = i | stride;
        const bool desc = ((lane * K + i) & size) != 0;
        const float ni = desc ? fmaxf(key[i], key[j]) : fminf(key[i], key[j]);
        const float nj = desc ? fminf(key[i], key[j]) : fmaxf(key[i], key[j]);
        if (PAYLOAD) {
          const float wi = w[i];
          const float wj = w[j];
          w[i] = ni != key[i] ? wj : wi;
          w[j] = nj != key[j] ? wi : wj;
        }
        key[i] = ni;
        key[j] = nj;
      }
    }
  }
}

template <int K, int LOG_E, int MODE>
__device__ __forceinline__ void one_row(const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        const float* __restrict__ w2,
                                        const float* __restrict__ edges,
                                        float* __restrict__ out, int row,
                                        int ng, int log_ref, int lane) {
  const int n = ng * ng;
  const int e_ref = 1 << log_ref;
  const size_t base = static_cast<size_t>(row) * ng;
  const float a_l = lane < ng ? a[base + lane] : 0.f;
  const float b_l = lane < ng ? b[base + lane] : 0.f;

  float key[K], w[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    int e = lane * K + i;
    if (MODE == kModeRollOnly) e &= e_ref - 1;  // the e_ref-periodic row
    const int ia = e / ng;
    const int ib = e - ia * ng;
    const float s = __shfl_sync(kFull, a_l, ia & (kWarp - 1)) +
                    __shfl_sync(kFull, b_l, ib & (kWarp - 1));
    key[i] = e < n ? s : FLT_MAX;
    w[i] = (MODE == kModeFull || MODE == kModeEdges) ? w2[lane * K + i] : 0.f;
  }

  if (MODE == kModeRollOnly) {
    // jnp.roll by each stage's stride in turn is one rotation by their sum
    // in data, but the TPU kernel pays one rotation per stage: so does this
    // one, stage by stage (the strides of the network over e_ref)
#pragma unroll
    for (int ls = 1; ls <= LOG_E; ++ls) {
      if (ls > log_ref) break;
#pragma unroll
      for (int lt = ls - 1; lt >= 0; --lt) {
        switch (lt) {  // the stride as a compile-time constant
          case 0: rotate<K, 1>(key, lane); break;
          case 1: rotate<K, 2>(key, lane); break;
          case 2: rotate<K, 4>(key, lane); break;
          case 3: rotate<K, 8>(key, lane); break;
          case 4: rotate<K, 16>(key, lane); break;
          case 5: rotate<K, 32>(key, lane); break;
          case 6: rotate<K, 64>(key, lane); break;
          case 7: rotate<K, 128>(key, lane); break;
          case 8: rotate<K, 256>(key, lane); break;
          default: break;
        }
      }
    }
  } else {
#pragma unroll
    for (int ls = 1; ls <= LOG_E; ++ls) {
      if (ls > log_ref) break;
#pragma unroll
      for (int lt = ls - 1; lt >= 0; --lt) {
        stage<K, MODE != kModeSortOnly>(key, w, lane, 1 << ls, 1 << lt);
      }
    }
  }

  if (MODE == kModeRollOnly || MODE == kModeSortOnly) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int e = lane * K + i;
      if (e < ng) out[base + e] = key[i];
    }
    return;
  }

  // inclusive prefix sum of the sorted weights
  float ghi[K];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    run += w[i];
    ghi[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  float offset = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) offset = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) ghi[i] += offset;

  float my_num = 0.f, my_den = 0.f;
  if (MODE == kModeFull) {
    for (int j = 0; j < ng; ++j) {
      const float lo = edges[j];
      const float hi = edges[j + 1];
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float glo = ghi[i] - w[i];
        const float inter = fmaxf(fminf(ghi[i], hi) - fmaxf(glo, lo), 0.f);
        num += inter * key[i];
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
  } else {
    // lane j takes S and W at its bin's two edges: + at edge j + 1, - at j
    for (int x = 0; x <= ng; ++x) {
      const float edge = edges[x];
      float s = 0.f, wsum = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float glo = ghi[i] - w[i];
        const float c = fminf(fmaxf(edge - glo, 0.f), w[i]);
        s += c * key[i];
        wsum += c;
      }
#pragma unroll
      for (int d = kWarp / 2; d > 0; d >>= 1) {
        s += __shfl_xor_sync(kFull, s, d);
        wsum += __shfl_xor_sync(kFull, wsum, d);
      }
      if (lane == x - 1) {
        my_num += s;
        my_den += wsum;
      }
      if (lane == x) {
        my_num -= s;
        my_den -= wsum;
      }
    }
  }
  if (lane < ng) out[base + lane] = my_num / fmaxf(my_den, kDenFloor);
}

template <int K, int LOG_E, int MODE, int ROWS>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
variant_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ w2, const float* __restrict__ edges,
               float* __restrict__ out, int rows, int ng, int log_ref) {
  static_assert(ROWS % kWarpsPerBlock == 0, "ROWS is a multiple of 8");
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  // the block's ROWS rows, warp w taking rows w, w + 8, ...: at each step
  // the block's eight warps read eight neighbouring rows
  for (int r = warp; r < ROWS; r += kWarpsPerBlock) {
    const int row = blockIdx.x * ROWS + r;
    if (row >= rows) return;  // warp-uniform
    one_row<K, LOG_E, MODE>(a, b, w2, edges, out, row, ng, log_ref, lane);
  }
}

template <int K, int LOG_E, int MODE, int ROWS>
cudaError_t launch_one(cudaStream_t s, const float* a, const float* b,
                       const float* w2, const float* edges, float* out,
                       int rows, int ng, int log_ref) {
  const dim3 grid((rows + ROWS - 1) / ROWS);
  variant_kernel<K, LOG_E, MODE, ROWS><<<grid, kWarpsPerBlock * kWarp, 0, s>>>(
      a, b, w2, edges, out, rows, ng, log_ref);
  return cudaGetLastError();
}

template <int K, int LOG_E>
cudaError_t launch_e(cudaStream_t s, const float* a, const float* b,
                     const float* w2, const float* edges, float* out,
                     int rows, int ng, int log_ref, int mode,
                     int rows_per_cta) {
  // every mode at the TPU kernel's default row tile of 256; the full mode
  // also at the tile sweep of the TPU tool (8 .. 128)
  if (rows_per_cta == 256) {
    switch (mode) {
      case kModeFull:
        return launch_one<K, LOG_E, kModeFull, 256>(s, a, b, w2, edges, out,
                                                    rows, ng, log_ref);
      case kModeEdges:
        return launch_one<K, LOG_E, kModeEdges, 256>(s, a, b, w2, edges, out,
                                                     rows, ng, log_ref);
      case kModeSortOnly:
        return launch_one<K, LOG_E, kModeSortOnly, 256>(
            s, a, b, w2, edges, out, rows, ng, log_ref);
      case kModeRollOnly:
        return launch_one<K, LOG_E, kModeRollOnly, 256>(
            s, a, b, w2, edges, out, rows, ng, log_ref);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (mode != kModeFull) return cudaErrorInvalidValue;
  switch (rows_per_cta) {
    case 8:
      return launch_one<K, LOG_E, kModeFull, 8>(s, a, b, w2, edges, out, rows,
                                                ng, log_ref);
    case 16:
      return launch_one<K, LOG_E, kModeFull, 16>(s, a, b, w2, edges, out, rows,
                                                 ng, log_ref);
    case 32:
      return launch_one<K, LOG_E, kModeFull, 32>(s, a, b, w2, edges, out, rows,
                                                 ng, log_ref);
    case 64:
      return launch_one<K, LOG_E, kModeFull, 64>(s, a, b, w2, edges, out, rows,
                                                 ng, log_ref);
    case 128:
      return launch_one<K, LOG_E, kModeFull, 128>(s, a, b, w2, edges, out,
                                                  rows, ng, log_ref);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): one launch of `mode` (0 full,
// 1 edges, 2 sortonly, 3 rollonly) at `rows_per_cta` rows per block on
// float32 (rows, ng) a, b; w2 holds e_pad pair weights (zero beyond ng*ng),
// edges ng + 1 bin edges. e_pad = max(32, 2^log_ref) is this kernel's row
// length, 2^log_ref the TPU kernel's. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int overlap_variant_f32(const void* a, const void* b,
                                   const void* w2, const void* edges,
                                   void* out, int rows, int ng, int e_pad,
                                   int log_ref, int mode, int rows_per_cta,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* pw = static_cast<const float*>(w2);
  const float* pe = static_cast<const float*>(edges);
  float* po = static_cast<float*>(out);
#define LAUNCH_CASE(E, K, LOG_E)                                           \
  case E:                                                                  \
    err = launch_e<K, LOG_E>(s, pa, pb, pw, pe, po, rows, ng, log_ref,     \
                             mode, rows_per_cta);                          \
    break;
  switch (e_pad) {
    LAUNCH_CASE(32, 1, 5)
    LAUNCH_CASE(64, 2, 6)
    LAUNCH_CASE(128, 4, 7)
    LAUNCH_CASE(256, 8, 8)
    LAUNCH_CASE(512, 16, 9)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_CASE
  return static_cast<int>(err);
}
