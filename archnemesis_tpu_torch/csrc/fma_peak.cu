// float32 fused multiply-add throughput probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel `run` of tools/bench_vpu_peak.py:39 (kernel body
// :28, pallas_call :40), the VPU float32 peak probe. It computes exactly
// that kernel's function, elementwise over x:
//   y = x * 1.0000001f + 0.5f,  z = x * 0.9999999f - 0.25f,
//   256 times: y = y * 1.0000001f + x,  z = z * 0.9999999f + x,
//   out = y + z,
// every multiply-add a single fused, once-rounded FFMA (the JAX kernel's
// `y * c + x` contracts to a fused multiply-add on the CPU as well: the
// plain version, ops/fma_peak.py:fma_chain_plain, rounds each step once and
// agrees with both bit for bit).
//
// What bounds it on the card: operations. Each element reads 4 bytes and
// writes 4, and needs 2 * 512 = 1,024 flops (the two initial FMAs and the
// final add are not counted, as the TPU tool does not count them): at
// 72,704 x 512 elements that is 38.1 GFLOP, 0.57 ms at the data sheet's
// 67 TFLOP/s float32 peak against 0.089 ms for the 298 MB at the HBM rate.
// The design is for the H100's FP32 pipes, not the TPU's (256, 512) tiles:
//   - each thread holds kElems = 4 elements (one 16-byte load and store),
//     so it runs 8 independent FFMA chains; an FFMA's result is ready
//     about 4 cycles after the instruction starts, and 8 chains per thread
//     with 8 warps per block keep every SM sub-partition starting one
//     warp-FFMA per cycle;
//   - blocks of 256 threads, one element quad per thread, a grid of
//     ceil(N / 1024) blocks: at the probe's size ~36,000 blocks, so all 132
//     SMs stay busy for many waves and the ragged last wave is a small
//     share of the time;
//   - the 256 steps are unrolled: the loop body is nothing but FFMAs (no
//     induction variable, no branch). No fast-math is needed or used: the
//     compiler may neither fold nor reassociate a chain of IEEE FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 4;
constexpr int kSteps = 256;  // per chain; NITER = 512 over the two chains
constexpr float kUp = 1.0000001f;
constexpr float kDown = 0.9999999f;

// the recurrence on kElems elements at once: their 2 * kElems chains are
// interleaved step by step, so consecutive FFMAs never depend on each other
__device__ __forceinline__ void chains(const float (&x)[kElems],
                                       float (&out)[kElems]) {
  float y[kElems], z[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    y[e] = __fmaf_rn(x[e], kUp, 0.5f);
    z[e] = __fmaf_rn(x[e], kDown, -0.25f);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      y[e] = __fmaf_rn(y[e], kUp, x[e]);
      z[e] = __fmaf_rn(z[e], kDown, x[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) out[e] = __fadd_rn(y[e], z[e]);
}

__global__ void __launch_bounds__(kThreads)
fma_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long n) {
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kElems;
  if (first >= n) return;
  float v[kElems], r[kElems];
  if (first + kElems <= n) {
    const float4 q = *reinterpret_cast<const float4*>(x + first);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    chains(v, r);
    *reinterpret_cast<float4*>(out + first) = make_float4(r[0], r[1], r[2],
                                                          r[3]);
  } else {  // the ragged end: fewer than kElems elements left
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      v[e] = first + e < n ? x[first + e] : 0.f;
    }
    chains(v, r);
    for (int e = 0; first + e < n; ++e) out[first + e] = r[e];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): the recurrence over n elements,
// x and out 16-byte aligned. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch.
extern "C" int fma_peak_f32(const void* x, void* out, long long n, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long per_block = static_cast<long long>(kThreads) * kElems;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fma_peak_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
