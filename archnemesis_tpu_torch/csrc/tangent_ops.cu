// Tangent passes of the correlated-k forward under forward-mode derivatives
// (torch.func.jacfwd), for Hopper (sm_90a). Neither replaces a TPU kernel:
// the JAX package leaves these passes to XLA, which fuses them; here they
// are the two places where PyTorch's elementwise kernels made several
// passes over a (T, ROWS, NG) tangent, 4 GB at the Jacobian cell's shape
// (T = 86 tangents, ROWS = 8192 x 71, NG = 20, float32).
//
// gas_tau_tangent: the tangent of one gas's optical depth k * amount in
//   each of B states,
//   out[t, s, w, l, g] = dk_dv[s, w, l, g] a[t, s, l]
//                        + dk_du[s, w, l, g] b[t, s, l]
//                        + k[s, w, l, g] c[t, s, l],
//   with a = amount dv, b = amount du, c = d(amount) (ops/ktab.py:
//   LayerK.tau; B = 1 under jacfwd, the states of a vmap otherwise). One
//   thread holds one (s, w, l, g) element's three factors in
//   registers and writes its T values, each a coalesced store across the
//   warp; the (T, B, NLAY) coefficients are a few kB and stay in cache. What
//   bounds it: the T x ROWS x NG output, written once (the factors are
//   read once): 4.0 GB, 1.2 ms at the data sheet's 3.35 TB/s. PyTorch's
//   three passes (a multiply and two multiply-adds over the output) read
//   and write it five times.
//
// skip_rows: the random overlap's skip rule on the tangents of one combine
//   (ops/overlap.py:mix_gas_k), in place on the combine's own fresh
//   tangent dout (T, ROWS, NG): rows where gas b has no opacity take da's
//   tangent, rows where the mixture so far has none take db's, others keep
//   the combine's. One thread a row reads the row's two flags and, only
//   for a skipped row, copies its T x NG values; with no row skipped (the
//   usual case) the pass reads 2 bytes a row. torch.where read and wrote
//   the whole tangent twice per combine.
//
// The C interface takes raw device pointers and the CUDA stream, returns
// cudaGetLastError() after the launch and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void gas_tau_tangent_kernel(const T* __restrict__ k,
                                       const T* __restrict__ dk_dv,
                                       const T* __restrict__ dk_du,
                                       const T* __restrict__ a,
                                       const T* __restrict__ b,
                                       const T* __restrict__ c,
                                       T* __restrict__ out, int64_t elems,
                                       int64_t per_state, int nlay, int ng,
                                       int n_batch, int n_tan) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= elems) return;
  // the element's state and layer: its coefficients are sl + t * stride
  const int sl = static_cast<int>(e / per_state) * nlay +
                 static_cast<int>((e / ng) % nlay);
  const int stride = n_batch * nlay;
  const T kk = k[e], fv = dk_dv[e], fu = dk_du[e];
  for (int t = 0; t < n_tan; ++t) {
    const int tl = t * stride + sl;
    T r = kk * c[tl];
    r = fma(fu, b[tl], r);
    r = fma(fv, a[tl], r);
    out[static_cast<int64_t>(t) * elems + e] = r;
  }
}

template <typename T>
__global__ void skip_rows_kernel(T* __restrict__ dout,
                                 const T* __restrict__ da,
                                 const T* __restrict__ db,
                                 const uint8_t* __restrict__ skip_a,
                                 const uint8_t* __restrict__ skip_b,
                                 int rows, int ng, int n_tan) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* src = skip_b[r] ? da : (skip_a[r] ? db : nullptr);
  if (src == nullptr) return;
  const int64_t plane = static_cast<int64_t>(rows) * ng;
  for (int t = 0; t < n_tan; ++t) {
    const int64_t base = t * plane + static_cast<int64_t>(r) * ng;
    for (int g = 0; g < ng; ++g) dout[base + g] = src[base + g];
  }
}

template <typename T>
int launch_gas_tau_tangent(const void* k, const void* dk_dv,
                           const void* dk_du, const void* a, const void* b,
                           const void* c, void* out, int64_t elems, int nlay,
                           int ng, int n_batch, int n_tan, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (elems <= 0 || n_tan <= 0) return 0;
  if (nlay < 1 || ng < 1 || n_batch < 1 || elems % n_batch != 0 ||
      (elems / n_batch) % (static_cast<int64_t>(nlay) * ng) != 0 ||
      static_cast<int64_t>(n_tan) * n_batch * nlay > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (elems + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  gas_tau_tangent_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(k), static_cast<const T*>(dk_dv),
      static_cast<const T*>(dk_du), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(out), elems, elems / n_batch, nlay, ng, n_batch,
      n_tan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_skip_rows(void* dout, const void* da, const void* db,
                     const void* skip_a, const void* skip_b, int rows,
                     int ng, int n_tan, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || n_tan <= 0) return 0;
  if (ng < 1) return static_cast<int>(cudaErrorInvalidValue);
  skip_rows_kernel<T><<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(dout), static_cast<const T*>(da),
      static_cast<const T*>(db), static_cast<const uint8_t*>(skip_a),
      static_cast<const uint8_t*>(skip_b), rows, ng, n_tan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k, dk_dv, dk_du: (elems,) = (n_batch, NWAVE, NLAY, NG); a, b, c:
// (n_tan, n_batch, NLAY); out: (n_tan, elems).
extern "C" int gas_tau_tangent_f32(const void* k, const void* dk_dv,
                                   const void* dk_du, const void* a,
                                   const void* b, const void* c, void* out,
                                   int64_t elems, int nlay, int ng,
                                   int n_batch, int n_tan, int device,
                                   void* stream) {
  return launch_gas_tau_tangent<float>(k, dk_dv, dk_du, a, b, c, out, elems,
                                       nlay, ng, n_batch, n_tan, device,
                                       stream);
}

extern "C" int gas_tau_tangent_f64(const void* k, const void* dk_dv,
                                   const void* dk_du, const void* a,
                                   const void* b, const void* c, void* out,
                                   int64_t elems, int nlay, int ng,
                                   int n_batch, int n_tan, int device,
                                   void* stream) {
  return launch_gas_tau_tangent<double>(k, dk_dv, dk_du, a, b, c, out, elems,
                                        nlay, ng, n_batch, n_tan, device,
                                       stream);
}

// dout, da, db: (n_tan, rows, ng); skip_a, skip_b: (rows,) bytes, 0 or 1.
extern "C" int skip_rows_f32(void* dout, const void* da, const void* db,
                             const void* skip_a, const void* skip_b,
                             int rows, int ng, int n_tan, int device,
                             void* stream) {
  return launch_skip_rows<float>(dout, da, db, skip_a, skip_b, rows, ng,
                                 n_tan, device, stream);
}

extern "C" int skip_rows_f64(void* dout, const void* da, const void* db,
                             const void* skip_a, const void* skip_b,
                             int rows, int ng, int n_tan, int device,
                             void* stream) {
  return launch_skip_rows<double>(dout, da, db, skip_a, skip_b, rows, ng,
                                  n_tan, device, stream);
}
