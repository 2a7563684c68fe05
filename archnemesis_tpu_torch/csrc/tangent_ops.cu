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
// emission_tangent: the forward-mode tangent of the thermal emission along
//   paths and its g-integration (forward.py:path_spectrum's thermal branch),
//   for all T tangents at once. The spectrum of path p at wave w,
//     y = sum_g dg_g [sum_i (tr_{i-1} - tr_i) B_i + tr_{N-1} G],
//   tr_i = exp(-D_i), D_i the running sum of tau_i = tautot[w, g, l_i] s_i m_i
//   along the path (l_i its layer, s_i its scale, m_i its mask, B_i the
//   masked Planck radiance, G the ground's), is linear in its tangents:
//     dy = sum_{g,i} K_gi dtau_gi + sum_i P_i dT_i + (sum_g dg_g tr_{N-1}) dG,
//   with K_gi = dg_g tr_i (B_i - R_i), R_{N-1} = G and
//   R_{i-1} = exp(-tau_i) R_i - expm1(-tau_i) B_i (the radiance behind layer
//   i as seen from it: a weighted mean, so no difference of two running sums
//   loses the deep layers' small values), and P_i = sum_g dg_g
//   (tr_{i-1} - tr_i) dB_i/dT. Phase A (one warp a path, a lane a g) runs the
//   two recurrences on the primal of one wave and scatters K into a
//   (layer, g) matrix M of the wave in shared memory (with the scale's and
//   the temperatures' coefficients beside it); phase B streams the tangents:
//   each warp takes a tangent, reads its (NLAY x NG) slab of the optical-
//   depth tangent once (16-byte streaming loads where the slab is
//   contiguous, g fastest, as the random overlap leaves it) and dots it with
//   M. What bounds it: that tangent, T x NWAVE x NLAY x NG values read once:
//   4.0 GB at the Jacobian cell's shape, 1.2 ms at 3.35 TB/s. PyTorch's
//   forward-mode rules of the same ops (the gather, the cumulative sum, the
//   exponentials, the products, the two contractions) made some 25 passes
//   over tangents of that size. Replaces no TPU kernel: under jax.jacfwd
//   XLA fuses these passes; eager PyTorch does not.
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

// ---- emission_tangent

constexpr int kEmWarps = 4;      // warps a block
constexpr int kEmMinBlocks = 5;  // blocks an SM keeps resident (registers)
constexpr int kEmMaxPaths = 4;   // paths a block holds, one accumulator each
constexpr int kEmPrefetch = 10;  // 16-byte loads a lane has in flight
constexpr int kEmMaxShared = 227 * 1024;

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ float dot(float4 x, float4 m, float acc) {
    acc = fmaf(x.x, m.x, acc);
    acc = fmaf(x.y, m.y, acc);
    acc = fmaf(x.z, m.z, acc);
    return fmaf(x.w, m.w, acc);
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ double dot(double2 x, double2 m,
                                               double acc) {
    acc = fma(x.x, m.x, acc);
    return fma(x.y, m.y, acc);
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // a butterfly: every lane ends with the same sum, in a fixed order
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The Planck radiance (ops/planck.py, NEMESIS' constants) and its slope in
// temperature at one wave.
template <typename T>
__device__ __forceinline__ void planck_slope(T wave, T temp, int ispace,
                                             T* b, T* db) {
  const T c1 = static_cast<T>(1.1911e-12), c2 = static_cast<T>(1.439);
  T y, a;
  if (ispace == 0) {
    y = wave;
    a = c1 * y * y * y;
  } else {
    y = static_cast<T>(1.0e4) / wave;
    a = c1 * y * y * y * y * y / static_cast<T>(1.0e4);
  }
  const T x = c2 * y / temp;
  *b = a / (exp(x) - T(1));
  *db = *b * (x / temp) / (-expm1(-x));
}

struct EmissionArgs {
  const void* tau;      // (B, NWAVE, NG, NLAY), strides ts
  const void* dtau;     // (T, B, NWAVE, NG, NLAY), strides ds; or null
  const int64_t* layinc;  // (NLAYIN, NPATH)
  const int64_t* loc;     // (NPATH / group,) index into B; or null (0)
  const void* scale;    // (NLAYIN, NPATH)
  const void* mask;     // (NLAYIN, NPATH)
  const void* emtemp;   // (NLAYIN, NPATH)
  const void* ground;   // (NWAVE, NPATH) ground radiance; or null (none)
  const void* wave;     // (NWAVE,)
  const void* del_g;    // (NG,)
  const void* dscale;   // (T, NLAYIN, NPATH); or null
  const void* demtemp;  // (T, NLAYIN, NPATH); or null
  const void* dground;  // (T, NWAVE, NPATH); or null
  void* out;            // (T, NWAVE, NPATH)
  int64_t ts[4];
  int64_t ds[5];
  int n_tan, nwave, ng, nlay, nlayin, npath, group, ispace;
  int chunk, chunks, awarps;
  bool vec;  // each (T, B, wave) slab contiguous, g fastest, on 16 bytes
};

// The block's shared memory, in this order: M (16-byte aligned at the
// start, for the vector reads), the wave's primal slab of tau, two
// (NLAYIN, NG) scratch rows a phase-A warp, the per-(path, layer) rows,
// the ground coefficients, and the layers' indices.
template <typename T>
struct EmissionShared {
  T* m;     // [chunk][NLAY][NG]: the coefficients of dtau
  T* slab;  // [NLAY][NG]: tau of the block's location and wave
  T* u;     // [awarps][NLAYIN][NG]: B_i - R_i, then the scale's terms
  T* v;     // [awarps][NLAYIN][NG]: the temperature's terms
  T* bm;    // [chunk][NLAYIN] each: masked Planck radiance, its slope,
  T* dbm;   //   the temperatures' and the scale's coefficients, the
  T* pb;    //   scale and the mask
  T* qs;
  T* scale;
  T* mask;
  T* gs;    // [chunk]: the ground's coefficient
  int* lay; // [chunk][NLAYIN]: layers

  __device__ EmissionShared(unsigned char* raw, int chunk, int awarps,
                            int ng, int nlay, int nlayin) {
    m = reinterpret_cast<T*>(raw);
    slab = m + chunk * ng * nlay;
    u = slab + ng * nlay;
    v = u + awarps * nlayin * ng;
    bm = v + awarps * nlayin * ng;
    dbm = bm + chunk * nlayin;
    pb = dbm + chunk * nlayin;
    qs = pb + chunk * nlayin;
    scale = qs + chunk * nlayin;
    mask = scale + chunk * nlayin;
    gs = mask + chunk * nlayin;
    lay = reinterpret_cast<int*>(gs + chunk);
  }
};

template <typename T>
size_t emission_shared_bytes(int chunk, int awarps, int ng, int nlay,
                             int nlayin) {
  const size_t gl = static_cast<size_t>(ng) * nlay;
  const size_t rows = static_cast<size_t>(chunk) * nlayin;
  return sizeof(T) * ((chunk + 1) * gl +
                      2 * static_cast<size_t>(awarps) * nlayin * ng +
                      6 * rows + chunk) +
         sizeof(int) * rows;
}

// Phase A for one path (a warp, lane g): R backward, then tr forward; the
// terms of the scale and of the temperatures summed over g afterwards, in
// a fixed order.
template <typename T>
__device__ void emission_path_primal(const EmissionArgs& A,
                                     const EmissionShared<T>& S, T* u, T* v,
                                     int w, int p, int pp) {
  const int lane = threadIdx.x & 31;
  const int ng = A.ng, nlayin = A.nlayin;
  const bool on = lane < ng;
  const int g = on ? lane : 0;
  const T dg = on ? static_cast<const T*>(A.del_g)[lane] : T(0);
  const T* b = S.bm + pp * nlayin;
  const T* scale = S.scale + pp * nlayin;
  const T* mask = S.mask + pp * nlayin;
  const int* lay = S.lay + pp * nlayin;
  // backward: u_i = B_i - R_i
  T r = A.ground ? static_cast<const T*>(A.ground)[
                       static_cast<int64_t>(w) * A.npath + p]
                 : T(0);
  // (the exponentials lie off the recurrences' chains, which are one
  // multiply-add and one add a layer: unrolled, they overlap)
#pragma unroll 4
  for (int i = nlayin - 1; i >= 0; --i) {
    const T t = S.slab[lay[i] * ng + g] * scale[i] * mask[i];
    const T a = -expm1(-t);
    if (on) {
      u[i * ng + lane] = b[i] - r;
      v[i * ng + lane] = a;
    }
    r = exp(-t) * r + a * b[i];
  }
  // forward: tr_i, the coefficients of dtau, of the scale and of dB
  T d = 0, trm = 1;
#pragma unroll 4
  for (int i = 0; i < nlayin; ++i) {
    const T s = scale[i], mk = mask[i];
    const T raw = S.slab[lay[i] * ng + g];
    d += raw * s * mk;
    const T tr = exp(-d);
    if (on) {
      const T kd = dg * tr * u[i * ng + lane];
      S.m[(pp * A.nlay + lay[i]) * ng + lane] += kd * (s * mk);
      u[i * ng + lane] = kd * raw * mk;
      v[i * ng + lane] = dg * trm * v[i * ng + lane];
    }
    trm = tr;
  }
  const T gsum = warp_sum(dg * trm);
  if (lane == 0) S.gs[pp] = gsum;
  __syncwarp();
  for (int i = lane; i < nlayin; i += 32) {
    T q = 0, pv = 0;
#pragma unroll 4
    for (int k = 0; k < ng; ++k) {
      q += u[i * ng + k];
      pv += v[i * ng + k];
    }
    S.qs[pp * nlayin + i] = q;
    S.pb[pp * nlayin + i] = pv * S.dbm[pp * nlayin + i];
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kEmWarps * 32, kEmMinBlocks)
    emission_tangent_kernel(const EmissionArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ng = A.ng, nlay = A.nlay, nlayin = A.nlayin, npath = A.npath;
  const int gl = ng * nlay;
  const int w = blockIdx.x;
  const int grp = blockIdx.y / A.chunks;
  const int p0 = grp * A.group + (blockIdx.y % A.chunks) * A.chunk;
  const int np = min(A.chunk, (grp + 1) * A.group - p0);
  const int64_t loc = A.loc ? A.loc[grp] : 0;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const EmissionShared<T> S(smem_raw, A.chunk, A.awarps, ng, nlay, nlayin);

  // phase 0: M zeroed; the wave's tau and the paths' rows staged; the
  // masked Planck radiances and slopes
  for (int e = threadIdx.x; e < np * gl; e += blockDim.x) S.m[e] = T(0);
  const T* tau = static_cast<const T*>(A.tau) + loc * A.ts[0] +
                 static_cast<int64_t>(w) * A.ts[1];
  for (int e = threadIdx.x; e < gl; e += blockDim.x) {
    S.slab[e] = tau[(e % ng) * A.ts[2] + static_cast<int64_t>(e / ng) *
                                             A.ts[3]];
  }
  const T wv = static_cast<const T*>(A.wave)[w];
  for (int e = threadIdx.x; e < np * nlayin; e += blockDim.x) {
    const int pp = e / nlayin, i = e % nlayin;
    const int64_t k = static_cast<int64_t>(i) * npath + p0 + pp;
    const T mk = static_cast<const T*>(A.mask)[k];
    T b = 0, db = 0;
    if (mk != T(0)) {
      planck_slope(wv, static_cast<const T*>(A.emtemp)[k], A.ispace, &b,
                   &db);
    }
    S.bm[e] = b * mk;
    S.dbm[e] = db * mk;
    S.scale[e] = static_cast<const T*>(A.scale)[k];
    S.mask[e] = mk;
    S.lay[e] = static_cast<int>(A.layinc[k]);
  }
  __syncthreads();
  // phase A: the primal recurrences, a warp a path
  if (wid < A.awarps) {
    T* u = S.u + wid * nlayin * ng;
    T* v = S.v + wid * nlayin * ng;
    for (int pp = wid; pp < np; pp += A.awarps) {
      emission_path_primal<T>(A, S, u, v, w, p0 + pp, pp);
    }
  }
  __syncthreads();
  // phase B: each warp streams tangents
  const T* dtau = static_cast<const T*>(A.dtau);
  const T* dscale = static_cast<const T*>(A.dscale);
  const T* demtemp = static_cast<const T*>(A.demtemp);
  const T* dground = static_cast<const T*>(A.dground);
  T* out = static_cast<T*>(A.out);
  for (int t = wid; t < A.n_tan; t += kEmWarps) {
    T acc[kEmMaxPaths];
#pragma unroll
    for (int j = 0; j < kEmMaxPaths; ++j) acc[j] = T(0);
    const T* slab = dtau == nullptr ? nullptr
                                    : dtau + t * A.ds[0] + loc * A.ds[1] +
                                          static_cast<int64_t>(w) * A.ds[2];
    using V = typename Vec16<T>::type;
    const V* sv = reinterpret_cast<const V*>(slab);
    const int nv = A.vec ? gl / Vec16<T>::n : 0;
    // the slab's first kEmPrefetch vectors a lane, all in flight at once
    V x[kEmPrefetch];
#pragma unroll
    for (int k = 0; k < kEmPrefetch; ++k) {
      const int e = k * 32 + lane;
      if (e < nv) x[k] = __ldcs(sv + e);
    }
    // meanwhile, the scale's and the temperatures' terms
    if (dscale || demtemp) {
#pragma unroll 4
      for (int i = lane; i < nlayin; i += 32) {
        const int64_t k = (static_cast<int64_t>(t) * nlayin + i) * npath + p0;
#pragma unroll
        for (int j = 0; j < kEmMaxPaths; ++j) {
          if (j < np) {
            if (dscale) {
              acc[j] = fma(dscale[k + j], S.qs[j * nlayin + i], acc[j]);
            }
            if (demtemp) {
              acc[j] = fma(demtemp[k + j], S.pb[j * nlayin + i], acc[j]);
            }
          }
        }
      }
    }
    if (A.vec) {
#pragma unroll
      for (int k = 0; k < kEmPrefetch; ++k) {
        const int e = k * 32 + lane;
        if (e < nv) {
#pragma unroll
          for (int j = 0; j < kEmMaxPaths; ++j) {
            if (j < np) {
              acc[j] = Vec16<T>::dot(
                  x[k], reinterpret_cast<const V*>(S.m + j * gl)[e], acc[j]);
            }
          }
        }
      }
      // a longer slab: the rest
      for (int e = kEmPrefetch * 32 + lane; e < nv; e += 32) {
        const V y = __ldcs(sv + e);
#pragma unroll
        for (int j = 0; j < kEmMaxPaths; ++j) {
          if (j < np) {
            acc[j] = Vec16<T>::dot(
                y, reinterpret_cast<const V*>(S.m + j * gl)[e], acc[j]);
          }
        }
      }
    } else if (slab != nullptr) {
      for (int e = lane; e < gl; e += 32) {
        const T y = __ldcs(slab + (e % ng) * A.ds[3] +
                           static_cast<int64_t>(e / ng) * A.ds[4]);
#pragma unroll
        for (int j = 0; j < kEmMaxPaths; ++j) {
          if (j < np) acc[j] = fma(y, S.m[j * gl + e], acc[j]);
        }
      }
    }
    const int64_t o = (static_cast<int64_t>(t) * A.nwave + w) * npath + p0;
    if (dground && lane == 0) {
#pragma unroll
      for (int j = 0; j < kEmMaxPaths; ++j) {
        if (j < np) acc[j] = fma(dground[o + j], S.gs[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kEmMaxPaths; ++j) {
      if (j < np) {
        const T sum = warp_sum(acc[j]);
        if (lane == 0) out[o + j] = sum;
      }
    }
  }
}

template <typename T>
int launch_emission_tangent(const void* const* ptrs, const int64_t* ints,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  EmissionArgs A{};
  A.tau = ptrs[0];
  A.dtau = ptrs[1];
  A.layinc = static_cast<const int64_t*>(ptrs[2]);
  A.loc = static_cast<const int64_t*>(ptrs[3]);
  A.scale = ptrs[4];
  A.mask = ptrs[5];
  A.emtemp = ptrs[6];
  A.ground = ptrs[7];
  A.wave = ptrs[8];
  A.del_g = ptrs[9];
  A.dscale = ptrs[10];
  A.demtemp = ptrs[11];
  A.dground = ptrs[12];
  A.out = const_cast<void*>(ptrs[13]);
  const int64_t n_tan = ints[0], nwave = ints[1], ng = ints[2],
                nlay = ints[3], nlayin = ints[4], npath = ints[5],
                group = ints[6];
  for (int i = 0; i < 4; ++i) A.ts[i] = ints[8 + i];
  for (int i = 0; i < 5; ++i) A.ds[i] = ints[12 + i];
  if (n_tan <= 0 || nwave <= 0 || npath <= 0) return 0;
  if (ng < 1 || ng > 32 || nlay < 1 || nlayin < 1 || group < 1 ||
      npath % group != 0 || nwave > 0x7fffffff || n_tan > 0x7fffffff ||
      ng * nlay * npath > 0x7fffffff || nlayin * npath > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  A.n_tan = static_cast<int>(n_tan);
  A.nwave = static_cast<int>(nwave);
  A.ng = static_cast<int>(ng);
  A.nlay = static_cast<int>(nlay);
  A.nlayin = static_cast<int>(nlayin);
  A.npath = static_cast<int>(npath);
  A.group = static_cast<int>(group);
  A.ispace = static_cast<int>(ints[7]);
  // the paths a block holds: as many of its group's as shared memory takes
  int chunk = static_cast<int>(group < kEmMaxPaths ? group : kEmMaxPaths);
  auto awarps = [](int c) { return c < kEmWarps ? c : kEmWarps; };
  size_t smem = emission_shared_bytes<T>(chunk, awarps(chunk), A.ng, A.nlay,
                                         A.nlayin);
  while (smem > static_cast<size_t>(kEmMaxShared) && chunk > 1) {
    --chunk;
    smem = emission_shared_bytes<T>(chunk, awarps(chunk), A.ng, A.nlay,
                                    A.nlayin);
  }
  if (smem > static_cast<size_t>(kEmMaxShared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  A.chunk = chunk;
  A.awarps = awarps(chunk);
  A.chunks = static_cast<int>((group + chunk - 1) / chunk);
  const int64_t blocks_y = (npath / group) * A.chunks;
  if (blocks_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte vector loads where every slab of one (tangent, location,
  // wave) is contiguous with g fastest and starts on 16 bytes
  const int vn = Vec16<T>::n;
  A.vec = A.dtau != nullptr && A.ds[3] == 1 && A.ds[4] == ng &&
          reinterpret_cast<uintptr_t>(A.dtau) % 16 == 0 &&
          (ng * nlay) % vn == 0 && A.ds[0] % vn == 0 &&
          A.ds[1] % vn == 0 && A.ds[2] % vn == 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(emission_tangent_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(nwave),
                  static_cast<unsigned>(blocks_y));
  emission_tangent_kernel<T><<<grid, kEmWarps * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(A);
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

// ptrs: the 14 pointers of EmissionArgs in its order (tau, dtau, layinc,
// loc, scale, mask, emtemp, ground, wave, del_g, dscale, demtemp, dground,
// out; null for an absent input); ints: T, NWAVE, NG, NLAY, NLAYIN, NPATH,
// paths a location group, ispace, the 4 strides of tau and the 5 of dtau
// (elements).
extern "C" int emission_tangent_f32(const void* const* ptrs,
                                    const int64_t* ints, int device,
                                    void* stream) {
  return launch_emission_tangent<float>(ptrs, ints, device, stream);
}

extern "C" int emission_tangent_f64(const void* const* ptrs,
                                    const int64_t* ints, int device,
                                    void* stream) {
  return launch_emission_tangent<double>(ptrs, ints, device, stream);
}
