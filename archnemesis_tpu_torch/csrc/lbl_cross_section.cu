// Line-by-line cross-section synthesis k(NWAVE, NLAY), for Hopper (sm_90a).
//
// Replaces the TPU kernel lbl_cross_section_pallas
// (archnemesis_tpu/ops/lbl_pallas.py:228, body _lbl_kernel :96, driven by
// _lbl_pallas_impl :173; the same body serves the shard twin
// lbl_cross_section_pallas_packed :312). It computes the same function as
// the plain PyTorch version in archnemesis_tpu_torch/ops/lbl.py
// (lbl_cross_section_plain), the reference's add_line_set_monochromatic_
// spectrum (LineData_0.py:229):
//   for each layer l and line i: S = sw (stim(T)/stim_ref) exp(c2 E" (T -
//   Tref)/(T Tref)) Q(Tref)/Q(T) (zero below s_floor), the Doppler HWHM
//   alpha_d = D nu sqrt(T/m), the Lorentz HWHM gamma_l = (Tref/T)^n_self
//   g_self (1 - amb) + (Tref/T)^n_amb g_amb amb) p/pref and the pressure
//   shift p/pref d_amb amb;
//   for each wave w: k[w, l] = factor * sum_i S_i g_i(w), with delta =
//   w - (nu_i + shift_i) and g_i the lineshape inside |delta| < wn_calc,
//   f_i(wn_calc) wn_calc^2 / delta^2 out to wn_approx and 0 beyond.
// In float32 delta is formed from two-float parts, (wn_hi - nu_hi) +
// (wn_lo - nu_lo) - shift: the hi parts subtract exactly near a line
// centre, where a plain float32 difference of two ~2e3 cm-1 numbers would
// lose the ~1e-3 cm-1 delta. In float64 it is wn - (nu + shift), the
// reference's association. The Voigt function is the Weideman-24 rational
// expansion of Re w(z); in float32 a 6-convergent continued fraction
// replaces it where |z|^2 > 49, where the expansion cancels its O(1) terms
// down to a ~y/|z|^2 result (a per-element branch: only the taken side is
// evaluated). Q(Tref)/Q(T), one interpolation per layer, comes in with the
// layer's T, p and ambient fraction.
//
// What bounds it on the card: operations. The line and wave columns and the
// output are ~13 MB at the full-width configuration (80,000 waves, 5,092
// lines, 40 layers), a few microseconds at the HBM rate, while the
// function needs a lineshape for each of ~1.9e8 (line, wave) pairs per
// layer inside the 25 cm-1 core window (~80 float32 operations each where
// the continued fraction applies, ~190 for the Weideman expansion) and a
// few operations for each of ~2.0e8 wing pairs (chip_smoke.py:
// lbl_bound_ms counts them from the run's inputs). The design spends
// nothing on memory and keeps the arithmetic to what one pair needs:
//   - one block per (wave block of W waves, layer), one thread per wave,
//     its running sum in a register; blocks read their own exact line
//     range [starts[b], starts[b] + counts[b]) from build_blocks (no
//     padding to a chunk size);
//   - the range is walked in tiles of W lines: the block's threads compute
//     each line's per-(layer, line) physics once into shared memory (delta
//     parts, the lineshape's two per-line parameters, the wing value
//     f(wn_calc) wn_calc^2 and the weighted strength), then every thread
//     runs over the tile against its own wave, reading the line's values
//     as shared-memory broadcasts;
//   - a line whose weighted strength is zero is skipped by the whole
//     block, a pair outside the 75 cm-1 window costs a compare, and a
//     wing pair a division;
//   - sums run in line order, without atomics: the result is
//     deterministic.
// No fast-math: expf, powf and the divisions stay IEEE (float64 results
// agree with the plain version to ~1e-15, float32 ones with float64 within
// the float32 bound).

#include <cuda_runtime.h>
#include <math.h>

namespace {

// float64 values of ops/voigt.py's constants (repr, so exact)
constexpr double kSqrtLog2 = 0.8325546111576977;
constexpr double kInvSqrtPi = 0.5641895835477563;
constexpr double kInvSqrt2Pi = 0.39894228040143265;
constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kL24 = 4.119534287814235;
constexpr double kSqrt2Log2 = 1.1774100225154747;  // sqrt(2 ln 2)
constexpr double kSqrt2Pi = 2.5066282746310002;
constexpr double kPi = 3.141592653589793;
constexpr double kAsymR2 = 49.0;

// Weideman (1994) N=24 coefficients a0..a24 (ops/voigt.py A24)
#define A24_VALUES                                                         \
  2.3241983342526162e+00, 2.1978589365315417e+00, 1.8562864992055408e+00, \
      1.3948196733791203e+00, 9.2570871385886788e-01,                      \
      5.3611395357291292e-01, 2.6549639598807689e-01,                      \
      1.0838723484566792e-01, 3.3723366855316413e-02,                      \
      6.2150063629501763e-03, -4.9364269012806686e-04,                     \
      -7.8166429956142650e-04, -2.0748431511424456e-04,                    \
      2.4331415462641969e-05, 3.0471066083243790e-05,                      \
      4.1394617248575527e-06, -3.0388931839840047e-06,                     \
      -1.0856475790698251e-06, 2.5682641346701115e-07,                     \
      1.8738343486619108e-07, -1.9122258522976932e-08,                     \
      -3.0082822811202271e-08, 1.3310461806370372e-09,                     \
      4.9048215867870488e-09, -1.5137461654527820e-10

__constant__ float kA24f[25] = {A24_VALUES};
__constant__ double kA24d[25] = {A24_VALUES};
#undef A24_VALUES

template <typename T>
__device__ __forceinline__ T a24(int k);
template <>
__device__ __forceinline__ float a24<float>(int k) {
  return kA24f[k];
}
template <>
__device__ __forceinline__ double a24<double>(int k) {
  return kA24d[k];
}

// lineshape ids: the order of ops/voigt.py LINESHAPES
enum Shape {
  kVoigt = 0,
  kGaussian = 1,
  kLorentz = 2,
  kTonkov = 3,
  kHartmann = 4,
  kVoigtCh4H2 = 5,
};

// line-parameter columns of the packed (10, N) input
enum Column {
  kNuHi = 0,
  kNuLo = 1,
  kSw = 2,
  kElower = 3,
  kStimRef = 4,
  kGammaSelf = 5,
  kNSelf = 6,
  kGammaAmb = 7,
  kNAmb = 8,
  kDeltaAmb = 9,
  kColumns = 10,
};

// per-line values a tile keeps in shared memory
constexpr int kTileArrays = 7;

struct Params {
  double t_ref, p_ref, mass, s_floor, wn_calc, wn_approx, factor, c2,
      doppler;
};

// Re w(z), Weideman-24 (the operations of voigt.complex_err_fn_weideman24)
template <typename T>
__device__ __forceinline__ T weideman24_re(T zr, T zi) {
  const T lp_r = T(kL24) - zi;
  const T lp_i = zr;
  const T lm_r = T(kL24) + zi;
  const T lm_i = -zr;
  const T mag = lm_r * lm_r + lm_i * lm_i;
  const T inv_r = lm_r / mag;
  const T inv_i = -lm_i / mag;
  const T zz_r = lp_r * inv_r - lp_i * inv_i;
  const T zz_i = lp_r * inv_i + lp_i * inv_r;
  T p_r = a24<T>(24);
  T p_i = T(0);
#pragma unroll
  for (int k = 23; k >= 1; --k) {
    const T t_r = p_r * zz_r - p_i * zz_i;
    const T t_i = p_r * zz_i + p_i * zz_r;
    p_r = t_r + a24<T>(k);
    p_i = t_i;
  }
  T x_r = p_r * inv_r - p_i * inv_i;
  const T x_i = T(2) * (p_r * inv_i + p_i * inv_r);
  x_r = T(kInvSqrtPi) + T(2) * x_r;
  return x_r * inv_r - x_i * inv_i;
}

// Re w(z), 6-convergent continued fraction (voigt._cpf_continued_fraction)
__device__ __forceinline__ float cf_re(float zr, float zi) {
  constexpr float c[6] = {3.0f, 2.5f, 2.0f, 1.5f, 1.0f, 0.5f};
  float d_r = zr;
  float d_i = zi;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float r = 1.0f / (d_r * d_r + d_i * d_i);
    d_r = zr - c[k] * d_r * r;
    d_i = zi + c[k] * d_i * r;
  }
  return float(kInvSqrtPi) * d_i / (d_r * d_r + d_i * d_i);
}

template <typename T>
__device__ __forceinline__ T w_re(T x, T y) {
  if constexpr (sizeof(T) == 4) {
    if (x * x + y * y > T(kAsymR2)) return cf_re(x, y);
  }
  return weideman24_re(x, y);
}

template <typename T>
__device__ __forceinline__ T chi_tonkov(T ad) {
  if (ad < T(3.0)) return T(1.0);
  if (ad < T(150.0)) return T(1.084) * exp(T(-0.027) * ad);
  if (ad < T(300.0)) return T(0.208) * exp(T(-0.016) * ad);
  return T(0.025) * exp(T(-0.009) * ad);
}

template <typename T>
__device__ __forceinline__ T chi_hartmann(T ad) {
  if (ad < T(26.0)) return T(1.0);
  if (ad < T(60.0)) return T(8.72) * exp(-ad / T(12.0));
  return T(0.0684) * exp(-ad / T(393.0));
}

// The two per-line parameters of a lineshape: Voigt family (scale, y),
// Gaussian (sigma, sigma sqrt(2 pi)), Lorentz (gamma, gamma^2).
template <typename T, int SHAPE>
__device__ __forceinline__ void shape_params(T alpha_d, T gamma_l, T& p0,
                                             T& p1) {
  if constexpr (SHAPE == kGaussian) {
    const T sigma = alpha_d / T(kSqrt2Log2);
    p0 = sigma;
    p1 = sigma * T(kSqrt2Pi);
  } else if constexpr (SHAPE == kLorentz) {
    p0 = gamma_l;
    p1 = gamma_l * gamma_l;
  } else {
    if constexpr (SHAPE == kVoigtCh4H2) {
      alpha_d = alpha_d / T(kSqrt2);
      gamma_l = gamma_l / T(kSqrt2);
    }
    const T scale = T(kSqrtLog2) / alpha_d;
    p0 = scale;
    p1 = gamma_l * scale;
  }
}

// The lineshape at delta from its per-line parameters.
template <typename T, int SHAPE>
__device__ __forceinline__ T shape_value(T delta, T p0, T p1) {
  if constexpr (SHAPE == kGaussian) {
    const T r = delta / p0;
    return exp(T(-0.5) * (r * r)) / p1;
  } else if constexpr (SHAPE == kLorentz) {
    return p0 / (T(kPi) * (p1 + delta * delta));
  } else {
    const T v = w_re<T>(delta * p0, p1) * p0 * T(kInvSqrt2Pi) * T(kSqrt2);
    if constexpr (SHAPE == kTonkov) return chi_tonkov(fabs(delta)) * v;
    if constexpr (SHAPE == kHartmann) return chi_hartmann(fabs(delta)) * v;
    return v;
  }
}

// grid (n_blocks, nlay), one thread per wave of the block (blockDim.x = W)
template <typename T, int SHAPE, bool TWOFLOAT>
__global__ void lbl_kernel(const T* __restrict__ cols, int n_lines,
                           const T* __restrict__ wn,
                           const int* __restrict__ ranges,
                           const T* __restrict__ lay, T* __restrict__ out,
                           int nb, int n_wave, int nlay, Params prm) {
  extern __shared__ unsigned char smem_raw[];
  const int width = blockDim.x;
  T* s_c0 = reinterpret_cast<T*>(smem_raw);  // nu_hi (f32) / nu + shift
  T* s_c1 = s_c0 + width;                    // nu_lo (two-float)
  T* s_c2 = s_c1 + width;                    // shift (two-float)
  T* s_p0 = s_c2 + width;                    // lineshape parameters
  T* s_p1 = s_p0 + width;
  T* s_wing = s_p1 + width;  // f(wn_calc) wn_calc^2
  T* s_s = s_wing + width;   // strength, 0 below s_floor

  const int b = blockIdx.x;
  const int l = blockIdx.y;
  const int tid = threadIdx.x;
  const int iw = b * width + tid;

  // per-layer factors, formed as the plain version forms them
  const T t = lay[4 * l];
  const T p = lay[4 * l + 1];
  const T amb = lay[4 * l + 2];
  const T q_ratio = lay[4 * l + 3];
  const T t_ref = T(prm.t_ref);
  const T c_boltz = T(prm.c2) * (t - t_ref) / (t * t_ref);
  const T neg_c2 = T(-prm.c2);
  const T sqrt_tm = sqrt(t / T(prm.mass));
  const T t_ratio = t_ref / t;
  const T p_ratio = p / T(prm.p_ref);
  const T f_self = T(1.0) - amb;
  const T wc = T(prm.wn_calc);
  const T wa = T(prm.wn_approx);
  const T wc2 = T(prm.wn_calc * prm.wn_calc);
  const T s_floor = T(prm.s_floor);

  const T wn_hi = wn[iw];
  const T wn_lo = TWOFLOAT ? wn[nb * width + iw] : T(0);
  const int start = ranges[b];
  const int count = ranges[nb + b];

  T acc = T(0);
  for (int base = 0; base < count; base += width) {
    const int n_tile = min(width, count - base);
    if (tid < n_tile) {
      const int i = start + base + tid;
      const T nu = cols[kNuHi * n_lines + i];
      const T boltz = exp(c_boltz * cols[kElower * n_lines + i]);
      const T stim = T(1.0) - exp(neg_c2 * nu / t);
      const T s = cols[kSw * n_lines + i] *
                  (stim / cols[kStimRef * n_lines + i]) * boltz * q_ratio;
      const T alpha_d = T(prm.doppler) * nu * sqrt_tm;
      const T gamma_l =
          (pow(t_ratio, cols[kNSelf * n_lines + i]) *
               cols[kGammaSelf * n_lines + i] * f_self +
           pow(t_ratio, cols[kNAmb * n_lines + i]) *
               cols[kGammaAmb * n_lines + i] * amb) *
          p_ratio;
      const T shift = p_ratio * cols[kDeltaAmb * n_lines + i] * amb;
      T p0, p1;
      shape_params<T, SHAPE>(alpha_d, gamma_l, p0, p1);
      if (TWOFLOAT) {
        s_c0[tid] = nu;
        s_c1[tid] = cols[kNuLo * n_lines + i];
        s_c2[tid] = shift;
      } else {
        s_c0[tid] = nu + shift;
      }
      s_p0[tid] = p0;
      s_p1[tid] = p1;
      s_wing[tid] = shape_value<T, SHAPE>(wc, p0, p1) * wc2;
      s_s[tid] = s >= s_floor ? s : T(0);
    }
    __syncthreads();
    for (int j = 0; j < n_tile; ++j) {
      const T s = s_s[j];
      if (s == T(0)) continue;  // the same for every thread of the block
      const T delta = TWOFLOAT
                          ? ((wn_hi - s_c0[j]) + (wn_lo - s_c1[j])) - s_c2[j]
                          : wn_hi - s_c0[j];
      if (!(delta >= -wa && delta < wa)) continue;
      const T v = (delta >= -wc && delta < wc)
                      ? shape_value<T, SHAPE>(delta, s_p0[j], s_p1[j])
                      : s_wing[j] / (delta * delta);
      acc += v * s;
    }
    __syncthreads();
  }
  if (iw < n_wave) out[static_cast<size_t>(iw) * nlay + l] = acc * T(prm.factor);
}

template <typename T, int SHAPE, bool TWOFLOAT>
cudaError_t launch_one(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                       const T* cols, int n_lines, const T* wn,
                       const int* ranges, const T* lay, T* out, int nb,
                       int n_wave, int nlay, const Params& prm) {
  lbl_kernel<T, SHAPE, TWOFLOAT><<<grid, block, smem, s>>>(
      cols, n_lines, wn, ranges, lay, out, nb, n_wave, nlay, prm);
  return cudaGetLastError();
}

template <typename T, bool TWOFLOAT>
int launch(const void* cols, const void* wn, const void* ranges,
           const void* lay, void* out, int n_lines, int nb, int width,
           int n_wave, int nlay, int shape, const Params& prm, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb <= 0 || nlay <= 0) return 0;
  const dim3 grid(nb, nlay);
  const dim3 block(width);
  const size_t smem = kTileArrays * width * sizeof(T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pc = static_cast<const T*>(cols);
  const T* pw = static_cast<const T*>(wn);
  const int* pr = static_cast<const int*>(ranges);
  const T* pl = static_cast<const T*>(lay);
  T* po = static_cast<T*>(out);
#define LAUNCH_CASE(SHAPE)                                                  \
  case SHAPE:                                                               \
    err = launch_one<T, SHAPE, TWOFLOAT>(grid, block, smem, s, pc, n_lines, \
                                         pw, pr, pl, po, nb, n_wave, nlay,  \
                                         prm);                              \
    break;
  switch (shape) {
    LAUNCH_CASE(kVoigt)
    LAUNCH_CASE(kGaussian)
    LAUNCH_CASE(kLorentz)
    LAUNCH_CASE(kTonkov)
    LAUNCH_CASE(kHartmann)
    LAUNCH_CASE(kVoigtCh4H2)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_CASE
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (bound with ctypes). cols (10, n_lines): nu_hi,
// nu_lo, sw (the isotope factor NOT folded in), elower, stim_ref, g_self,
// n_self, g_amb, n_amb, d_amb (zeros without the pressure shift); wn (2,
// nb * width): the wave grid's hi and lo parts (lo zero and unread unless
// twofloat); ranges (2, nb) int32: starts, counts; lay (nlay, 4): T, p
// [atm], ambient fraction, Q(Tref)/Q(T); out (n_wave, nlay). Each launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after
// the launch.
extern "C" int lbl_cross_section_f32(
    const void* cols, const void* wn, const void* ranges, const void* lay,
    void* out, int n_lines, int nb, int width, int n_wave, int nlay,
    int shape, int twofloat, double t_ref, double p_ref, double mass,
    double s_floor, double wn_calc, double wn_approx, double factor,
    double c2, double doppler, int device, void* stream) {
  const Params prm{t_ref,   p_ref,     mass,   s_floor, wn_calc,
                   wn_approx, factor, c2,     doppler};
  if (twofloat)
    return launch<float, true>(cols, wn, ranges, lay, out, n_lines, nb,
                               width, n_wave, nlay, shape, prm, device,
                               stream);
  return launch<float, false>(cols, wn, ranges, lay, out, n_lines, nb, width,
                              n_wave, nlay, shape, prm, device, stream);
}

extern "C" int lbl_cross_section_f64(
    const void* cols, const void* wn, const void* ranges, const void* lay,
    void* out, int n_lines, int nb, int width, int n_wave, int nlay,
    int shape, int twofloat, double t_ref, double p_ref, double mass,
    double s_floor, double wn_calc, double wn_approx, double factor,
    double c2, double doppler, int device, void* stream) {
  const Params prm{t_ref,   p_ref,     mass,   s_floor, wn_calc,
                   wn_approx, factor, c2,     doppler};
  if (twofloat) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double, false>(cols, wn, ranges, lay, out, n_lines, nb,
                               width, n_wave, nlay, shape, prm, device,
                               stream);
}
