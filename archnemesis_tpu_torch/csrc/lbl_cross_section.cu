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
// expansion of Re w(z); in float32 the 6-convergent continued fraction
// replaces it where |z|^2 > 49 (a per-element branch: only the taken side
// is evaluated). Q(Tref)/Q(T), one interpolation per layer, comes in with
// the layer's T, p and ambient fraction.
//
// What bounds it on the card: operations. The line and wave columns and the
// output are ~13 MB at the full-width configuration (80,000 waves, 5,092
// lines, 40 layers), a few microseconds at the HBM rate, while the
// function needs a lineshape for each of ~1.9e8 (line, wave) pairs per
// layer inside the 25 cm-1 core window and a reciprocal for each of ~2.0e8
// wing pairs (chip_smoke.py:lbl_bound_ms counts them from the run's
// inputs). The design keeps the arithmetic of a pair to what it needs:
//   - pass 1 (line_kernel), one thread per (layer, line): the per-(layer,
//     line) physics once per synthesis, into a 32-byte record (64 in
//     float64) of the centre's parts, the lineshape's two parameters, the
//     strength times the lineshape's normalisation, the wing value
//     f(wn_calc) wn_calc^2 S and S itself (0 below s_floor);
//   - pass 2 (pair_kernel), one block per (block of W waves of
//     build_blocks, layer), V waves per thread (ceil(W / V) threads, the
//     V waves' parts and sums in registers): the block's exact line range
//     [starts[b], starts[b] + counts[b]) is staged in tiles of 128 records
//     through shared memory (two 128-bit loads per record per thread, used
//     for all V waves). The tiles are staged by plain loads: the records
//     are L2-resident and the pass is bound by instruction issue, and a
//     double-buffered cp.async staging (kept as the sweep's ASYNC variant,
//     Voigt only) gives the same bits and took 0.1-3.7 % longer on an
//     H100 in every timed turn;
//   - staging classifies each (block, line) once from the deltas at the
//     block's first and last wave, with a margin of 1e-4 (wn_approx + 1)
//     cm-1 that covers the rounding of delta between them: skip (zero
//     strength, or outside the window for every wave), wing (every wave in
//     wn_calc <= |delta| < wn_approx: delta^2, one reciprocal, one FMA),
//     core (every wave inside |delta| < wn_calc: the lineshape, no window
//     test) or straddle (the per-pair tests). The class is the same for
//     every thread of the block, so no warp diverges on it; a margin case
//     only moves a line to the straddle class, where the pair's own tests
//     decide, so the classes change no pair's result;
//   - float32 Re w(z) for |z|^2 > 49 is the continued fraction's 6th
//     convergent written as a ratio of two polynomials in t = 1/z^2:
//     w = (i/sqrt(pi)) p5(t) / (z p6(t)), p5 = 1 - 10 t + 21.75 t^2 - 6 t^3,
//     p6 = 1 - 10.5 t + 26.25 t^2 - 13.125 t^3 (the forward recurrence
//     P_{k+1} = z P_k - c_k P_{k-1} divided by z^(k+1), so no term
//     overflows at |z| ~ 1e4): two approximate reciprocals (1/|z|^2 and
//     1/|p6|^2, |p6| in [0.78, 1.22]) instead of six IEEE reciprocals and a
//     division; the float32 wing's 1/delta^2 (delta^2 >= wn_calc^2) is one
//     approximate reciprocal. float64 keeps the Weideman expansion and
//     IEEE divisions throughout;
//   - sums run in line order per wave, without atomics: the result is
//     deterministic, and a wave-shard launch gives the unsharded bits.
// No global fast-math: expf, powf and the float64 divisions stay IEEE; the
// only approximate operation is rcp.approx.f32 (1 ulp) in the float32
// continued fraction and wing.

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
};

// A (layer, line) record of pass 1. Two-float: centre nu_hi, nu_lo, shift;
// otherwise nu + shift, 0, 0. Then the lineshape's parameters a, b (Voigt
// family: scale = sqrt(ln 2) / alpha_d and y = gamma_l scale; Gaussian:
// sigma; Lorentz: gamma_l, gamma_l^2), cs = S times the lineshape's
// normalisation, ws = f(wn_calc) wn_calc^2 S, and S (0 below s_floor),
// which staging replaces by the (block, line) class.
enum Field { kC0 = 0, kC1, kC2, kA, kB, kCs, kWs, kS, kFields };

template <typename T>
struct alignas(kFields * sizeof(T)) Rec {
  T v[kFields];
};

// (block, line) classes
constexpr int kSkip = 0, kWing = 1, kCore = 2, kStraddle = 3;
// records per shared-memory tile: 4 KB in float32, 8 KB in float64
constexpr int kTile = 128;
// waves per thread of the pair pass unless the caller asks for another
constexpr int kWavesPerThread = 2;
constexpr int kLineThreads = 128;

struct Params {
  double t_ref, p_ref, mass, s_floor, wn_calc, wn_approx, factor, c2,
      doppler;
};

// 16-byte asynchronous copy from global to shared memory (sm_80 and later)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

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

// (q_r, q_i) <- t q + c, complex t and q, real c
__device__ __forceinline__ void horner_step(float t_r, float t_i, float& q_r,
                                            float& q_i, float c) {
  const float r = fmaf(t_r, q_r, fmaf(-t_i, q_i, c));
  q_i = fmaf(t_r, q_i, t_i * q_r);
  q_r = r;
}

// Re w(z) for |z|^2 = r2 > 49: the 6-convergent continued fraction
// (voigt._cpf_continued_fraction) as (i/sqrt(pi)) p5(t) / (z p6(t)),
// t = 1/z^2 (ops/voigt.py:cf_ratio_re is its plain mirror)
__device__ __forceinline__ float cf_re(float x, float y, float r2) {
  const float r = rcp_approx(r2);
  const float u_r = x * r;  // 1/z
  const float u_i = -y * r;
  const float t_r = fmaf(u_r, u_r, -u_i * u_i);
  const float t_i = 2.0f * u_r * u_i;
  float p5_r = fmaf(-6.0f, t_r, 21.75f), p5_i = -6.0f * t_i;
  float p6_r = fmaf(-13.125f, t_r, 26.25f), p6_i = -13.125f * t_i;
  horner_step(t_r, t_i, p5_r, p5_i, -10.0f);
  horner_step(t_r, t_i, p6_r, p6_i, -10.5f);
  horner_step(t_r, t_i, p5_r, p5_i, 1.0f);
  horner_step(t_r, t_i, p6_r, p6_i, 1.0f);
  const float m_r = fmaf(p5_r, u_r, -p5_i * u_i);  // p5 / z
  const float m_i = fmaf(p5_r, u_i, p5_i * u_r);
  // Re(i m conj(p6)) / |p6|^2
  const float im = fmaf(m_i, p6_r, -m_r * p6_i);
  return -float(kInvSqrtPi) * im *
         rcp_approx(fmaf(p6_r, p6_r, p6_i * p6_i));
}

template <typename T>
__device__ __forceinline__ T w_re(T x, T y) {
  if constexpr (sizeof(T) == 4) {
    const T r2 = x * x + y * y;
    if (r2 > T(kAsymR2)) return cf_re(x, y, r2);
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

// The record's lineshape parameters (a, b) and normalisation from the
// line's widths.
template <typename T, int SHAPE>
__device__ __forceinline__ void shape_params(T alpha_d, T gamma_l, T& a, T& b,
                                             T& norm) {
  if constexpr (SHAPE == kGaussian) {
    a = alpha_d / T(kSqrt2Log2);
    b = a * T(kSqrt2Pi);
    norm = T(1) / b;
  } else if constexpr (SHAPE == kLorentz) {
    a = gamma_l;
    b = gamma_l * gamma_l;
    norm = gamma_l / T(kPi);
  } else {
    if constexpr (SHAPE == kVoigtCh4H2) {
      alpha_d = alpha_d / T(kSqrt2);
      gamma_l = gamma_l / T(kSqrt2);
    }
    a = T(kSqrtLog2) / alpha_d;
    b = gamma_l * a;
    norm = a * T(kInvSqrt2Pi) * T(kSqrt2);
  }
}

// S times the lineshape at delta, from the record's a, b and cs.
template <typename T, int SHAPE>
__device__ __forceinline__ T core_value(T delta, T a, T b, T cs) {
  if constexpr (SHAPE == kGaussian) {
    const T r = delta / a;
    return exp(T(-0.5) * (r * r)) * cs;
  } else if constexpr (SHAPE == kLorentz) {
    return cs / (b + delta * delta);
  } else {
    const T v = w_re<T>(delta * a, b) * cs;
    if constexpr (SHAPE == kTonkov) return chi_tonkov(fabs(delta)) * v;
    if constexpr (SHAPE == kHartmann) return chi_hartmann(fabs(delta)) * v;
    return v;
  }
}

// ws / delta^2 (one approximate reciprocal in float32)
template <typename T>
__device__ __forceinline__ T wing_value(T delta, T ws) {
  if constexpr (sizeof(T) == 4) return ws * rcp_approx(delta * delta);
  return ws / (delta * delta);
}

template <typename T, bool TWOFLOAT>
__device__ __forceinline__ T delta_of(T w_hi, T w_lo, const Rec<T>& r) {
  if (TWOFLOAT) return ((w_hi - r.v[kC0]) + (w_lo - r.v[kC1])) - r.v[kC2];
  return w_hi - r.v[kC0];
}

// Pass 1: grid (ceil(n_lines / kLineThreads), nlay), one thread per (layer,
// line), writing rec[l * n_lines + i].
template <typename T, int SHAPE, bool TWOFLOAT>
__global__ void line_kernel(const T* __restrict__ cols, int n_lines,
                            const T* __restrict__ lay,
                            Rec<T>* __restrict__ rec,
                            Params prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n_lines) return;
  // per-layer factors, formed as the plain version forms them
  const T t = lay[4 * l];
  const T p = lay[4 * l + 1];
  const T amb = lay[4 * l + 2];
  const T q_ratio = lay[4 * l + 3];
  const T t_ref = T(prm.t_ref);
  const T t_ratio = t_ref / t;
  const T p_ratio = p / T(prm.p_ref);

  const T nu = cols[kNuHi * n_lines + i];
  const T boltz = exp(T(prm.c2) * (t - t_ref) / (t * t_ref) *
                      cols[kElower * n_lines + i]);
  const T stim = T(1.0) - exp(T(-prm.c2) * nu / t);
  const T s = cols[kSw * n_lines + i] *
              (stim / cols[kStimRef * n_lines + i]) * boltz * q_ratio;
  const T alpha_d = T(prm.doppler) * nu * sqrt(t / T(prm.mass));
  const T gamma_l = (pow(t_ratio, cols[kNSelf * n_lines + i]) *
                         cols[kGammaSelf * n_lines + i] * (T(1.0) - amb) +
                     pow(t_ratio, cols[kNAmb * n_lines + i]) *
                         cols[kGammaAmb * n_lines + i] * amb) *
                    p_ratio;
  const T shift = p_ratio * cols[kDeltaAmb * n_lines + i] * amb;
  const T s_eff = s >= T(prm.s_floor) ? s : T(0);
  T a, b, norm;
  shape_params<T, SHAPE>(alpha_d, gamma_l, a, b, norm);
  const T cs = s_eff * norm;
  const T wc = T(prm.wn_calc);
  Rec<T> r;
  if (TWOFLOAT) {
    r.v[kC0] = nu;
    r.v[kC1] = cols[kNuLo * n_lines + i];
    r.v[kC2] = shift;
  } else {
    r.v[kC0] = nu + shift;
    r.v[kC1] = T(0);
    r.v[kC2] = T(0);
  }
  r.v[kA] = a;
  r.v[kB] = b;
  r.v[kCs] = cs;
  r.v[kWs] = core_value<T, SHAPE>(wc, a, b, cs) * T(prm.wn_calc * prm.wn_calc);
  r.v[kS] = s_eff;
  rec[static_cast<size_t>(l) * n_lines + i] = r;
}

// The (block, line) class from the deltas at the block's first and last
// wave (the computed delta is monotone in the wave up to a few ulps, which
// `margin` covers).
template <typename T>
__device__ __forceinline__ int line_class(T d_first, T d_last, T wc, T wa,
                                          T margin) {
  if (d_last < -wa - margin || d_first >= wa + margin) return kSkip;
  const T wcore = wc < wa ? wc : wa;
  if (d_first >= -wcore + margin && d_last < wcore - margin) return kCore;
  if ((d_first >= wc + margin && d_last < wa - margin) ||
      (d_first >= -wa + margin && d_last < -wc - margin))
    return kWing;
  return kStraddle;
}

// Sums the lines of one staged tile into the V waves of the thread.
template <typename T, int SHAPE, bool TWOFLOAT, int V>
__device__ __forceinline__ void sum_tile(const Rec<T>* tile, int n_tile,
                                         const T (&w_hi)[V],
                                         const T (&w_lo)[V], T (&acc)[V],
                                         T wc, T wa) {
  for (int j = 0; j < n_tile; ++j) {
    const Rec<T> r = tile[j];
    const T cls = r.v[kS];  // compared as stored, with no conversion
    if (cls == T(kWing)) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] += wing_value(delta_of<T, TWOFLOAT>(w_hi[k], w_lo[k], r),
                             r.v[kWs]);
    } else if (cls == T(kCore)) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] += core_value<T, SHAPE>(
            delta_of<T, TWOFLOAT>(w_hi[k], w_lo[k], r), r.v[kA], r.v[kB],
            r.v[kCs]);
    } else if (cls == T(kStraddle)) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const T d = delta_of<T, TWOFLOAT>(w_hi[k], w_lo[k], r);
        if (!(d >= -wa && d < wa)) continue;
        acc[k] += (d >= -wc && d < wc)
                      ? core_value<T, SHAPE>(d, r.v[kA], r.v[kB], r.v[kCs])
                      : wing_value(d, r.v[kWs]);
      }
    }
  }
}

// Pass 2: grid (nb, nlay), ceil(width / V) threads; thread t holds the
// block's waves t + k ceil(width / V), k < V. ASYNC: the records are
// staged by cp.async into two shared-memory tiles (the next tile loads
// while the current one is summed) and classed in place after they land;
// otherwise each thread loads, classes and stores its records of a tile.
// Both sum the same values in the same order: the same bits.
template <typename T, int SHAPE, bool TWOFLOAT, int V, bool ASYNC>
__global__ void __launch_bounds__(512)
    pair_kernel(const T* __restrict__ wn, const int* __restrict__ ranges,
                const Rec<T>* __restrict__ rec, T* __restrict__ out,
                int n_lines, int nb, int width, int n_wave, int nlay, T wc,
                T wa, T margin, T factor) {
  __shared__ Rec<T> s_rec[ASYNC ? 2 : 1][kTile];
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int l = blockIdx.y;
  const int tid = threadIdx.x;
  const int base_w = b * width;
  const T* wn_lo = wn + static_cast<size_t>(nb) * width;

  T w_hi[V], w_lo[V], acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = min(tid + k * nt, width - 1);  // idle slots repeat a wave
    w_hi[k] = wn[base_w + j];
    w_lo[k] = TWOFLOAT ? wn_lo[base_w + j] : T(0);
    acc[k] = T(0);
  }
  const T f_hi = wn[base_w], l_hi = wn[base_w + width - 1];
  const T f_lo = TWOFLOAT ? wn_lo[base_w] : T(0);
  const T l_lo = TWOFLOAT ? wn_lo[base_w + width - 1] : T(0);
  const Rec<T>* lrec = rec + static_cast<size_t>(l) * n_lines + ranges[b];
  const int count = ranges[nb + b];

  // the class of a record, in its strength's place
  auto classify = [&](Rec<T>& r) {
    int cls = kSkip;
    if (r.v[kS] != T(0))
      cls = line_class(delta_of<T, TWOFLOAT>(f_hi, f_lo, r),
                       delta_of<T, TWOFLOAT>(l_hi, l_lo, r), wc, wa, margin);
    r.v[kS] = T(cls);
  };

  if constexpr (ASYNC) {
    constexpr int kChunks = sizeof(Rec<T>) / 16;  // 16-byte copies a record
    auto stage = [&](int buf, int base) {
      const int n = min(kTile, count - base) * kChunks;
      const char* src = reinterpret_cast<const char*>(lrec + base);
      char* dst = reinterpret_cast<char*>(s_rec[buf]);
      for (int c = tid; c < n; c += nt) cp_async16(dst + 16 * c, src + 16 * c);
    };
    if (count > 0) stage(0, 0);
    cp_async_commit();
    for (int base = 0, buf = 0; base < count; base += kTile, buf ^= 1) {
      const int n_tile = min(kTile, count - base);
      if (base + kTile < count) stage(buf ^ 1, base + kTile);
      cp_async_commit();
      cp_async_wait_one();  // this thread's copies of the current tile
      __syncthreads();      // everyone's
      for (int j = tid; j < n_tile; j += nt) classify(s_rec[buf][j]);
      __syncthreads();
      sum_tile<T, SHAPE, TWOFLOAT, V>(s_rec[buf], n_tile, w_hi, w_lo, acc, wc,
                                      wa);
      __syncthreads();  // the tile is free for the copy after next
    }
  } else {
    for (int base = 0; base < count; base += kTile) {
      const int n_tile = min(kTile, count - base);
      for (int j = tid; j < n_tile; j += nt) {
        Rec<T> r = lrec[base + j];
        classify(r);
        s_rec[0][j] = r;
      }
      __syncthreads();
      sum_tile<T, SHAPE, TWOFLOAT, V>(s_rec[0], n_tile, w_hi, w_lo, acc, wc,
                                      wa);
      __syncthreads();
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = tid + k * nt;
    const int iw = base_w + j;
    if (j < width && iw < n_wave)
      out[static_cast<size_t>(iw) * nlay + l] = acc[k] * factor;
  }
}

struct Launch {
  const void *cols, *wn, *ranges, *lay;
  void *rec, *out;
  int n_lines, nb, width, n_wave, nlay;
  Params prm;
  cudaStream_t stream;
};

template <typename T, int SHAPE, bool TWOFLOAT, int V, bool ASYNC = false>
cudaError_t launch_one(const Launch& a) {
  Rec<T>* rec = static_cast<Rec<T>*>(a.rec);
  if (a.n_lines > 0) {
    const dim3 grid((a.n_lines + kLineThreads - 1) / kLineThreads, a.nlay);
    line_kernel<T, SHAPE, TWOFLOAT><<<grid, kLineThreads, 0, a.stream>>>(
        static_cast<const T*>(a.cols), a.n_lines,
        static_cast<const T*>(a.lay), rec, a.prm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const T wa = T(a.prm.wn_approx);
  pair_kernel<T, SHAPE, TWOFLOAT, V, ASYNC>
      <<<dim3(a.nb, a.nlay), (a.width + V - 1) / V, 0, a.stream>>>(
          static_cast<const T*>(a.wn), static_cast<const int*>(a.ranges), rec,
          static_cast<T*>(a.out), a.n_lines, a.nb, a.width, a.n_wave, a.nlay,
          T(a.prm.wn_calc), wa, T(1e-4) * (fabs(wa) + T(1)), T(a.prm.factor));
  return cudaGetLastError();
}

template <typename T, bool TWOFLOAT>
cudaError_t launch_shape(const Launch& a, int shape, int wpt, int staging) {
  constexpr int V = kWavesPerThread;
  if (wpt == 0) wpt = V;
  // every lineshape at the default waves per thread with plain loads;
  // Voigt also at 1 and 4, and with cp.async staging (chip_smoke's sweep)
  if (staging != 0) {
    if (shape != kVoigt || wpt != V || staging != 1)
      return cudaErrorInvalidValue;
    return launch_one<T, kVoigt, TWOFLOAT, V, true>(a);
  }
  if (shape == kVoigt) {
    switch (wpt) {
      case 1:
        return launch_one<T, kVoigt, TWOFLOAT, 1>(a);
      case 2:
        return launch_one<T, kVoigt, TWOFLOAT, 2>(a);
      case 4:
        return launch_one<T, kVoigt, TWOFLOAT, 4>(a);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (wpt != V) return cudaErrorInvalidValue;
  switch (shape) {
    case kGaussian:
      return launch_one<T, kGaussian, TWOFLOAT, V>(a);
    case kLorentz:
      return launch_one<T, kLorentz, TWOFLOAT, V>(a);
    case kTonkov:
      return launch_one<T, kTonkov, TWOFLOAT, V>(a);
    case kHartmann:
      return launch_one<T, kHartmann, TWOFLOAT, V>(a);
    case kVoigtCh4H2:
      return launch_one<T, kVoigtCh4H2, TWOFLOAT, V>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). cols (10, n_lines): nu_hi,
// nu_lo, sw (the isotope factor NOT folded in), elower, stim_ref, g_self,
// n_self, g_amb, n_amb, d_amb (zeros without the pressure shift); wn (2,
// nb * width): the wave grid's hi and lo parts (lo zero and unread unless
// twofloat); ranges (2, nb) int32: starts, counts; lay (nlay, 4): T, p
// [atm], ambient fraction, Q(Tref)/Q(T); rec: scratch of nlay * n_lines * 8
// values of the type (pass 1 writes it, pass 2 reads it); out (n_wave,
// nlay). wpt: waves per thread of pass 2 (0: the default); staging: 0
// plain loads, 1 double-buffered cp.async (Voigt, default wpt). Each launches
// both passes on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launches.
extern "C" int lbl_cross_section_f32(
    const void* cols, const void* wn, const void* ranges, const void* lay,
    void* rec, void* out, int n_lines, int nb, int width, int n_wave,
    int nlay, int shape, int twofloat, int wpt, int staging, double t_ref,
    double p_ref, double mass, double s_floor, double wn_calc,
    double wn_approx, double factor, double c2, double doppler, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb <= 0 || nlay <= 0) return 0;
  const Launch a{cols,   wn,    ranges, lay,    rec,
                 out,    n_lines, nb,   width,  n_wave,
                 nlay,
                 Params{t_ref, p_ref, mass, s_floor, wn_calc, wn_approx,
                        factor, c2, doppler},
                 static_cast<cudaStream_t>(stream)};
  err = twofloat ? launch_shape<float, true>(a, shape, wpt, staging)
                 : launch_shape<float, false>(a, shape, wpt, staging);
  return static_cast<int>(err);
}

extern "C" int lbl_cross_section_f64(
    const void* cols, const void* wn, const void* ranges, const void* lay,
    void* rec, void* out, int n_lines, int nb, int width, int n_wave,
    int nlay, int shape, int twofloat, int wpt, int staging, double t_ref,
    double p_ref, double mass, double s_floor, double wn_calc,
    double wn_approx, double factor, double c2, double doppler, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (twofloat) return static_cast<int>(cudaErrorInvalidValue);
  if (nb <= 0 || nlay <= 0) return 0;
  const Launch a{cols,   wn,    ranges, lay,    rec,
                 out,    n_lines, nb,   width,  n_wave,
                 nlay,
                 Params{t_ref, p_ref, mass, s_floor, wn_calc, wn_approx,
                        factor, c2, doppler},
                 static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      launch_shape<double, false>(a, shape, wpt, staging));
}
