"""Line-shape functions: Voigt (Weideman-24 rational approximation of the
complex probability function), Gaussian, Lorentz and the sub-Lorentzian
variants.

Port of the JAX package's ``ops/voigt.py`` (reference lineshape/voigt_impl/
voigt_schreier.py:17 complex_err_fn_weideman_24a, :84 voigt_schreier;
lineshape/gaussian.py, lorentz.py). The Weideman coefficients are from
J.A.C. Weideman, SIAM J. Num. Anal. 31, 1497-1518 (1994), eq. 38.I, N=24 —
the same published constants the reference uses. Elementwise over
broadcast tensors; this is the plain version that
``csrc/lbl_cross_section.cu`` repeats per (line, wave) pair.
"""

import numpy as np
import torch

SQRT_2 = np.sqrt(2.0)
SQRT_PI = np.sqrt(np.pi)
SQRT_LOG2 = np.sqrt(np.log(2.0))
INV_SQRT_PI = 1.0 / SQRT_PI
INV_SQRT_2PI = 1.0 / (SQRT_2 * SQRT_PI)

L24 = np.sqrt(24.0 / np.sqrt(2.0))

# Weideman (1994) N=24 expansion coefficients (a0..a24); a0 = L/sqrt(pi)
A24 = np.array([
    +2.3241983342526162e+00,
    +2.1978589365315417e+00, +1.8562864992055408e+00, +1.3948196733791203e+00,
    +9.2570871385886788e-01, +5.3611395357291292e-01, +2.6549639598807689e-01,
    +1.0838723484566792e-01, +3.3723366855316413e-02, +6.2150063629501763e-03,
    -4.9364269012806686e-04, -7.8166429956142650e-04, -2.0748431511424456e-04,
    +2.4331415462641969e-05, +3.0471066083243790e-05, +4.1394617248575527e-06,
    -3.0388931839840047e-06, -1.0856475790698251e-06, +2.5682641346701115e-07,
    +1.8738343486619108e-07, -1.9122258522976932e-08, -3.0082822811202271e-08,
    +1.3310461806370372e-09, +4.9048215867870488e-09, -1.5137461654527820e-10,
])

# |z|^2 above which the continued fraction replaces the Weideman expansion
# in FLOAT32: the Weideman Horner sum cancels O(1) terms down to a
# ~y/|z|^2 result, so its f32 relative error blows up in the far wings
# (~1% at |z|~12, ~18% at |z|~1e3); the 6-convergent CF truncation error is
# <3e-7 for |z|>=7 — below f32 rounding. FLOAT64 keeps pure Weideman
# everywhere: that is bit-comparable with the reference
# (voigt_schreier.py:17), which defines the parity contract.
_ASYM_R2 = 49.0
# the continued fraction's partial numerators, innermost first
CF_COEFFS = (3.0, 2.5, 2.0, 1.5, 1.0, 0.5)


def _cpf_continued_fraction(z_r, z_i):
    """6-convergent Laplace continued fraction of w(z) for large |z|:

        w(z) = (i/sqrt(pi)) / (z - 1/2/(z - 1/(z - 3/2/(z - 2/(z - 5/2/(z - 3/z))))))

    Relative accuracy better than ~3e-7 for |z| >= 7 (far line wings; the
    switch threshold is _ASYM_R2 = 49 on |z|^2). Real-pair arithmetic.
    """

    def cdiv_real(c, br, bi):
        m = br * br + bi * bi
        return c * br / m, -c * bi / m

    d_r, d_i = z_r, z_i
    for c in CF_COEFFS:
        qr, qi = cdiv_real(c, d_r, d_i)
        d_r, d_i = z_r - qr, z_i - qi
    m = d_r * d_r + d_i * d_i
    # w = (i/sqrt(pi)) / d
    return INV_SQRT_PI * d_i / m, INV_SQRT_PI * d_r / m


# the continued fraction's 6th convergent as w = (i/sqrt(pi)) p5(t) /
# (z p6(t)), t = 1/z^2: the forward recurrence P_{k+1} = z P_k - c_k P_{k-1}
# (P_{-1} = 1, P_0 = z) divided by z^(k+1); coefficients of t^0..t^3
CF_P5 = (1.0, -10.0, 21.75, -6.0)
CF_P6 = (1.0, -10.5, 26.25, -13.125)


def cf_ratio_re(x, y):
    """Re w(z) of the 6-convergent continued fraction in the arithmetic of
    the float32 CUDA kernel (``csrc/lbl_cross_section.cu:cf_re``): two
    reciprocals, 1/|z|^2 and 1/|p6|^2, where the nested form takes six and
    a division; no term grows with |z| (|t| < 1/49 where it applies). The
    kernel's reciprocals are approximate (1 ulp), these are IEEE."""
    r = 1.0 / (x * x + y * y)
    u_r, u_i = x * r, -y * r  # 1/z
    t_r, t_i = u_r * u_r - u_i * u_i, 2.0 * u_r * u_i

    def poly(c):
        q_r, q_i = c[3] * t_r + c[2], c[3] * t_i
        for a in (c[1], c[0]):
            q_r, q_i = t_r * q_r - t_i * q_i + a, t_r * q_i + t_i * q_r
        return q_r, q_i

    (p5_r, p5_i), (p6_r, p6_i) = poly(CF_P5), poly(CF_P6)
    m_r, m_i = p5_r * u_r - p5_i * u_i, p5_r * u_i + p5_i * u_r  # p5 / z
    im = m_i * p6_r - m_r * p6_i
    return -INV_SQRT_PI * im / (p6_r * p6_r + p6_i * p6_i)


def complex_err_fn_weideman24(z_r, z_i):
    """Real/imag parts of w(z) = e^{-z^2} erfc(-iz): the Weideman-24
    rational expansion (matches reference complex_err_fn_weideman_24a),
    with a continued-fraction far-wing branch in float32 (see
    _cpf_continued_fraction)."""
    f32 = z_r.dtype == torch.float32
    if f32:
        r2 = z_r * z_r + z_i * z_i
        asym = r2 > _ASYM_R2
        # keep the untaken branch finite so the where's tangents stay
        # NaN-free
        zs_r = torch.where(asym, z_r, 30.0)
        zs_i = torch.where(asym, z_i, 0.0)
        cf_r, cf_i = _cpf_continued_fraction(zs_r, zs_i)

    lp_iz_r = L24 - z_i
    lp_iz_i = z_r
    lm_iz_r = L24 + z_i
    lm_iz_i = -z_r

    mag = lm_iz_r * lm_iz_r + lm_iz_i * lm_iz_i
    inv_r = lm_iz_r / mag
    inv_i = -lm_iz_i / mag

    zz_r = lp_iz_r * inv_r - lp_iz_i * inv_i
    zz_i = lp_iz_r * inv_i + lp_iz_i * inv_r

    poly_r = torch.full_like(z_r, A24[-1])
    poly_i = torch.zeros_like(z_r)
    for i in range(A24.size - 2, 0, -1):
        t_r = poly_r * zz_r - poly_i * zz_i
        t_i = poly_r * zz_i + poly_i * zz_r
        poly_r = t_r + A24[i]
        poly_i = t_i

    x_r = poly_r * inv_r - poly_i * inv_i
    x_i = poly_r * inv_i + poly_i * inv_r
    x_r = INV_SQRT_PI + 2.0 * x_r
    x_i = 2.0 * x_i
    w_r = x_r * inv_r - x_i * inv_i
    w_i = x_r * inv_i + x_i * inv_r
    if f32:
        return torch.where(asym, cf_r, w_r), torch.where(asym, cf_i, w_i)
    return w_r, w_i


def voigt(delta_wn, alpha_d, gamma_l):
    """Voigt profile (area-normalised), alpha_d = Gaussian HWHM, gamma_l =
    Lorentz HWHM. Broadcasts all arguments (reference voigt_schreier:84)."""
    scale = SQRT_LOG2 / alpha_d
    x = delta_wn * scale
    y = gamma_l * scale
    x, y = torch.broadcast_tensors(x, y)
    w_r, _ = complex_err_fn_weideman24(x, y)
    return w_r * scale * INV_SQRT_2PI * SQRT_2


def gaussian(delta_wn, alpha_d, gamma_l=None):
    """Doppler-only profile (reference lineshape/gaussian.py)."""
    sigma = alpha_d / np.sqrt(2.0 * np.log(2.0))
    return (
        torch.exp(-0.5 * (delta_wn / sigma) ** 2)
        / (sigma * np.sqrt(2.0 * np.pi))
    )


def lorentz(delta_wn, alpha_d, gamma_l):
    """Pressure-only profile (reference lineshape/lorentz.py)."""
    return gamma_l / (np.pi * (gamma_l**2 + delta_wn**2))


def tonkov96_sublorentz_co2_venus(delta_wn, alpha_d, gamma_l):
    """CO2 Voigt with Tonkov+96 sub-Lorentzian chi-factor wings for the
    Venus near-infrared windows (reference
    lineshape/tonkov96_sublorentz_CO2_venus.py)."""
    ad = torch.abs(delta_wn)
    chi = torch.where(
        ad < 3.0,
        1.0,
        torch.where(
            ad < 150.0,
            1.084 * torch.exp(-0.027 * ad),
            torch.where(
                ad < 300.0,
                0.208 * torch.exp(-0.016 * ad),
                0.025 * torch.exp(-0.009 * ad),
            ),
        ),
    )
    return chi * voigt(delta_wn, alpha_d, gamma_l)


def hartmann_ch4_h2(delta_wn, alpha_d, gamma_l):
    """CH4-in-H2 Voigt with Hartmann (2002) empirical sub-Lorentzian wings
    (reference lineshape/hartmann_empirical_infrared_CH4_H2_broadening.py)."""
    ad = torch.abs(delta_wn)
    chi = torch.where(
        ad < 26.0,
        1.0,
        torch.where(
            ad < 60.0,
            8.72 * torch.exp(-ad / 12.0),
            0.0684 * torch.exp(-ad / 393.0),
        ),
    )
    return chi * voigt(delta_wn, alpha_d, gamma_l)


def voigt_ch4_h2(delta_wn, alpha_d, gamma_l):
    """CH4-in-H2 Voigt with both widths scaled by 1/sqrt(2) (reference
    lineshape/voigt_CH4_H2_broadening.py — the factor matches existing
    NEMESIS LBL tables per the reference's own note)."""
    return voigt(delta_wn, alpha_d / SQRT_2, gamma_l / SQRT_2)


# name -> fn registry shared by the plain synthesis and the pseudo-continuum;
# the CUDA kernel takes the index of the name in this order
LINESHAPES = {
    "voigt": voigt,
    "gaussian": gaussian,
    "lorentz": lorentz,
    "tonkov96_sublorentz_co2_venus": tonkov96_sublorentz_co2_venus,
    "hartmann_ch4_h2": hartmann_ch4_h2,
    "voigt_ch4_h2": voigt_ch4_h2,
}
