"""Line-by-line absorption at run time (archNEMESIS semantics,
LineData_0.py:124-229, Spectroscopy_0.py:2046 calc_klbl_online).

Per layer and line: S(T) = S_ref (stim(T) / stim(T_ref)) exp(c2 E''
(T - T_ref) / (T T_ref)) Q(T_ref) / Q(T), the Doppler HWHM nu sqrt(2 ln2 N_A
k_B T / m) / c, the Lorentz HWHM of self and ambient broadening with their
temperature exponents, and the ambient pressure shift. A line adds its
Voigt profile (Weideman's 24-term rational expansion of the Faddeeva
function, SIAM J. Numer. Anal. 31 (1994) 1497, as the reference's
voigt_schreier) within wn_calc of its shifted centre, f(wn_calc) wn_calc^2 /
delta^2 from there to wn_approx, and nothing beyond.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

C_LIGHT_CGS = 2.99792458e10
H_PLANCK_CGS = 6.62607015e-27
K_B_CGS = 1.380649e-16
C2_CGS = C_LIGHT_CGS * H_PLANCK_CGS / K_B_CGS
N_AVOGADRO = 6.02214129e23
# lines summed at once: bounds the (lines, waves) temporaries
LINES_PER_PANEL = 1024
DOPPLER = math.sqrt(2.0 * math.log(2.0) * N_AVOGADRO * K_B_CGS) / C_LIGHT_CGS

L24 = math.sqrt(24.0 / math.sqrt(2.0))
A24 = (
    +2.3241983342526162e+00,
    +2.1978589365315417e+00, +1.8562864992055408e+00, +1.3948196733791203e+00,
    +9.2570871385886788e-01, +5.3611395357291292e-01, +2.6549639598807689e-01,
    +1.0838723484566792e-01, +3.3723366855316413e-02, +6.2150063629501763e-03,
    -4.9364269012806686e-04, -7.8166429956142650e-04, -2.0748431511424456e-04,
    +2.4331415462641969e-05, +3.0471066083243790e-05, +4.1394617248575527e-06,
    -3.0388931839840047e-06, -1.0856475790698251e-06, +2.5682641346701115e-07,
    +1.8738343486619108e-07, -1.9122258522976932e-08, -3.0082822811202271e-08,
    +1.3310461806370372e-09, +4.9048215867870488e-09, -1.5137461654527820e-10,
)


@dataclasses.dataclass
class Lines:
    """One isotopologue's lines (host float64), sorted by centre."""

    nu: np.ndarray
    sw: np.ndarray
    elower: np.ndarray
    gamma_self: np.ndarray
    n_self: np.ndarray
    gamma_amb: np.ndarray
    n_amb: np.ndarray
    delta_amb: np.ndarray
    stim_ref: np.ndarray  # 1 - exp(-c2 nu / T_ref) of the file's centres
    t_ref: float
    p_ref: float
    pf_temp: np.ndarray
    pf_q: np.ndarray
    mass: float  # g/mol


def read_lines(path: str, prefix: str, ambient: str, mass: float) -> Lines:
    """Lines of one "ans" export (``<prefix>/<field>`` arrays); missing
    self-broadening takes the ambient values (ans_line_data_file.py:
    455-465)."""
    with np.load(path) as f:
        raw = {k: np.array(f[f"{prefix}/{k}"], np.float64) for k in
               ("nu", "sw", "elower", "gamma_self", "n_self", "pf_temp",
                "pf_q", "t_ref", "p_ref")}
        for k in ("gamma_amb", "n_amb", "delta_amb"):
            raw[k] = np.array(f[f"{prefix}/broadeners/{ambient}/{k}"],
                              np.float64)
    order = np.argsort(raw["nu"])
    cols = {k: raw[k][order] for k in ("nu", "sw", "elower", "gamma_self",
                                       "n_self", "gamma_amb", "n_amb",
                                       "delta_amb")}
    for own, amb in (("n_self", "n_amb"), ("gamma_self", "gamma_amb")):
        bad = np.isnan(cols[own]) | (cols[own] == 0)
        cols[own][bad] = cols[amb][bad]
    t_ref = float(raw["t_ref"])
    stim_ref = 1.0 - np.exp(-C2_CGS * cols["nu"] / t_ref)
    return Lines(**cols, stim_ref=stim_ref, t_ref=t_ref,
                 p_ref=float(raw["p_ref"]),
                 pf_temp=raw["pf_temp"], pf_q=raw["pf_q"], mass=mass)


def tile(lines: Lines, copies: int, spread: float, seed: int) -> Lines:
    """``copies`` copies of the list, each shifted by one uniform draw in
    [-spread, spread] cm-1 (``default_rng(seed)``), strengths divided by
    ``copies``, sorted by centre; every other column, ``stim_ref`` too, is
    the copied line's."""
    rng = np.random.default_rng(seed)
    nu = np.concatenate([lines.nu + rng.uniform(-spread, spread)
                         for _ in range(copies)])
    order = np.argsort(nu)

    def rep(a):
        return np.concatenate([a] * copies)[order]

    return dataclasses.replace(
        lines, nu=nu[order], sw=rep(lines.sw) / copies,
        elower=rep(lines.elower), gamma_self=rep(lines.gamma_self),
        n_self=rep(lines.n_self), gamma_amb=rep(lines.gamma_amb),
        n_amb=rep(lines.n_amb), delta_amb=rep(lines.delta_amb),
        stim_ref=rep(lines.stim_ref))


def select(lines: Lines, lo: float, hi: float) -> Lines:
    """The lines with centres in [lo, hi]."""
    keep = (lines.nu >= lo) & (lines.nu <= hi)
    return dataclasses.replace(lines, **{
        f.name: getattr(lines, f.name)[keep]
        for f in dataclasses.fields(Lines)
        if isinstance(getattr(lines, f.name), np.ndarray)
        and getattr(lines, f.name).shape == lines.nu.shape})


def faddeeva_re(x, y):
    """Re w(x + iy), y > 0, by Weideman's N = 24 expansion."""
    a_r, a_i = L24 - y, x  # L + iz
    b_r, b_i = L24 + y, -x  # L - iz
    m = b_r * b_r + b_i * b_i
    inv_r, inv_i = b_r / m, -b_i / m
    z_r = a_r * inv_r - a_i * inv_i
    z_i = a_r * inv_i + a_i * inv_r
    p_r = torch.full_like(x, A24[-1])
    p_i = torch.zeros_like(x)
    for c in A24[-2:0:-1]:
        p_r, p_i = p_r * z_r - p_i * z_i + c, p_r * z_i + p_i * z_r
    q_r = p_r * inv_r - p_i * inv_i
    q_i = p_r * inv_i + p_i * inv_r
    q_r = 1.0 / math.sqrt(math.pi) + 2.0 * q_r
    q_i = 2.0 * q_i
    return q_r * inv_r - q_i * inv_i


def voigt(delta, alpha_d, gamma_l):
    """Area-normalised Voigt profile; HWHMs alpha_d (Doppler), gamma_l."""
    scale = math.sqrt(math.log(2.0)) / alpha_d
    return faddeeva_re(delta * scale, gamma_l * scale) * scale / math.sqrt(
        math.pi)


def line_parameters(lines: Lines, temp, press_atm, amb):
    """(strength, alpha_d, gamma_l, shift), each (NLAY, NLINE), in the type
    of ``temp``."""
    col = {k: temp.new_tensor(getattr(lines, k))[None, :]
           for k in ("nu", "sw", "elower", "gamma_self", "n_self",
                     "gamma_amb", "n_amb", "delta_amb", "stim_ref")}
    pf_t, pf_q = temp.new_tensor(lines.pf_temp), temp.new_tensor(lines.pf_q)

    def q(t):
        return interp_clamped(t, pf_t, pf_q)

    t = temp[:, None]
    t_ref = lines.t_ref
    stim = 1.0 - torch.exp(-C2_CGS * col["nu"] / t)
    strength = (col["sw"] * stim / col["stim_ref"]
                * torch.exp(C2_CGS * (t - t_ref) / (t * t_ref) * col["elower"])
                * (q(temp.new_tensor([t_ref])) / q(temp))[:, None])
    alpha_d = DOPPLER * col["nu"] * torch.sqrt(t / lines.mass)
    p_ratio = (press_atm / lines.p_ref)[:, None]
    a = amb[:, None]
    gamma_l = ((t_ref / t) ** col["n_self"] * col["gamma_self"] * (1.0 - a)
               + (t_ref / t) ** col["n_amb"] * col["gamma_amb"] * a) * p_ratio
    shift = p_ratio * col["delta_amb"] * a
    return strength, alpha_d, gamma_l, shift


def interp_clamped(x, xp, fp):
    """numpy.interp: linear inside xp, the end values outside."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    f = ((x - xp[i - 1]) / (xp[i] - xp[i - 1])).clamp(0.0, 1.0)
    return fp[i - 1] + f * (fp[i] - fp[i - 1])


def cross_section(lines: Lines, wave, temp, press_atm, amb,
                  wn_calc: float, wn_approx: float):
    """(len(wave), NLAY) absorption cross section [cm2 molecule-1] at the
    wavenumbers ``wave`` (a host float64 array: any subset of the grid),
    summed over the lines in panels of ``LINES_PER_PANEL``. The
    differences wave - centre are taken in float64 on the host's values
    and then cast, so that a lower type rounds the difference and not
    the two large numbers."""
    strength, alpha_d, gamma_l, shift = line_parameters(lines, temp,
                                                        press_atm, amb)
    dev, dt = temp.device, temp.dtype
    wave64 = torch.as_tensor(np.asarray(wave, np.float64), device=dev)
    nu64 = torch.as_tensor(lines.nu, device=dev)
    out = temp.new_zeros((wave64.shape[0], temp.shape[0]))
    for l0 in range(0, lines.nu.shape[0], LINES_PER_PANEL):
        sl = slice(l0, l0 + LINES_PER_PANEL)
        base = (wave64[None, :] - nu64[sl, None]).to(dt)  # (L, W)
        for lay in range(temp.shape[0]):
            delta = base - shift[lay, sl, None]
            a, g = alpha_d[lay, sl, None], gamma_l[lay, sl, None]
            core = voigt(delta, a, g)
            edge = voigt(torch.full_like(a, wn_calc), a, g)
            wing = edge * (wn_calc * wn_calc) / (delta * delta)
            f = torch.where((delta >= -wn_calc) & (delta < wn_calc), core,
                            wing)
            f = torch.where((delta >= -wn_approx) & (delta < wn_approx), f,
                            0.0)
            out[:, lay] += strength[lay, sl] @ f
    return out
