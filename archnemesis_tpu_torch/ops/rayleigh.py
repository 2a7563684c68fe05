"""Rayleigh-scattering optical depth per layer (4 modes).

Port of the JAX package's ``ops/rayleigh.py`` (reference ``ForwardModel_0.py``:
calc_tau_rayleighj :5525, v :5598, v2 :5647, ls :5712): the (wave x layer)
outer product replaces the per-element loops.
"""

import numpy as np
import torch

from archnemesis_tpu_torch.enums import RayleighScatteringMode, WaveUnit


def _wavelength_um(wave, ispace):
    if ispace == WaveUnit.Wavenumber_cm:
        return 1.0e4 / wave
    return wave


def rayleigh_j(wave, totam, ispace=0):
    """Gas-giant (H2/He, Allen 1976) Rayleigh cross sections -> tau.

    wave: (NWAVE,) cm-1 or um; totam: (NLAY,) column density [m-2].
    Constants match ForwardModel_0.py:5546-5553.
    """
    ah2, bh2 = 13.58e-5, 7.52e-3
    ahe, bhe = 3.48e-5, 2.30e-3
    fh2 = 0.864
    k_b = 1.37971e-23
    p0, t0 = 1.01325e5, 273.15

    lam = _wavelength_um(wave, ispace) * 1.0e-6  # m
    x = 1.0 / (lam * 1.0e6)
    n_air = (fh2 * ah2 * (1.0 + bh2 * x * x)
             + (1 - fh2) * ahe * (1.0 + bhe * x * x))
    delta = 0.0
    temp = 32.0 * np.pi**3 * n_air**2
    n0 = p0 / (k_b * t0)
    xl = n0 * lam * lam
    faniso = (6.0 + 3.0 * delta) / (6.0 - 7.0 * delta)
    # sqrt-ratio form: xl^2 ~ 1e31-1e39 can overflow float32 at long
    # wavelengths; (sqrt(.)/xl)^2 keeps intermediates in range
    k_ray = (torch.sqrt(temp * faniso / 3.0) / xl) ** 2  # m^2
    return k_ray[:, None] * totam[None, :]


def rayleigh_v(wave, totam, ispace=0):
    """CO2-dominated atmospheres (Allen 1976 / B. Bezard constant)."""
    lam_um = _wavelength_um(wave, ispace)
    k_ray = 8.8e-28 / lam_um**4 * 1.0e-4  # cm2 -> m2
    return k_ray[:, None] * totam[None, :]


def rayleigh_v2(wave, totam, ispace=0):
    """CO2-dominated atmospheres (Ityaksov, Linnartz, Ubachs 2008)."""
    lam_um = _wavelength_um(wave, ispace)
    dens = 2.5475605e19
    lam_cm = lam_um * 1.0e-4
    f_king = 1.14 + (25.3e-12) / (lam_cm * lam_cm)
    nu2 = 1.0 / lam_cm / lam_cm
    term1 = (
        5799.3 / (16.618e9 - nu2)
        + 120.05 / (7.9609e9 - nu2)
        + 5.3334 / (5.6306e9 - nu2)
        + 4.3244 / (4.6020e9 - nu2)
        + 1.218e-5 / (5.84745e6 - nu2)
    )
    n = 1.0 + 1.1427e3 * term1
    factor1 = ((n * n - 1) / (n * n + 2.0)) ** 2
    k_ray = (24.0 * np.pi**3 / lam_cm**4 / dens**2) * factor1 * f_king * 1.0e-4
    return k_ray[:, None] * totam[None, :]


def rayleigh_ls(wave, totam, vmr_lay, gas_idx, ispace=0):
    """Jovian air (Sromovsky): H2/He/CH4/NH3 composition-weighted.

    vmr_lay: (NLAY, NVMR) layer volume mixing ratios.
    gas_idx: dict with optional static indices {'h2','he','ch4','nh3'}.
    """
    nlay = vmr_lay.shape[0]
    zeros = torch.zeros(nlay, dtype=vmr_lay.dtype, device=vmr_lay.device)
    fh2 = vmr_lay[:, gas_idx["h2"]] if "h2" in gas_idx else zeros
    fhe = vmr_lay[:, gas_idx["he"]] if "he" in gas_idx else zeros
    fch4 = vmr_lay[:, gas_idx["ch4"]] if "ch4" in gas_idx else zeros
    fnh3 = vmr_lay[:, gas_idx["nh3"]] if "nh3" in gas_idx else zeros

    pos = fh2 > 0.0
    fheh2 = torch.where(pos, fhe / torch.where(pos, fh2, 1.0), 0.0)
    fch4h2 = torch.where(pos, fch4 / torch.where(pos, fh2, 1.0), 0.0)

    comp_h2 = (1.0 - fnh3) / (1.0 + fheh2 + fch4h2)
    comp = torch.stack(
        [comp_h2, fheh2 * comp_h2, fch4h2 * comp_h2, fnh3], dim=1
    )  # (NLAY, 4)

    loschpm3 = 2.687e19 * 1.0e-12  # molecules per cubic micron at STP
    wl = _wavelength_um(wave, ispace)

    def const(x):
        return torch.as_tensor(x, dtype=wave.dtype, device=wave.device)

    a = const([13.58e-5, 3.48e-5, 37.0e-5, 37.0e-5])
    b = const([7.52e-3, 2.3e-3, 12.0e-3, 12.0e-3])
    d = const([0.0221, 0.025, 0.0922, 0.0922])

    nr = 1.0 + a[None, :] * (1.0 + b[None, :] / wl[:, None] ** 2)  # (NWAVE,4)
    dep = (6.0 + 3.0 * d) / (6.0 - 7.0 * d)
    xc1 = torch.einsum("wj,lj->lw", (nr**2 - 1.0) ** 2 * dep[None, :], comp)
    sumwt = torch.sum(comp, dim=1)  # (NLAY,)

    fact = 8.0 * np.pi**3 / (3.0 * wl**4 * loschpm3**2)  # (NWAVE,) um^2
    k_ray = (fact[None, :] * xc1) * 1.0e-8 * 1.0e-4  # um2->cm2->m2
    k_ray = k_ray.T / sumwt[None, :]  # (NWAVE, NLAY)
    return k_ray * totam[None, :]


def rayleigh_tau(mode, wave, totam, vmr_lay=None, gas_idx=None, ispace=0):
    """Dispatch on the static IRAY mode (reference calc_tau_rayleigh
    ForwardModel_0.py:4869)."""
    mode = RayleighScatteringMode(mode)
    if mode == RayleighScatteringMode.NOT_INCLUDED:
        return torch.zeros((wave.shape[0], totam.shape[0]),
                           dtype=totam.dtype, device=totam.device)
    if mode == RayleighScatteringMode.GAS_GIANT_ATM:
        return rayleigh_j(wave, totam, ispace)
    if mode == RayleighScatteringMode.CO2_DOMINATED_ATM:
        return rayleigh_v2(wave, totam, ispace)
    if mode == RayleighScatteringMode.N2_O2_DOMINATED_ATM:
        raise NotImplementedError("IRAY=3 (N2-O2) not yet implemented")
    if mode == RayleighScatteringMode.JOVIAN_AIR:
        return rayleigh_ls(wave, totam, vmr_lay, gas_idx, ispace)
    raise ValueError(f"unknown Rayleigh mode {mode}")
