"""Opacity-source structures: k-tables, CIA tables, aerosol optics, surface.

Table data are tensors; dimensions and gas identities are host metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from archnemesis_tpu_torch.enums import (
    LowerBoundaryCondition,
    ParaH2Ratio,
    SpectralCalculationMode,
)
from archnemesis_tpu_torch.ops.ktab import host_log_ktable
from archnemesis_tpu_torch.utils.device import resolve_device
from archnemesis_tpu_torch.utils.pytree import (
    static_field,
    tensor_dataclass,
    tensor_fields,
)


@tensor_dataclass
class KTables:
    """Correlated-k (or LBL, ng=1) tables for all radiatively active gases on
    a common (wave, g, press, temp) grid (reference ``Spectroscopy_0``
    read_tables, ``Spectroscopy_0.py:1448``): k in cm^2 molecule^-1, press
    in atm, temp in K.
    """

    wave: Any  # (NWAVE,)
    g_ord: Any  # (NG,)
    del_g: Any  # (NG,)
    press: Any  # (NPRESS,) [atm]
    temp: Any  # (NTEMP,) [K]
    k: Any  # (NGAS, NWAVE, NG, NPRESS, NTEMP) [cm^2]
    # host-f64 log of k (ops.ktab.host_log_ktable), attached by cast_deck on
    # the float32 path so no device log of table values is taken
    logk: Any = None

    fwhm: float = static_field(default=0.0)
    gas_id: Tuple[int, ...] = static_field(default=())
    iso_id: Tuple[int, ...] = static_field(default=())
    ilbl: SpectralCalculationMode = static_field(
        default=SpectralCalculationMode.K_TABLES
    )
    # this rank's part of a wave-sharded grid (parallel/mesh.py:
    # shard_ktables_by_wave; wave and k hold only its waves); None: the
    # whole grid
    wave_slice: Any = static_field(default=None)

    @property
    def ngas(self) -> int:
        return self.k.shape[0]

    @property
    def nwave(self) -> int:
        return self.k.shape[1]

    @property
    def ng(self) -> int:
        return self.k.shape[2]

    @classmethod
    def from_tables(cls, tables, ilbl=SpectralCalculationMode.K_TABLES,
                    device=None):
        """Stack per-gas ``io.ktables.KTableData`` onto a shared grid, as
        tensors on ``device`` (None = CUDA). All tables must share
        wave/g/press/temp grids."""
        device = resolve_device(device)
        t0 = tables[0]
        for t in tables[1:]:
            if not (
                np.allclose(t.wave, t0.wave)
                and np.allclose(t.press, t0.press)
                and np.allclose(t.temp, t0.temp)
                and np.allclose(t.g_ord, t0.g_ord)
            ):
                raise ValueError("k-tables do not share a common grid")

        def dev(x):
            return torch.as_tensor(np.asarray(x), device=device)

        return cls(
            wave=dev(t0.wave),
            g_ord=dev(t0.g_ord),
            del_g=dev(t0.del_g),
            press=dev(t0.press),
            temp=dev(t0.temp),
            k=dev(np.stack([t.k for t in tables], axis=0)),
            fwhm=float(t0.fwhm),
            gas_id=tuple(int(t.gas_id) for t in tables),
            iso_id=tuple(int(t.iso_id) for t in tables),
            ilbl=ilbl,
        )


@tensor_dataclass
class CIATables:
    """Collision-induced-absorption cross-section tables (reference
    ``CIA_0``, CIA_0.py:44): K_CIA in cm^5 molecule^-2 on (pair, para-H2
    fraction, temperature, wavenumber)."""

    waven: Any  # (NWAVE_CIA,) [cm-1]
    temp: Any  # (NT,)
    frac: Any  # (max(NPARA,1),) para-H2 fractions
    k_cia: Any  # (NPAIR, max(NPARA,1), NT, NWAVE_CIA)

    pair_gas1: Tuple[int, ...] = static_field(default=())
    pair_gas2: Tuple[int, ...] = static_field(default=())
    inormalt: Tuple[int, ...] = static_field(default=())
    npara: int = static_field(default=0)
    inormal: ParaH2Ratio = static_field(default=ParaH2Ratio.EQUILIBRIUM)
    # k_cia premultiplier already applied (power of two; see prescale())
    k_scale: float = static_field(default=1.0)

    @property
    def npair(self) -> int:
        return self.k_cia.shape[0]

    # The balance factor pairing k_cia ~ 1e-45 cm^5 with TOTAM^2 ~ 1e50
    # cm^-4 (ops/cia.py). 2**134 is exact in float64, so prescaled tables
    # are bit-identical there; in float32 the raw values are subnormal, so
    # any float32 deck must carry a prescaled table.
    K_CIA_BALANCE = 2.0**134

    def prescale(self) -> "CIATables":
        """Fold the 2**134 balance factor into k_cia in float64 (exact: a
        power of two). Call before casting a deck to float32."""
        residual = self.K_CIA_BALANCE / self.k_scale
        if residual == 1.0:
            return self
        k64 = self.k_cia.to(torch.float64) * residual
        return self.replace(k_cia=k64, k_scale=self.K_CIA_BALANCE)


@tensor_dataclass
class AerosolOptics:
    """Aerosol extinction/scattering cross sections per population
    (reference ``Scatter_0`` .xsc state): cm^2 particle^-1 on a wave grid."""

    wave: Any  # (NWAVE_XSC,)
    kext: Any  # (NWAVE_XSC, NDUST)
    ksca: Any  # (NWAVE_XSC, NDUST)

    @property
    def ndust(self) -> int:
        return self.kext.shape[1]


@tensor_dataclass
class HapkeParams:
    """Hapke (2012) BRDF parameter spectra on their own wave grid
    (reference ``Surface_0.read_hap:1004``: the .hap file carries NEM rows
    of 11 columns)."""

    vem: Any  # (NEM_HAP,)
    sglalb: Any  # single-scattering albedo w
    k: Any  # porosity coefficient
    bs0: Any  # shadow-hiding opposition amplitude
    hs: Any  # shadow-hiding opposition width
    bc0: Any  # coherent-backscatter amplitude
    hc: Any  # coherent-backscatter width
    roughness: Any  # macroscopic roughness [deg]
    g1: Any  # HG phase asymmetry 1
    g2: Any  # HG phase asymmetry 2
    f: Any  # HG mixing fraction


@tensor_dataclass
class SurfaceSpec:
    """Surface state (reference ``Surface_0``): emissivity spectrum,
    temperature, ground albedo, lower-boundary condition, and the optional
    anisotropic-BRDF parameter blocks (Hapke .hap spectra, Oren-Nayar
    albedo/roughness)."""

    tsurf: Any  # scalar [K] (<=0 means gas giant / no surface)
    vem: Any  # (NEM,) wave grid of emissivity
    emissivity: Any  # (NEM,)
    galb: Any  # scalar ground albedo (<0: use 1-emissivity)
    hapke: Any = None  # Optional[HapkeParams] (lowbc=2)
    on_albedo: Any = None  # Optional (NEM,) Oren-Nayar albedo (lowbc=3)
    on_roughness: Any = None  # Optional (NEM,) Oren-Nayar sigma [deg]

    lowbc: LowerBoundaryCondition = static_field(
        default=LowerBoundaryCondition.THERMAL
    )
    gasgiant: bool = static_field(default=True)


@tensor_dataclass
class StellarSpec:
    """Stellar spectrum (reference ``Stellar_0``): luminosity spectral
    density on a wave grid plus the planet's distance."""

    wave: Any  # (NSOL,)
    solspec: Any  # (NSOL,) luminosity spectral density (W (cm-1)-1 or W um-1)
    dist: Any  # scalar [AU]
    radius: Any  # scalar stellar radius [km]

    solexist: bool = static_field(default=False)
    ispace: int = static_field(default=0)


def cast_deck(obj, dtype=torch.float32):
    """Cast every floating tensor of one structure to ``dtype``.

    Below float64, CIA tables are ``prescale()``d first (raw k_cia values
    are subnormal in float32) and k-tables get their host-f64 log table
    attached before the cast truncates k.
    """
    if obj is None:
        return None
    narrow = torch.finfo(dtype).bits < 64
    if narrow and isinstance(obj, CIATables):
        obj = obj.prescale()
    if narrow and isinstance(obj, KTables) and obj.logk is None:
        logk = host_log_ktable(obj.k.detach().cpu().numpy())
        obj = obj.replace(logk=torch.as_tensor(logk, device=obj.k.device))
    cast = {}
    for name in tensor_fields(type(obj)):
        x = getattr(obj, name)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            cast[name] = x.to(dtype)
        elif dataclasses.is_dataclass(x):  # a nested block (HapkeParams)
            cast[name] = cast_deck(x, dtype)
    return dataclasses.replace(obj, **cast)
