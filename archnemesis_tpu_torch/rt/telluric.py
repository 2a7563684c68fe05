"""Telluric (Earth-atmosphere) transmission for ground-based observations
(reference Telluric_0.py:36, calc_transmission:398).

Port of the JAX package's ``rt/telluric.py``. The Earth's atmosphere above
the observatory is split into 31 equal-height layers (reference :410-417),
a single upward slant path at zenith angle 180-EMISS_ANG is built with the
spherical scale factors, gas line-of-sight opacity is computed with the
same opacity functions as the planetary forward model (the k-table mix goes
through the combine kernel), and the g-integrated transmission exp(-tau) is
returned on the telluric spectroscopy grid. The planetary set-up multiplies
it into the calculation-grid spectrum before the convolution
(ForwardModel_0.py:538-552).

The slant factors come from ``rt/path.py:_scale_factors`` at the
observatory's altitude: no difference of numbers of Earth's size is taken
(in float32 Earth's radius keeps about 0.5 m).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from archnemesis_tpu_torch.constants import C_LIGHT
from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
from archnemesis_tpu_torch.enums import (
    LayerIntegrationScheme,
    LayerType,
    RayleighScatteringMode,
    WaveUnit,
)
from archnemesis_tpu_torch.rt.layer import build_layers
from archnemesis_tpu_torch.rt.path import _scale_factors
from archnemesis_tpu_torch.utils.interp import interp
from archnemesis_tpu_torch.utils.pytree import static_field, tensor_dataclass

@tensor_dataclass
class Telluric:
    """Telluric state: the Earth atmosphere and its own spectroscopy tables
    (reference Telluric_0 holds an Atmosphere and a Spectroscopy); the
    observatory's altitude [m] and EMISS_ANG (90 = horizon .. 180 = zenith)
    are host numbers."""

    atm: Any  # Atmosphere (Earth)
    ktables: Any  # KTables of the telluric gases

    altitude: float = static_field(default=0.0)
    emiss_ang: float = static_field(default=180.0)
    nlay: int = static_field(default=31)


def telluric_transmission(tel: Telluric, wave=None):
    """(wave, transmission) of the Earth's atmosphere along the upward
    slant path (reference calc_transmission Telluric_0.py:398-536), on the
    telluric tables' grid unless ``wave`` is given."""
    from archnemesis_tpu_torch.forward import (
        layer_optical_depths,
        make_forward_config,
    )

    laycfg = LayerConfig(
        nlay=tel.nlay,
        laytyp=LayerType.EQUAL_HEIGHT,
        layint=LayerIntegrationScheme.ABSORBER_WEIGHTED_AVERAGE,
        layht=float(tel.altitude),
    )
    layers = build_layers(tel.atm, laycfg)

    # upward slant: zenith angle at the observer (AtmCalc_0.py:207)
    angle = 180.0 - float(tel.emiss_ang)
    h_top = layers.baseh[-1] + layers.delh[-1]
    sf = _scale_factors(layers, tel.atm.radius, h_top, angle,
                        layers.baseh[0])  # (NLAY,)
    layers_los = layers.replace(amount=layers.amount * sf[:, None])

    cfg = make_forward_config(
        tel.atm, tel.ktables, None,
        iray=RayleighScatteringMode.NOT_INCLUDED,
        ispace=WaveUnit.Wavenumber_cm, gasgiant=True,
    )
    if wave is None:
        wave = tel.ktables.wave
    od = layer_optical_depths(cfg, layers_los, wave, tel.ktables, None, None)
    trans = torch.exp(-torch.sum(od["taugas"], dim=2))  # (NWAVE, NG)
    return wave, trans @ tel.ktables.del_g.to(trans.dtype)


def apply_telluric(tel: Optional[Telluric], wave_calc, spec, v_doppler=0.0,
                   ispace: WaveUnit = WaveUnit.Wavenumber_cm):
    """Multiply the planetary calculation-grid spectrum by the telluric
    transmission (ForwardModel_0.py:538-552). ``wave_calc`` is corrected
    for the target's Doppler velocity [km/s, positive toward the observer]
    before interpolation (reference correct_doppler_shift
    Measurement_0.py:2851): the telluric lines stay in the observatory's
    rest frame while the planetary grid is shifted."""
    if tel is None:
        return spec
    wave_tel, trans = telluric_transmission(tel)
    if WaveUnit(ispace) == WaveUnit.Wavenumber_cm:
        wavecorr = wave_calc * (1.0 - v_doppler * 1.0e3 / C_LIGHT)
    else:
        wavecorr = wave_calc * (1.0 + v_doppler * 1.0e3 / C_LIGHT)
    return spec * interp(wavecorr, wave_tel, trans)


def extract_atmosphere_circ() -> Atmosphere:
    """Earth atmosphere from the committed CIRC case-1 reference profile
    (reference Telluric_0.extract_atmosphere_circ:378, profile
    Data/reference_profiles/earth_circ_case1.ref), as float64 CPU
    tensors."""
    from archnemesis_tpu_torch.io.legacy import read_ref
    from archnemesis_tpu_torch.utils.datafiles import data_path

    return read_ref(data_path("reference_profiles", "earth_circ_case1.ref"))


# the 37 ERA5 pressure levels [hPa] (reference Telluric_0.py:211)
ERA5_PRESS_LEVELS_HPA = np.array([
    1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 125, 150, 175, 200, 225, 250,
    300, 350, 400, 450, 500, 550, 600, 650, 700, 750, 775, 800, 825, 850,
    875, 900, 925, 950, 975, 1000,
])

ERA5_VARIABLES = [
    "fraction_of_cloud_cover", "ozone_mass_mixing_ratio",
    "specific_cloud_liquid_water_content", "temperature",
    "specific_humidity",
]


def era5_request(date: str, time: str, latitude: float, longitude: float):
    """The Climate Data Store request the reference sends
    (Telluric_0.extract_atmosphere_era5:275-291): the 0.25-deg grid cell
    bracketing (lat, lon), the nearest whole hour, all 37 pressure levels.

    Returns ``(dataset, request_dict, press_pa_desc)`` where press_pa_desc
    is the level grid in Pa sorted max->min. Host code, needs no
    ``cdsapi``.
    """
    from datetime import datetime, timedelta

    lats = np.arange(-90.0, 90.0 + 0.25, 0.25)
    lons = np.arange(-180.0, 180.0 + 0.25, 0.25)
    ilat = int(np.argmin(np.abs(latitude - lats)))
    ilon = int(np.argmin(np.abs(longitude - lons)))
    ilats = [ilat - 1, ilat] if lats[ilat] > latitude else [ilat, ilat + 1]
    ilons = [ilon - 1, ilon] if lons[ilon] > longitude else [ilon, ilon + 1]
    lats_sel = lats[ilats]
    lons_sel = lons[ilons]

    dt = datetime.strptime(f"{date} {time}", "%d-%m-%Y %H:%M:%S")
    if dt.minute >= 30:
        dt = dt + timedelta(hours=1)
    dt = dt.replace(minute=0, second=0, microsecond=0)
    s = dt.strftime("%d-%m-%Y %H:%M:%S")
    day, month, year, hhmm = s[0:2], s[3:5], s[6:10], s[11:16]

    request = {
        "product_type": ["reanalysis"],
        "variable": list(ERA5_VARIABLES),
        "year": year,
        "month": month,
        "day": day,
        "time": hhmm,
        "pressure_level": [str(p) for p in ERA5_PRESS_LEVELS_HPA],
        "data_format": "grib",
        "download_format": "unarchived",
        "area": [lats_sel[0], lons_sel[0], lats_sel[1], lons_sel[1]],
    }
    isort = np.argsort(ERA5_PRESS_LEVELS_HPA)[::-1]
    press_pa = ERA5_PRESS_LEVELS_HPA[isort] * 100.0
    return "reanalysis-era5-pressure-levels", request, press_pa


def grib_interp_location(param_3d, latitudes, longitudes, latitude,
                         longitude):
    """Bilinearly interpolate a (2, 2, NLEV) grib parameter stack to the
    requested location (reference extract_grib_parameter:649-669)."""
    lat1, lat2 = latitudes[0, 0], latitudes[1, 0]
    lon1, lon2 = longitudes[0, 0], longitudes[1, 1]
    u = (latitude - lat1) / (lat2 - lat1)
    v = (longitude - lon1) / (lon2 - lon1)
    if u > 1.0 or v > 1.0:
        raise ValueError("requested location outside the fetched grid cell")
    p = np.asarray(param_3d)
    return ((1.0 - v) * (1.0 - u) * p[0, 0]
            + v * (1.0 - u) * p[0, 1]
            + u * (1.0 - v) * p[1, 0]
            + u * v * p[1, 1])


def era5_profiles_to_atmosphere(press_pa, temp, specific_humidity,
                                ozone_mmr, latitude: float,
                                longitude: float) -> Atmosphere:
    """ERA5 (P, T, q, O3-MMR) profiles -> Earth Atmosphere of float64 CPU
    tensors (reference Telluric_0.extract_atmosphere_era5:297-375):
    scale-height first-guess altitudes, q -> H2O VMR, O3 MMR -> VMR,
    CO2/N2O/CO/CH4/O2/N2 from the committed CIRC case-1 profile, then a
    hydrostatic altitude rebalance with Earth's gravity. Needs no
    ``cdsapi`` or ``pygrib``.
    """
    from archnemesis_tpu_torch.rt.atmosphere import adjust_hydrostat_h

    press = np.asarray(press_pa, dtype=float)
    temp = np.asarray(temp, dtype=float)

    g0, mmol, r_gas = 9.80665, 0.0289644, 8.31446
    sh = r_gas * temp / (mmol * g0)
    h = -np.log(press / press[0]) * sh

    q = np.asarray(specific_humidity, dtype=float)
    vmr_h2o = q / (1.0 - q)
    vmr_o3 = np.asarray(ozone_mmr, dtype=float) / 0.048 * mmol

    circ = extract_atmosphere_circ()
    circ_p = circ.p.numpy()[::-1]
    circ_vmr_all = circ.vmr.numpy()[::-1]

    def circ_vmr(gid):
        return np.interp(press, circ_p,
                         circ_vmr_all[:, list(circ.gas_id).index(gid)])

    nlev = press.size
    vmr = np.zeros((nlev, 8))
    vmr[:, 0] = vmr_h2o
    vmr[:, 1] = circ_vmr(2)  # CO2
    vmr[:, 2] = vmr_o3
    vmr[:, 3] = circ_vmr(4)  # N2O
    vmr[:, 4] = circ_vmr(5)  # CO
    vmr[:, 5] = circ_vmr(6)  # CH4
    vmr[:, 6] = circ_vmr(7)  # O2
    vmr[:, 7] = circ_vmr(22)  # N2

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64))

    atm = Atmosphere(
        h=t(h), p=t(press), t=t(temp), vmr=t(vmr),
        dust=t(np.zeros((nlev, 0))), parah2=t(np.zeros(nlev)),
        molwt=t(np.full(nlev, mmol)),
        radius=t(6.371e6), latitude=t(float(latitude)),
        gas_id=(1, 2, 3, 4, 5, 6, 7, 22),
        iso_id=(0, 0, 0, 0, 0, 0, 0, 0), planet=3,
    )
    return adjust_hydrostat_h(atm)


def extract_atmosphere_era5(date: str = "01-01-2020",
                            time: str = "00:00:00",
                            latitude: float = 19.82067,
                            longitude: float = -155.46806) -> Atmosphere:
    """ERA5-reanalysis Earth atmosphere at a location and time (reference
    Telluric_0.extract_atmosphere_era5:178): P/T/H2O/O3 from the Climate
    Data Store, the other species (CO2, N2O, CO, CH4, O2, N2) interpolated
    from the CIRC case-1 profile; an Atmosphere of float64 CPU tensors.

    Needs the optional ``cdsapi`` and ``pygrib`` packages (imported here,
    raising ``NotImplementedError`` with the offline routes when either is
    missing) and access to the Copernicus Climate Data Store, to which
    ``cdsapi`` makes the download. The request (``era5_request``), the grid
    interpolation (``grib_interp_location``) and the profile assembly
    (``era5_profiles_to_atmosphere``) are host functions that run without
    them.
    """
    import os
    import tempfile

    try:
        import cdsapi
        import pygrib
    except ImportError as e:
        raise NotImplementedError(
            "ERA5 extraction needs the optional `cdsapi` + `pygrib` "
            "packages and network access to the Copernicus Climate Data "
            "Store (https://cds.climate.copernicus.eu/api-how-to). "
            "Offline, use extract_atmosphere_circ() (the committed CIRC "
            "case-1 standard atmosphere), era5_profiles_to_atmosphere() on "
            "profiles already downloaded, or io.legacy.read_ref() on an "
            "Earth profile.") from e

    dataset, request, press_pa = era5_request(date, time, latitude,
                                              longitude)
    with tempfile.TemporaryDirectory() as tmp:
        grib = os.path.join(tmp, "download.grib")
        cdsapi.Client().retrieve(dataset, request, grib)

        wanted = {"Temperature": [], "Specific humidity": [],
                  "Ozone mass mixing ratio": []}
        latitudes = longitudes = None
        grbs = pygrib.open(grib)
        try:
            for grb in grbs:
                if grb.name in wanted:
                    if latitudes is None:
                        latitudes, longitudes = grb.latlons()
                    wanted[grb.name].append(grb.values)
        finally:
            grbs.close()

    isort = np.argsort(ERA5_PRESS_LEVELS_HPA)[::-1]

    def located(name):
        stack = np.stack(wanted[name], axis=-1)  # (2, 2, NLEV)
        return grib_interp_location(
            stack, latitudes, longitudes, latitude, longitude
        )[isort]

    return era5_profiles_to_atmosphere(
        press_pa, located("Temperature"), located("Specific humidity"),
        located("Ozone mass mixing ratio"), latitude, longitude,
    )
