"""Stellar spectrum I/O + derived quantities (reference ``Stellar_0``).

Port of the JAX package's ``io/stellar.py``. The ``StellarSpec`` structure
(core/spectra.py) holds CPU tensors here; this module holds the host-side
file formats: ``.sol`` run files in both reference variants (named
Data/stellar file, or ``-1`` inline spectrum; Stellar_0.read_sol:305) and
the stellar-spectrum data file layout itself, plus blackbody luminosity
(calc_luminosity_blackbody:448) and flux-at-planet conversion
(calc_solar_flux:429), and the HDF5 ``Stellar`` group (Stellar_0.read_hdf5
:290) of a run file or of its ``.npz`` export (``io/hdf5.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from archnemesis_tpu_torch.core.spectra import StellarSpec

AU_CM = 1.49598e11 * 100.0


def _read_spectrum_stream(lines):
    """ispace flag, stellar radius [km], then (wave, power) rows."""
    ispace = int(float(lines[0].split()[0]))
    radius = float(lines[1].split()[0])
    data = np.array(
        [[float(x) for x in ln.split()[:2]] for ln in lines[2:] if ln.split()]
    )
    return ispace, radius, data


def read_solar_file(path: str):
    """One stellar-spectrum data file (layout of the reference's
    Data/stellar/*.txt: '#' comment header, ispace, radius, rows)."""
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    return _read_spectrum_stream(lines)


def read_sol(path: str, dist: float, stellar_data_dir: str | None = None) -> StellarSpec:
    """Read a ``runname.sol`` file (reference Stellar_0.read_sol:305).

    Two variants: the single line names a spectrum file (resolved against
    ``stellar_data_dir``), or the first token is ``-1`` and the spectrum
    follows inline in the same file.
    """
    with open(path) as f:
        lines = f.readlines()
    name = lines[0].split()[0]
    if name == "-1":
        ispace, radius, data = _read_spectrum_stream(lines[1:])
    else:
        if stellar_data_dir is None:
            raise ValueError(
                f"{path} names stellar file {name!r} but no "
                "stellar_data_dir was given"
            )
        ispace, radius, data = read_solar_file(
            os.path.join(stellar_data_dir, name)
        )
    return StellarSpec(
        wave=torch.as_tensor(np.ascontiguousarray(data[:, 0])),
        solspec=torch.as_tensor(np.ascontiguousarray(data[:, 1])),
        dist=torch.as_tensor(float(dist), dtype=torch.float64),
        radius=torch.as_tensor(float(radius), dtype=torch.float64),
        solexist=True, ispace=ispace,
    )


def write_solar_file(path: str, spec: StellarSpec, header: str | None = None):
    """Write a stellar-spectrum data file (reference write_solar_file:464)."""
    with open(path, "w") as f:
        if header:
            for ln in header.splitlines():
                f.write(f"# {ln}\n")
        f.write(f"{int(spec.ispace)}\n")
        f.write(f"{float(spec.radius):.6e}\n")
        for w, s in zip(_np(spec.wave), _np(spec.solspec)):
            f.write(f"{w:.8e} {s:.8e}\n")


def write_sol(path: str, spec: StellarSpec):
    """Write a ``runname.sol`` in the inline (-1) variant
    (reference write_sol:395)."""
    with open(path, "w") as f:
        f.write("-1\n")
        f.write(f"{int(spec.ispace)}\n")
        f.write(f"{float(spec.radius):.6e}\n")
        for w, s in zip(_np(spec.wave), _np(spec.solspec)):
            f.write(f"{w:.8e} {s:.8e}\n")


def read_stellar_hdf5(h5path: str) -> StellarSpec | None:
    """HDF5 ``Stellar`` group of a run file (or of its ``.npz`` export,
    ``io.hdf5.export_deck_hdf5``) -> StellarSpec (reference read_hdf5:290).
    Returns None when the group is absent or SOLEXIST is false."""
    from archnemesis_tpu_torch.io.hdf5 import read_run_groups

    return stellar_from_group(read_run_groups(h5path).get("Stellar"))


def write_stellar_hdf5(h5path: str, spec: StellarSpec):
    """StellarSpec -> the run file's ``Stellar`` group (reference
    write_hdf5:175); needs h5py."""
    import h5py

    with h5py.File(h5path, "a") as f:
        if "Stellar" in f:
            del f["Stellar"]
        g = f.create_group("Stellar")
        g["SOLEXIST"] = bool(spec.solexist)
        g["DIST"] = float(_np(spec.dist))
        if spec.solexist:
            g["ISPACE"] = int(spec.ispace)
            g["RADIUS"] = float(_np(spec.radius))
            g["NWAVE"] = int(_np(spec.wave).shape[0])
            g["WAVE"] = np.asarray(_np(spec.wave), dtype=float)
            g["SOLSPEC"] = np.asarray(_np(spec.solspec), dtype=float)


def stellar_from_group(g) -> StellarSpec | None:
    """A ``Stellar`` group (a dict of host arrays) -> StellarSpec as float64
    CPU tensors, or None when it is absent or SOLEXIST is false."""
    if g is None:
        return None
    solexist = bool(np.asarray(g["SOLEXIST"][()])) if "SOLEXIST" in g else False
    if not solexist:
        return None
    dist = float(g["DIST"][()]) if "DIST" in g else 0.0
    radius = float(g["RADIUS"][()]) if "RADIUS" in g else 0.0
    return StellarSpec(
        wave=torch.as_tensor(np.asarray(g["WAVE"][()], dtype=np.float64)),
        solspec=torch.as_tensor(np.asarray(g["SOLSPEC"][()],
                                           dtype=np.float64)),
        dist=torch.as_tensor(dist, dtype=torch.float64),
        radius=torch.as_tensor(radius, dtype=torch.float64),
        solexist=True,
        ispace=int(g["ISPACE"][()]) if "ISPACE" in g else 0,
    )


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def calc_solar_flux(spec: StellarSpec):
    """Stellar flux at the planet distance, W cm-2 (cm-1)-1 or W cm-2 um-1
    (reference calc_solar_flux:429); numpy."""
    area = 4.0 * np.pi * (_np(spec.dist) * AU_CM) ** 2
    return _np(spec.solspec) / area


def calc_solar_power(solflux, dist):
    """Inverse of calc_solar_flux: measured flux at ``dist`` AU -> stellar
    spectral power (reference calc_solar_power:439)."""
    area = 4.0 * np.pi * (np.asarray(dist) * AU_CM) ** 2
    return np.asarray(solflux) * area


def luminosity_blackbody(spec: StellarSpec, temperature: float) -> StellarSpec:
    """Replace the power spectrum with a blackbody at the star's radius
    (reference calc_luminosity_blackbody:448; radius attribute in km)."""
    from archnemesis_tpu_torch.ops.planck import planck

    r_cm = float(spec.radius) * 1e5
    bb = planck(spec.wave, torch.as_tensor(temperature, dtype=spec.wave.dtype,
                                           device=spec.wave.device),
                ispace=spec.ispace)
    lum = np.pi * 4.0 * np.pi * r_cm**2 * bb
    return spec.replace(solspec=lum, solexist=True)
