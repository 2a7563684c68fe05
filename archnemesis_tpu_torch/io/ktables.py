"""NEMESIS correlated-k (.kta) and line-by-line (.lta) binary tables.

Host-side numpy I/O: tables are read once, then stacked into tensors by
``core.spectra.KTables.from_tables``. Format mirrors the reference readers
(``Spectroscopy_0.py:2492`` read_ktahead, ``:2733`` read_ktable, ``:2451``
read_ltahead, ``:2626`` read_lbltable) and writers (``:2951``
write_ktable, ``:2856`` write_lbltable): little-endian float32/int32
stream, k packed as float32 x 1e20.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from archnemesis_tpu_torch.utils.path_redirect import resolve_path

K_PACK_FACTOR = 1.0e20  # reference database/filetypes/lbltable.py:28


@dataclass
class KTableData:
    """One gas's k-table (or line-by-line table, ng = 1) in physical units:
    k (nwave, ng, npress, ntemp) in cm^2 molecule^-1, press in atm, temp
    in K."""

    gas_id: int
    iso_id: int
    wave: np.ndarray
    fwhm: float
    g_ord: np.ndarray
    del_g: np.ndarray
    press: np.ndarray
    temp: np.ndarray
    k: np.ndarray


def _resolve_path(path: str, base: str, redirects=()) -> str:
    """Rewrite + resolve a table location: apply the first matching
    (prefix, replacement) of ``redirects``, longest prefix first, then the
    process-wide rewrites of ``utils.path_redirect``, and anchor a relative
    path at ``base`` (the deck directory)."""
    for prefix, repl in sorted(redirects, key=lambda kv: len(kv[0]),
                               reverse=True):
        if path.startswith(prefix):
            path = repl + path[len(prefix):]
            break
    return resolve_path(path, base)


def _read_kta_header(f):
    irec0 = int(np.fromfile(f, dtype="<i4", count=1)[0])
    nwave = int(np.fromfile(f, dtype="<i4", count=1)[0])
    vmin = np.round(np.float64(np.fromfile(f, dtype="<f4", count=1)[0]), 7)
    delv = np.round(np.float64(np.fromfile(f, dtype="<f4", count=1)[0]), 7)
    fwhm = float(np.fromfile(f, dtype="<f4", count=1)[0])
    npress = int(np.fromfile(f, dtype="<i4", count=1)[0])
    ntemp = int(np.fromfile(f, dtype="<i4", count=1)[0])
    ng = int(np.fromfile(f, dtype="<i4", count=1)[0])
    gas_id = int(np.fromfile(f, dtype="<i4", count=1)[0])
    iso_id = int(np.fromfile(f, dtype="<i4", count=1)[0])
    g_ord = np.fromfile(f, dtype="<f4", count=ng).astype(np.float64)
    del_g = np.fromfile(f, dtype="<f4", count=ng).astype(np.float64)
    np.fromfile(f, dtype="<f4", count=2)  # legacy padding
    press = np.fromfile(f, dtype="<f4", count=npress).astype(np.float64)
    temp = np.fromfile(f, dtype="<f4", count=ntemp).astype(np.float64)
    if delv > 0.0:
        wave = np.linspace(vmin, delv * (nwave - 1) + vmin, nwave)
    else:
        wave = np.fromfile(f, dtype="<f4", count=nwave).astype(np.float64)
    return (irec0, fwhm, npress, ntemp, ng, gas_id, iso_id, g_ord, del_g,
            press, temp, wave)


def read_kta(path: str, wavemin: float = -np.inf,
             wavemax: float = np.inf) -> KTableData:
    """Read a .kta table, keeping only waves in [wavemin, wavemax]
    (the reference's windowed read, Spectroscopy_0.py:2733)."""
    if not path.endswith(".kta"):
        path += ".kta"
    with open(path, "rb") as f:
        (irec0, fwhm, npress, ntemp, ng, gas_id, iso_id,
         g_ord, del_g, press, temp, wave) = _read_kta_header(f)
        sel = np.where((wave >= wavemin) & (wave <= wavemax))[0]
        if sel.size == 0:
            raise ValueError(
                f"{path}: no table waves in [{wavemin}, {wavemax}]"
            )
        f.seek((npress * ntemp * ng * sel[0] + (irec0 - 1)) * 4, 0)
        raw = np.fromfile(f, dtype="<f4",
                          count=sel.size * npress * ntemp * ng)
    k = (raw.astype(np.float64).reshape(sel.size, npress, ntemp, ng)
         / K_PACK_FACTOR)
    # (nwave, npress, ntemp, ng) -> (nwave, ng, npress, ntemp)
    k = np.transpose(k, (0, 3, 1, 2))
    return KTableData(
        gas_id=gas_id,
        iso_id=iso_id,
        wave=wave[sel],
        fwhm=fwhm,
        g_ord=g_ord,
        del_g=del_g,
        press=press,
        temp=temp,
        k=k,
    )


def read_kls(path: str, wavemin=-np.inf, wavemax=np.inf, redirects=()):
    """Read a .kls file (one .kta location per line; reference
    Spectroscopy_0.py read_kls:1249) and load every table. ``redirects``:
    (prefix, replacement) rewrites of the listed locations."""
    base = os.path.dirname(os.path.abspath(path))
    tables = []
    with open(path) as f:
        for line in f:
            name = line.strip()
            if not name:
                continue
            tables.append(read_kta(_resolve_path(name, base, redirects),
                                   wavemin, wavemax))
    return tables


def read_lta(path: str, wavemin: float = -np.inf,
             wavemax: float = np.inf) -> KTableData:
    """Read a .lta line-by-line table (ng = 1), keeping only waves in
    [wavemin, wavemax] (reference read_lbltable Spectroscopy_0.py:2626).
    The float32 header's vmin and delv are rounded to 7 decimals before the
    grid is built, as the JAX package and the reference build it."""
    if not path.endswith(".lta"):
        path += ".lta"
    with open(path, "rb") as f:
        irec0 = int(np.fromfile(f, dtype="<i4", count=1)[0])
        nwave = int(np.fromfile(f, dtype="<i4", count=1)[0])
        vmin = np.round(np.float64(np.fromfile(f, dtype="<f4", count=1)[0]), 7)
        delv = np.round(np.float64(np.fromfile(f, dtype="<f4", count=1)[0]), 7)
        npress = int(np.fromfile(f, dtype="<i4", count=1)[0])
        ntemp = int(np.fromfile(f, dtype="<i4", count=1)[0])
        gas_id = int(np.fromfile(f, dtype="<i4", count=1)[0])
        iso_id = int(np.fromfile(f, dtype="<i4", count=1)[0])
        press = np.fromfile(f, dtype="<f4", count=npress).astype(np.float64)
        temp = np.fromfile(f, dtype="<f4", count=ntemp).astype(np.float64)
        wave = np.linspace(vmin, delv * (nwave - 1) + vmin, nwave)
        sel = np.where((wave >= wavemin) & (wave <= wavemax))[0]
        if sel.size == 0:
            raise ValueError(
                f"{path}: no table waves in [{wavemin}, {wavemax}]")
        f.seek((npress * ntemp * sel[0] + (irec0 - 1)) * 4, 0)
        raw = np.fromfile(f, dtype="<f4", count=sel.size * npress * ntemp)
    k = raw.astype(np.float64).reshape(sel.size, npress, ntemp) / K_PACK_FACTOR
    return KTableData(
        gas_id=gas_id,
        iso_id=iso_id,
        wave=wave[sel],
        fwhm=0.0,
        g_ord=np.array([0.0]),
        del_g=np.array([1.0]),
        press=press,
        temp=temp,
        k=k[:, None, :, :],
    )


def read_lls(path: str, wavemin=-np.inf, wavemax=np.inf, redirects=()):
    """Read a .lls file of .lta tables (ILBL = 2, one location per line)
    and load every table; ``redirects`` as in ``read_kls``."""
    base = os.path.dirname(os.path.abspath(path))
    tables = []
    with open(path) as f:
        for line in f:
            name = line.strip()
            if not name:
                continue
            tables.append(read_lta(_resolve_path(name, base, redirects),
                                   wavemin, wavemax))
    return tables


def write_kta(path: str, gas_id: int, iso_id: int, g_ord, del_g, press,
              temp, wave, k, fwhm: float = 0.0):
    """Write a .kta correlated-k table (binary layout of the reference
    write_ktable Spectroscopy_0.py:2951: header, g/P/T grids, then float32
    packed k in wave -> press -> temp -> g order).

    k: (NWAVE, NG, NPRESS, NTEMP) [cm^2], a host array or a tensor; a
    uniform wave grid is stored as (vmin, delv), any other explicitly
    (delv = -1).
    """
    if not path.endswith(".kta"):
        path += ".kta"
    wave = np.asarray(wave, dtype=np.float64)
    ng, npress, ntemp, nwave = len(g_ord), len(press), len(temp), len(wave)
    dv = np.diff(wave)
    uniform = nwave > 1 and np.allclose(dv, dv[0], rtol=1e-6)
    delv = float(dv[0]) if uniform else -1.0
    irec0 = 10 + 2 * ng + 3 + npress + ntemp + (0 if uniform else nwave)
    with open(path, "wb") as f:
        np.int32(irec0).tofile(f)
        np.int32(nwave).tofile(f)
        np.float32(wave[0]).tofile(f)
        np.float32(delv).tofile(f)
        np.float32(fwhm).tofile(f)
        np.int32(npress).tofile(f)
        np.int32(ntemp).tofile(f)
        np.int32(ng).tofile(f)
        np.int32(gas_id).tofile(f)
        np.int32(iso_id).tofile(f)
        np.asarray(g_ord, dtype="<f4").tofile(f)
        np.asarray(del_g, dtype="<f4").tofile(f)
        np.zeros(2, dtype="<f4").tofile(f)
        np.asarray(press, dtype="<f4").tofile(f)
        np.asarray(temp, dtype="<f4").tofile(f)
        if not uniform:
            np.asarray(wave, dtype="<f4").tofile(f)
        packed = np.transpose(_host(k) * K_PACK_FACTOR,
                              (0, 2, 3, 1))  # wave, press, temp, g
        packed.astype("<f4").tofile(f)


def write_lta(path: str, gas_id: int, iso_id: int, press, temp, vmin: float,
              delv: float, k):
    """Write a .lta line-by-line table (reference write_lbltable
    Spectroscopy_0.py:2856). k: (NWAVE, NPRESS, NTEMP) [cm^2], a host
    array or a tensor."""
    if not path.endswith(".lta"):
        path += ".lta"
    k = _host(k)
    npress, ntemp = len(press), len(temp)
    irec0 = 9 + npress + ntemp
    with open(path, "wb") as f:
        np.int32(irec0).tofile(f)
        np.int32(k.shape[0]).tofile(f)
        np.float32(vmin).tofile(f)
        np.float32(delv).tofile(f)
        np.int32(npress).tofile(f)
        np.int32(ntemp).tofile(f)
        np.int32(gas_id).tofile(f)
        np.int32(iso_id).tofile(f)
        np.asarray(press, dtype="<f4").tofile(f)
        np.asarray(temp, dtype="<f4").tofile(f)
        (k * K_PACK_FACTOR).astype("<f4").tofile(f)


def _host(x) -> np.ndarray:
    """A table body as host float64, from a tensor or an array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)
