"""NEMESIS correlated-k (.kta) binary table reader.

Host-side numpy I/O: tables are read once, then stacked into tensors by
``core.spectra.KTables.from_tables``. Format mirrors the reference readers
(``Spectroscopy_0.py:2492`` read_ktahead, ``:2733`` read_ktable):
little-endian float32/int32 stream, k packed as float32 x 1e20.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from archnemesis_tpu_torch.utils.path_redirect import resolve_path

K_PACK_FACTOR = 1.0e20  # reference database/filetypes/lbltable.py:28


@dataclass
class KTableData:
    """One gas's k-table in physical units: k (nwave, ng, npress, ntemp)
    in cm^2 molecule^-1, press in atm, temp in K."""

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
