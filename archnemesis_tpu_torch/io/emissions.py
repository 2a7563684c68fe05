"""Readers and writer of emission look-up table files.

Port of the JAX package's ``io/emissions.py``. The file format is the
reference's (``Emissions_0.write_table_hdf5`` ``Emissions_0.py:432``): one
file per emission with datasets NGAS/ID/ISO/EMTYPE/ISPACE/NWAVE/WAVE/NT/
TEMP/K/RATE_COEFF/DIST_REF. The run file's ``Emissions`` group
(``Emissions_0.py:205-270``) carries NEM and LOCATION only; all table
content lives in the per-emission files.

A machine without ``h5py`` reads a table's ``.npz`` export
(``io.hdf5.export_deck_hdf5`` of the table file: every dataset under its
name); the reader picks the format by the file's suffix, and ``h5py`` is
imported only to read or write a ``.h5``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from archnemesis_tpu_torch.core.emissions import EmissionTables
from archnemesis_tpu_torch.enums import EmissionType, WaveUnit
from archnemesis_tpu_torch.io.hdf5 import _read_flat, _text, read_run_groups


def _first(v):
    return np.atleast_1d(np.asarray(v)).ravel()[0].item()


def _table_file(path: str, base_dir: str) -> str:
    fn = path if path.endswith((".h5", ".npz")) else path + ".h5"
    if base_dir and not os.path.isabs(fn):
        fn = os.path.join(base_dir, fn)
    return fn


def read_emission_tables(paths: Sequence[str],
                         base_dir: str = "") -> EmissionTables:
    """Load per-emission table files (``.h5`` or their ``.npz`` exports)
    and stack them into EmissionTables of float64 CPU tensors.

    The reference ``read_header_table_hdf5`` (``Emissions_0.py:365``) + the
    per-call K/RATE_COEFF reads inside ``calc_rates_hdf5``
    (``Emissions_0.py:273``): the tables are small (NWAVE x NT), so they
    are loaded once up front. All tables must share the same WAVE/TEMP
    grids and spectral unit (``Emissions_0.py:407-417``).
    """
    wave = temp = ispace = None
    ks, cs, emtypes, gas_ids, iso_ids, dist_refs = [], [], [], [], [], []
    for p in paths:
        f = _read_flat(_table_file(p, base_dir))
        if int(_first(f["NGAS"])) != 1:
            # the reference forward model's restriction
            # (ForwardModel_0.py:4050-4058)
            raise NotImplementedError("only single-gas emissions are supported")
        w = np.asarray(f["WAVE"], dtype=np.float64)
        t = np.asarray(f["TEMP"], dtype=np.float64)
        isp = WaveUnit(int(_first(f["ISPACE"])))
        if wave is None:
            wave, temp, ispace = w, t, isp
        else:
            if w.shape != wave.shape or not np.allclose(w, wave):
                raise ValueError("all emission tables must share WAVE")
            if not np.allclose(t, temp):
                raise ValueError("all emission tables must share TEMP")
            if isp != ispace:
                raise ValueError("all emission tables must share ISPACE")
        ks.append(np.asarray(f["K"], dtype=np.float64))
        cs.append(np.asarray(f["RATE_COEFF"], dtype=np.float64)
                  if "RATE_COEFF" in f else np.ones_like(t))
        emtypes.append(EmissionType(int(_first(f["EMTYPE"]))))
        gas_ids.append(int(_first(f["ID"])))
        iso_ids.append(int(_first(f["ISO"])))
        dist_refs.append(float(_first(f["DIST_REF"])))

    return EmissionTables(
        wave=torch.as_tensor(wave),
        temp=torch.as_tensor(temp),
        k=torch.as_tensor(np.stack(ks, axis=-1)),
        rate_coeff=torch.as_tensor(np.stack(cs, axis=-1)),
        dist_ref=torch.as_tensor(np.asarray(dist_refs, dtype=np.float64)),
        emtype=tuple(emtypes),
        gas_id=tuple(gas_ids),
        iso_id=tuple(iso_ids),
        ispace=ispace,
    )


def read_emissions_group(runfile: str) -> EmissionTables | None:
    """Read the ``Emissions`` group of a run file (or of its ``.npz``
    export) and load the table files it names, relative to the run file's
    directory (reference ``Emissions_0.read_hdf5`` ``Emissions_0.py:237``).
    Returns None when the group is absent or NEM=0."""
    grp = read_run_groups(runfile).get("Emissions")
    if grp is None:
        return None
    nem = int(_first(grp["NEM"])) if "NEM" in grp else 0
    if nem <= 0:
        return None
    locations = [_text(s) for s in np.atleast_1d(grp["LOCATION"])]
    return read_emission_tables(locations,
                                base_dir=os.path.dirname(runfile))


def write_emission_table(path: str, *, gas_id: int, iso_id: int,
                         emtype: EmissionType, ispace: WaveUnit,
                         wave: np.ndarray, temp: np.ndarray, k: np.ndarray,
                         dist_ref: float, rate_coeff: np.ndarray | None = None):
    """Write one emission table file in the reference's format
    (``Emissions_0.write_table_hdf5`` ``Emissions_0.py:432``); needs
    h5py."""
    import h5py

    fn = path if path.endswith(".h5") else path + ".h5"
    if os.path.exists(fn):
        os.remove(fn)
    with h5py.File(fn, "w") as f:
        f.create_dataset("NGAS", data=np.int32(1))
        f.create_dataset("ID", data=np.asarray([gas_id], dtype="int32"))
        f.create_dataset("ISO", data=np.asarray([iso_id], dtype="int32"))
        f.create_dataset("EMTYPE", data=np.int32(int(emtype)))
        f.create_dataset("ISPACE", data=np.int32(int(ispace)))
        f.create_dataset("NWAVE", data=np.int32(len(wave)))
        f.create_dataset("WAVE", data=np.asarray(wave, dtype=np.float64))
        f.create_dataset("NT", data=np.int32(len(temp)))
        f.create_dataset("TEMP", data=np.asarray(temp, dtype=np.float64))
        f.create_dataset("K", data=np.asarray(k, dtype=np.float64))
        if emtype != EmissionType.FLUORESCENCE:
            if rate_coeff is None:
                raise ValueError(
                    "chemical/photolysis emissions require rate_coeff")
            f.create_dataset("RATE_COEFF",
                             data=np.asarray(rate_coeff, dtype=np.float64))
        f.create_dataset("DIST_REF", data=np.float64(dist_ref))
