"""Paths and loaders of the committed data files the port reads.

The counterpart of the JAX package's ``data/__init__.py`` (the JSON
physics assets: gas and isotope masses, planetary constants,
saturation-vapour-pressure coefficients; ``gas_name``, ``calc_mmw``) and
``data/datadir.py`` (``data_root``, ``data_path``, ``find_table``: the
reference-data tree of CIA tables, stellar spectra and Earth profiles).
The port reads (never writes) the data files that ship with the JAX
package under ``archnemesis_tpu/data/``, by path: this is a file read, not
an import of that package. The port's own ``data/`` directory holds the
exports and tables that the card's machine reads without h5py.
"""

import json
import os
from functools import lru_cache

DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "archnemesis_tpu", "data",
)


def data_file(*parts: str) -> str:
    """Path of one committed data file, e.g. ``data_file("assets",
    "cia_bands.npz")``; raises if it is absent."""
    path = os.path.join(DATA_ROOT, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return path


def data_root() -> str:
    """Directory holding ``cia/``, ``stellar/`` and ``reference_profiles/``:
    ``$ARCHNEMESIS_TPU_DATA`` if set, else the committed assets."""
    return os.environ.get("ARCHNEMESIS_TPU_DATA",
                          os.path.join(DATA_ROOT, "reference_data"))


def data_path(*parts: str) -> str:
    """Path under the reference-data tree (``data_root()``)."""
    return os.path.join(data_root(), *parts)


def find_table(name: str, kind: str, base_dir: str = ".") -> str:
    """Resolve a table name from a deck file: absolute paths win, then a
    path relative to the deck directory, then the reference-data tree
    (``data_path(kind, name)``)."""
    if os.path.isabs(name):
        return name
    local = os.path.join(base_dir, name)
    if os.path.exists(local):
        return local
    return data_path(kind, name)


@lru_cache(maxsize=None)
def _load_asset(name):
    with open(data_file("assets", name + ".json")) as f:
        return json.load(f)


def gas_info():
    """Dict keyed by str(gas_id) with name / isotope masses / mean mol weight."""
    return _load_asset("gas_info")


def planet_info():
    """Dict keyed by str(planet_id) with mass, radius, flattening, J coeffs."""
    return _load_asset("planet_info")


def gas_name(gas_id: int, iso_id: int = 0) -> str:
    """The gas's name, or its isotopologue's when ``iso_id`` is not 0."""
    gi = gas_info()[str(gas_id)]
    if iso_id == 0:
        return gi["name"]
    return gi["isotope"][str(iso_id)]["name"]


def molecular_weight(gas_id: int, iso_id: int = 0) -> float:
    """Molar mass (g/mol) of a gas (iso_id=0: abundance-weighted mean).
    Unknown isotopologue ids fall back to the gas mean (some legacy decks
    reference isotopes absent from the catalogue)."""
    gi = gas_info()[str(gas_id)]
    if iso_id == 0 or str(iso_id) not in gi["isotope"]:
        return gi["mmw"]
    return gi["isotope"][str(iso_id)]["mass"]


def calc_mmw(vmr, ids, isos=None) -> float:
    """Mean molecular weight (g/mol) for volume mixing ratios ``vmr`` of
    gases ``ids`` (reference ``Data/gas_data.py:38``, Calc_mmw): each gas
    weighs its terrestrial-abundance mean molar mass; ``isos`` is accepted
    and not used, as there."""
    del isos
    total = 0.0
    for i, gid in enumerate(ids):
        total += vmr[i] * molecular_weight(int(gid), 0)
    return total


def svp_coefficients():
    """Antoine-style saturation-vapour-pressure coefficients (a, b, c, d)
    per gas id: svp[atm] = vp * exp(a + b/T + c T + d T^2) (reference
    Data/gas_data.py:3454)."""
    return _load_asset("svp_coefficients")
