"""HITRAN ``.par`` fixed-width line-list parsing, catalogue-id mapping and
TIPS partition functions.

Port of the JAX package's ``io/hitran.py`` (reference
``database/datatypes/fixed_width/hitran.py`` FormatHitran160/100 column
layout, ``database/mappings/hitran.py`` RADTRAN<->HITRAN isotopologue
mapping, ``Data/partition_functions/tips2025.h5``). The whole file is
decoded column by column: by the C++ decoder (``native/``) unless the
caller asks for the vectorised numpy decoder (``use_native=False``); both
give the same arrays. The line list it builds is host float64 numpy, the
input of kernel 2 (``ops/lbl.py``).

TIPS tables: the card's machine has no ``h5py``, so the port's
``TIPS_PATH`` is ``archnemesis_tpu_torch/data/tips2025.npz``, the export
of the JAX package's ``tips2025.h5`` (``export_tips``: every dataset under
its HDF5 path). ``read_tips`` reads either, by the path's suffix.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

from archnemesis_tpu_torch import native
from archnemesis_tpu_torch.constants import C2_CGS
from archnemesis_tpu_torch.io.linedata import LineList
from archnemesis_tpu_torch.utils.datafiles import data_file, gas_info

TIPS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "tips2025.npz",
)

# (name, start, stop) byte columns of the 160-char 2004+ format
# (reference FormatHitran160, fixed_width/hitran.py:3-53); the 100-char
# pre-2004 format shares the first 67 columns
_COLS_160 = [
    ("mol_id", 0, 2), ("local_iso_id", 2, 3),
    ("nu", 3, 15), ("sw", 15, 25), ("a", 25, 35),
    ("gamma_amb", 35, 40), ("gamma_self", 40, 45),
    ("elower", 45, 55), ("n_amb", 55, 59), ("delta_amb", 59, 67),
]


@lru_cache(maxsize=None)
def _mappings():
    with open(data_file("assets", "db_mappings.json")) as f:
        raw = json.load(f)
    return {
        name: {tuple(k): tuple(v) for k, v in pairs}
        for name, pairs in raw.items()
    }


def radtran_to_hitran(gas_id: int, iso_id: int):
    """(RADTRAN gas, iso) -> (HITRAN molecule, local iso) (reference
    database/mappings/hitran.py)."""
    m = _mappings()["radtran_to_hitran"].get((gas_id, iso_id))
    if m is None:
        raise KeyError(f"no HITRAN mapping for gas {gas_id} iso {iso_id}")
    return m


def radtran_to_geisa(gas_id: int, iso_id: int):
    """(RADTRAN gas, iso) -> (GEISA molecule, GEISA iso code) (reference
    database/mappings/geisa.py)."""
    m = _mappings()["radtran_to_geisa"].get((gas_id, iso_id))
    if m is None:
        raise KeyError(f"no GEISA mapping for gas {gas_id} iso {iso_id}")
    return m


def _iso_char_decode(col):
    """HITRAN local iso chars: '1'-'9', '0' means 10, 'A'-'Z' mean 11+."""
    out = np.empty(col.shape, dtype=np.int64)
    digits = (col >= ord("1")) & (col <= ord("9"))
    out[digits] = col[digits] - ord("0")
    out[col == ord("0")] = 10
    letters = col >= ord("A")
    out[letters] = col[letters] - ord("A") + 11
    return out


def read_buffer(path_or_bytes) -> bytes:
    """The bytes of a fixed-width file (or the bytes given) with "\\n" line
    ends and a final newline."""
    if isinstance(path_or_bytes, bytes):
        buf = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    buf = buf.replace(b"\r\n", b"\n")
    if not buf.endswith(b"\n"):
        buf += b"\n"
    return buf


def parse_par(path_or_bytes, line_width: int | None = None,
              use_native: bool | None = None):
    """Parse a HITRAN ``.par`` file into columnar numpy arrays.

    Handles the 160-char (2004+) and 100-char formats; the physics columns
    occupy the same first 67 bytes in both (reference FormatHitran160 /
    FormatHitran100). Line width is auto-detected from the first line when
    not given. Returns a dict of (N,) arrays.

    ``use_native=None`` or True decodes with the C++ decoder
    (``native/src/fixed_width.cpp``), which raises if it does not build;
    ``use_native=False`` takes the vectorised numpy decoder. Both give the
    same arrays bit for bit.
    """
    buf = read_buffer(path_or_bytes)
    if line_width is None:
        line_width = buf.index(b"\n")
    stride = line_width + 1
    n = len(buf) // stride
    if n * stride != len(buf):
        raise ValueError(
            f"ragged .par file: {len(buf)} bytes not divisible by "
            f"record width {stride}"
        )

    if use_native is None or use_native:
        cols = [
            (
                name, a, b,
                native.KIND_I32 if name == "mol_id"
                else native.KIND_ISO_CHAR if name == "local_iso_id"
                else native.KIND_F64,
            )
            for name, a, b in _COLS_160
        ]
        out = native.parse_fixed(buf, stride, cols)
        out["mol_id"] = out["mol_id"].astype(np.int64)
        out["local_iso_id"] = out["local_iso_id"].astype(np.int64)
        return out

    mat = np.frombuffer(buf, dtype=np.uint8).reshape(n, stride)

    def field(start, stop, dtype=float):
        w = stop - start
        col = np.ascontiguousarray(mat[:, start:stop]).view(f"S{w}").ravel()
        return col.astype(dtype)

    out = {}
    for name, a, b in _COLS_160:
        if name == "local_iso_id":
            out[name] = _iso_char_decode(mat[:, a:b].ravel().copy())
        elif name == "mol_id":
            out[name] = field(a, b, np.int64)
        else:
            out[name] = field(a, b, np.float64)
    return out


def _walk_h5(group, prefix=""):
    """(path, value) of every dataset under an h5py group."""
    import h5py

    for key, item in group.items():
        path = f"{prefix}{key}"
        if isinstance(item, h5py.Dataset):
            yield path, item[()]
        else:
            yield from _walk_h5(item, path + "/")


def export_tips(h5_path: str, npz_path: str) -> None:
    """Write every dataset of a tips2025-format HDF5 file to ``npz_path``
    under its HDF5 path (needs ``h5py``); strings are stored as bytes."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        arrays = {path: np.asarray(value) for path, value in _walk_h5(f)}
    np.savez_compressed(npz_path, **arrays)


def _pf_leaf(keys, prefix: str) -> str:
    """The first ``pf_data*`` leaf under ``prefix`` among ``keys``."""
    leaves = sorted({k[len(prefix):].split("/")[0] for k in keys
                     if k.startswith(prefix)})
    leaves = [k for k in leaves if k.startswith("pf_data")]
    if not leaves:
        raise KeyError(f"no partition function under {prefix!r}")
    return prefix + leaves[0]


def read_tips(pf_path: str, gas_id: int, iso_id: int):
    """Tabulated TIPS partition function (temp, q) for one isotopologue
    from a tips2025-format HDF5 file or its ``.npz`` export (reference
    default_pf_base Spectroscopy_0.py:70; layout
    partition_function/<MOL>/<iso>/pf_data_*), sorted by temperature."""
    name = gas_info()[str(gas_id)]["name"]
    prefix = f"partition_function/{name}/{max(iso_id, 1)}/"
    if str(pf_path).endswith(".npz"):
        with np.load(pf_path) as f:
            leaf = _pf_leaf(f.files, prefix)
            temp = np.asarray(f[leaf + "/temp"], dtype=np.float64)
            q = np.asarray(f[leaf + "/q"], dtype=np.float64)
    else:
        import h5py

        with h5py.File(pf_path, "r") as f:
            grp = f[prefix]
            key = sorted(k for k in grp.keys() if k.startswith("pf_data"))[0]
            g = grp[key]
            temp = np.asarray(g["temp"][()], dtype=np.float64)
            q = np.asarray(g["q"][()], dtype=np.float64)
    order = np.argsort(temp)
    return temp[order], q[order]


def assemble_linelist(gas_id: int, iso_id: int, t_ref: float, p_ref: float,
                      nu, sw, elower, broad, pf_temp, pf_q) -> LineList:
    """A LineList of (gas, iso) with the catalogue's mass and abundance
    (iso 0: the principal isotopologue's) and the stimulated-emission
    factor at ``t_ref``; the columns are sorted by ``nu`` already."""
    gi = gas_info()[str(gas_id)]
    iso = gi["isotope"][str(iso_id if iso_id != 0 else 1)]
    return LineList(
        gas_id=gas_id,
        iso_id=iso_id,
        mol_name=gi["name"],
        t_ref=t_ref,
        p_ref=p_ref,
        mass=float(iso["mass"]),
        abundance=float(iso["abun"]),
        nu=nu,
        sw=sw,
        elower=elower,
        stim_ref=1.0 - np.exp(-C2_CGS * nu / t_ref),
        broad=broad,
        pf_temp=pf_temp,
        pf_q=pf_q,
    )


def linelist_from_par(
    path,
    gas_id: int,
    iso_id: int,
    pf_path: str = TIPS_PATH,
    t_ref: float = 296.0,
    p_ref: float = 1.0,
    s_min: float = 0.0,
) -> LineList:
    """Build a LineList for one RADTRAN (gas, iso) straight from a HITRAN
    ``.par`` file (a path or its bytes) + TIPS partition functions.

    iso_id=0 selects every isotopologue of the molecule (abundance-weighted
    HITRAN intensities; partition function of the principal isotopologue,
    same convention as the reference's iso-0 handling).

    The .par format carries no self temperature-exponent or self shift;
    missing self-broadening parameters fall back to the air values
    (reference ans_line_data_file.py:455-465).
    """
    rec = parse_par(path)
    if iso_id == 0:
        mol, _ = radtran_to_hitran(gas_id, 1)
        mask = rec["mol_id"] == mol
    else:
        mol, liso = radtran_to_hitran(gas_id, iso_id)
        mask = (rec["mol_id"] == mol) & (rec["local_iso_id"] == liso)
    if s_min > 0.0:
        mask &= rec["sw"] >= s_min
    if not mask.any():
        raise ValueError(
            f"no lines for gas {gas_id} iso {iso_id} (HITRAN mol {mol})"
        )

    nu = rec["nu"][mask]
    order = np.argsort(nu)
    nu = nu[order]
    sw = rec["sw"][mask][order]
    elower = rec["elower"][mask][order]
    gamma_amb = rec["gamma_amb"][mask][order]
    n_amb = rec["n_amb"][mask][order]
    delta_amb = rec["delta_amb"][mask][order]
    gamma_self = rec["gamma_self"][mask][order]

    # fallbacks for missing self parameters
    m = ~np.isfinite(gamma_self) | (gamma_self == 0)
    gamma_self = np.where(m, gamma_amb, gamma_self)
    n_self = n_amb.copy()

    pf_temp, pf_q = read_tips(pf_path, gas_id, iso_id)
    broad = np.stack(
        [gamma_self, n_self, np.zeros_like(n_self),
         gamma_amb, n_amb, delta_amb]
    )
    return assemble_linelist(gas_id, iso_id, t_ref, p_ref, nu, sw, elower,
                             broad, pf_temp, pf_q)
