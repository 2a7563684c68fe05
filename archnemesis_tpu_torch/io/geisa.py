"""GEISA fixed-width line-record ingestion.

Port of the JAX package's ``io/geisa.py``. The reference carries the
RADTRAN<->GEISA isotopologue mapping (``database/mappings/geisa.py``) and
a GEISA gas descriptor but no record parser; this module reads the records
into a line list that kernel 2 consumes. Decoding shares the HITRAN
reader's machinery (``io/hitran.py``, the C++ decoder of ``native/``).

The default column table follows the GEISA-2015/2020 line-parameter
sub-database layout (Jacquinet-Husson et al. 2016, JMS 327; Delahaye et
al. 2021) for the fields the LBL physics consumes. GEISA vintages have
shuffled trailing columns over the years, so the table is data: pass a
``fields`` override (same ``(name, start, stop)`` convention) for another
vintage; ``format_geisa_records`` writes records with the active table.
"""

from __future__ import annotations

import numpy as np

from archnemesis_tpu_torch import native
from archnemesis_tpu_torch.io.hitran import (
    TIPS_PATH,
    assemble_linelist,
    radtran_to_geisa,
    read_buffer,
    read_tips,
)
from archnemesis_tpu_torch.io.linedata import LineList

# (name, start, stop) byte columns, GEISA-2015/2020 line-parameter record.
# Fields A-D are fixed across vintages; E is the 25-char transition
# description; F/G are the GEISA isotope/molecule codes; I-O carry the
# Einstein A, temperature exponent, self-broadening and air shift.
GEISA_COLS = [
    ("nu", 0, 12),            # A  F12.6  wavenumber [cm-1]
    ("sw", 12, 23),           # B  D11.4  intensity at 296 K
    ("gamma_air", 23, 29),    # C  F6.4   air-broadened HWHM
    ("elower", 29, 39),       # D  F10.4  lower-state energy [cm-1]
    ("transition", 39, 64),   # E  A25    quantum identification (unused)
    ("iso_code", 64, 67),     # F  I3     GEISA isotope code
    ("mol_id", 67, 70),       # G  I3     GEISA molecule number
    ("internal", 70, 73),     # H  A3     internal GEISA code (unused)
    ("a_einstein", 73, 83),   # I  D10.3  Einstein A [s-1] (unused here)
    ("n_air", 83, 87),        # J  F4.2   air temperature exponent
    ("delta_air", 87, 96),    # K  F9.6   air pressure shift [cm-1 atm-1]
    ("gamma_self", 96, 103),  # N  F7.4   self-broadened HWHM
    ("n_self", 103, 107),     # O  F4.2   self temperature exponent
]
_NUMERIC = {
    "nu", "sw", "gamma_air", "elower", "a_einstein", "n_air",
    "delta_air", "gamma_self", "n_self",
}
_INT = {"iso_code", "mol_id"}
# decimals written by format_geisa_records per fixed-point field
_DECIMALS = {"nu": 6, "gamma_air": 4, "elower": 4, "n_air": 2,
             "delta_air": 6, "gamma_self": 4, "n_self": 2}


def parse_geisa(path_or_bytes, fields=None, use_native: bool | None = None):
    """Parse GEISA fixed-width records into columnar numpy arrays.

    Record width is taken from the first line (GEISA pads every record to
    a constant width). Returns a dict of (N,) arrays for the numeric /
    integer fields of the active column table. ``use_native=None`` or True
    decodes with the C++ decoder (raises if it does not build), False with
    numpy; the arrays are the same.
    """
    fields = GEISA_COLS if fields is None else fields
    buf = read_buffer(path_or_bytes)
    width = buf.index(b"\n")
    stride = width + 1
    n = len(buf) // stride
    if n * stride != len(buf):
        raise ValueError(
            f"ragged GEISA file: {len(buf)} bytes not divisible by "
            f"record width {stride}"
        )
    wanted = [
        (name, a, b) for name, a, b in fields
        if name in _NUMERIC or name in _INT
    ]
    for name, a, b in wanted:
        if b > width:
            raise ValueError(
                f"GEISA field {name} spans bytes {a}:{b} but records are "
                f"only {width} wide — wrong vintage table? pass fields="
            )

    if use_native is None or use_native:
        cols = [
            (name, a, b,
             native.KIND_I32 if name in _INT else native.KIND_F64)
            for name, a, b in wanted
        ]
        out = native.parse_fixed(buf, stride, cols)
        for name in _INT:
            if name in out:
                out[name] = out[name].astype(np.int64)
        return out

    mat = np.frombuffer(buf, dtype=np.uint8).reshape(n, stride)
    out = {}
    for name, a, b in wanted:
        w = b - a
        col = np.ascontiguousarray(mat[:, a:b]).view(f"S{w}").ravel()
        # GEISA writes Fortran D-exponents; numpy accepts E only
        if name in _NUMERIC:
            vals = np.char.replace(
                np.char.replace(col, b"D", b"E"), b"d", b"e"
            )
            out[name] = vals.astype(np.float64)
        else:
            out[name] = col.astype(np.int64)
    return out


def format_geisa_records(rec: dict, fields=None) -> bytes:
    """Inverse of :func:`parse_geisa` for the numeric/int fields: records
    in the active vintage layout (test and benchmark catalogues)."""
    fields = GEISA_COLS if fields is None else fields
    width = max(b for _, _, b in fields)
    n = len(next(iter(rec.values())))
    rows = []
    for i in range(n):
        row = bytearray(b" " * width)
        for name, a, b in fields:
            if name not in rec:
                continue
            w = b - a
            v = rec[name][i]
            if name in _INT:
                s = f"{int(v):>{w}d}"
            elif name == "sw" or name == "a_einstein":
                s = f"{float(v):>{w}.4E}".replace("E", "D")
            else:
                s = f"{float(v):>{w}.{_DECIMALS.get(name, 4)}f}"
                if len(s) > w:  # overflow: drop decimals to fit
                    s = f"{float(v):>{w}.{max(0, w - 8)}f}"[:w]
            row[a:b] = s[-w:].encode().ljust(w)[:w]
        rows.append(bytes(row))
    return b"\n".join(rows) + b"\n"


def linelist_from_geisa(
    path,
    gas_id: int,
    iso_id: int,
    pf_path: str = TIPS_PATH,
    t_ref: float = 296.0,
    p_ref: float = 1.0,
    s_min: float = 0.0,
    fields=None,
) -> LineList:
    """Build a LineList for one RADTRAN (gas, iso) from a GEISA record
    file (a path or its bytes) + TIPS partition functions: the GEISA twin
    of ``io.hitran.linelist_from_par``.

    iso_id=0 selects every isotopologue of the molecule. Missing
    self-broadening parameters fall back to the air values, as the
    reference does for ans files (``ans_line_data_file.py:455-465``).
    """
    rec = parse_geisa(path, fields=fields)
    if iso_id == 0:
        mol, _ = radtran_to_geisa(gas_id, 1)
        mask = rec["mol_id"] == mol
    else:
        mol, gcode = radtran_to_geisa(gas_id, iso_id)
        mask = (rec["mol_id"] == mol) & (rec["iso_code"] == gcode)
    if s_min > 0.0:
        mask &= rec["sw"] >= s_min
    if not mask.any():
        raise ValueError(
            f"no GEISA lines for gas {gas_id} iso {iso_id} (mol {mol})"
        )

    nu = rec["nu"][mask]
    order = np.argsort(nu)
    nu = nu[order]
    sw = rec["sw"][mask][order]
    elower = rec["elower"][mask][order]
    gamma_air = rec["gamma_air"][mask][order]
    n_air = rec["n_air"][mask][order]
    delta_air = rec.get("delta_air", np.zeros_like(rec["nu"]))[mask][order]
    gamma_self = rec.get("gamma_self", np.zeros_like(rec["nu"]))[mask][order]
    n_self = rec.get("n_self", np.zeros_like(rec["nu"]))[mask][order]

    m = ~np.isfinite(gamma_self) | (gamma_self == 0)
    gamma_self = np.where(m, gamma_air, gamma_self)
    m = ~np.isfinite(n_self) | (n_self == 0)
    n_self = np.where(m, n_air, n_self)

    pf_temp, pf_q = read_tips(pf_path, gas_id, iso_id)
    broad = np.stack(
        [gamma_self, n_self, np.zeros_like(n_self),
         gamma_air, n_air, delta_air]
    )
    return assemble_linelist(gas_id, iso_id, t_ref, p_ref, nu, sw, elower,
                             broad, pf_temp, pf_q)
