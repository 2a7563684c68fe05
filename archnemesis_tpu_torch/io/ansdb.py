"""Writers and facade for the "ans" spectral-line database.

Port of the JAX package's ``io/ansdb.py``. The reference keeps local HDF5
caches of line data, partition functions and pseudo-continua
(database/filetypes/ans_line_data_file.py, ans_partition_fn_data_file.py,
ans_pseudo_continuum_file.py) behind the ``AnsDatabase`` facade
(LineData_0.py:1407). Here: the writers of that layout (plain leaf groups
that ``io.linedata`` reads; ``h5py`` inside each, so they run where h5py
is installed, not on the card's machine), ``build_ans_from_par`` (HITRAN
``.par`` + TIPS into a store) and ``AnsDatabase`` with windowed
``fetch_line_data`` / ``fetch_partition_fn``. The facade reads an ``.h5``
store or its ``.npz`` export (``io.linedata.export_ans_linedata``), which
is how a machine without h5py reads one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from archnemesis_tpu_torch.io.linedata import (
    LineList,
    _mol_name,
    _slice_lines,
    read_ans_linedata,
    read_ans_pseudo_continuum,
)


def _next_leaf(grp, prefix: str) -> str:
    n = 0
    while f"{prefix}_{n:04d}" in grp:
        n += 1
    return f"{prefix}_{n:04d}"


def write_ans_linedata(path: str, ll: LineList, ambient: str = "AIR",
                       s_min: float = 0.0) -> None:
    """Append one line set for (ll.gas_id, ll.iso_id) to an ans line-data
    file (layout consumed by io.linedata.read_ans_linedata; reference
    AnsLineDataFile.set_data, ans_base.py:359)."""
    import h5py

    name = _mol_name(ll.gas_id)
    gamma_self, n_self, _, gamma_amb, n_amb, delta_amb = np.asarray(ll.broad)
    with h5py.File(path, "a") as f:
        grp = f.require_group(f"line_data/{name}/{ll.iso_id}")
        leaf = grp.create_group(_next_leaf(grp, "line_set"))
        leaf.attrs["t_ref"] = float(ll.t_ref)
        leaf.attrs["p_ref"] = float(ll.p_ref)
        leaf.attrs["s_min"] = float(s_min)
        leaf["nu"] = np.asarray(ll.nu, dtype=np.float64)
        leaf["sw"] = np.asarray(ll.sw, dtype=np.float64)
        leaf["elower"] = np.asarray(ll.elower, dtype=np.float64)
        leaf["gamma_self"] = np.asarray(gamma_self, dtype=np.float64)
        leaf["n_self"] = np.asarray(n_self, dtype=np.float64)
        b = leaf.create_group(f"broadeners/{ambient}")
        b["gamma_amb"] = np.asarray(gamma_amb, dtype=np.float64)
        b["n_amb"] = np.asarray(n_amb, dtype=np.float64)
        b["delta_amb"] = np.asarray(delta_amb, dtype=np.float64)


def write_ans_partition_fn(path: str, gas_id: int, iso_id: int,
                           temp, q) -> None:
    """Write a partition-function table (reference
    AnsPartitionFunctionDataFile layout: partition_function/<MOL>/<iso>/
    pf_data_NNNN/{temp, q})."""
    import h5py

    name = _mol_name(gas_id)
    with h5py.File(path, "a") as f:
        grp = f.require_group(f"partition_function/{name}/{iso_id}")
        leaf = grp.create_group(_next_leaf(grp, "pf_data"))
        leaf["temp"] = np.asarray(temp, dtype=np.float64)
        leaf["q"] = np.asarray(q, dtype=np.float64)


def write_ans_pseudo_continuum(path: str, gas_id: int, iso_id: int, pc,
                               s_max: float, ambient: str = "AIR") -> None:
    """Write one pseudo-continuum leaf (layout consumed by
    io.linedata.read_ans_pseudo_continuum; reference
    ans_pseudo_continuum_file.py)."""
    import h5py

    def f64(x):
        return np.asarray(x, np.float64)

    name = _mol_name(gas_id)
    with h5py.File(path, "a") as f:
        grp = f.require_group(f"pseudo_continuum/{name}/{iso_id}")
        leaf = grp.create_group(_next_leaf(grp, "pc_data"))
        leaf.attrs["t_cont"] = float(pc.t_ref)
        leaf.attrs["p_ref"] = float(pc.p_ref)
        leaf.attrs["s_max"] = float(s_max)
        leaf["wn_bin_center"] = f64(pc.wn_bin_center)
        leaf["wn_bin_width"] = f64(pc.wn_bin_width)
        leaf["line_strength_sum"] = f64(pc.strength_sum)
        leaf["line_strength_weighted_mean_lower_energy_state"] = f64(
            pc.lsw_e_lower)
        leaf["line_strength_weighted_gamma_self"] = f64(pc.lsw_gamma_self)
        leaf["line_strength_weighted_n_self"] = f64(pc.lsw_n_self)
        b = leaf.create_group(f"broadeners/{ambient}")
        b["line_strength_weighted_gamma_amb"] = f64(pc.lsw_gamma_amb)
        b["line_strength_weighted_n_amb"] = f64(pc.lsw_n_amb)


def build_ans_from_par(par_path: str, out_path: str, gas_iso_list,
                       pf_path: Optional[str] = None,
                       s_min: float = 0.0) -> None:
    """HITRAN ``.par`` + TIPS -> ans HDF5 store, for each (gas_id, iso_id)
    in ``gas_iso_list`` (the reference builds these caches from downloaded
    HITRAN data, database/__init__.py + readers/hitran)."""
    from archnemesis_tpu_torch.io.hitran import TIPS_PATH, linelist_from_par

    pf = pf_path or TIPS_PATH
    for gas_id, iso_id in gas_iso_list:
        ll = linelist_from_par(par_path, gas_id, iso_id, pf_path=pf,
                               s_min=s_min)
        write_ans_linedata(out_path, ll, s_min=s_min)
        write_ans_partition_fn(out_path, gas_id, iso_id, ll.pf_temp, ll.pf_q)


@dataclasses.dataclass
class AnsDatabase:
    """Facade over ans stores, ``.h5`` or their ``.npz`` exports (reference
    AnsDatabase, LineData_0.py:1407-1540): windowed line fetch + partition
    functions, with a small in-process cache keyed by (gas, iso, ambient).
    """

    line_database: str
    partition_function_database: Optional[str] = None
    continuum_database: Optional[str] = None

    def __post_init__(self):
        if self.partition_function_database is None:
            self.partition_function_database = self.line_database
        if self.continuum_database is None:
            self.continuum_database = self.line_database
        self._cache: dict = {}

    def fetch_line_data(self, gas_id: int, iso_id: int,
                        wn_min: float = -np.inf, wn_max: float = np.inf,
                        s_min: float = 0.0, ambient: str = "AIR") -> LineList:
        key = (gas_id, iso_id, ambient)
        ll = self._cache.get(key)
        if ll is None:
            ll = read_ans_linedata(self.line_database, gas_id, iso_id,
                                   ambient=ambient)
            self._cache[key] = ll
        out = _slice_lines(ll, wn_min, wn_max)
        if s_min > 0.0:
            keep = np.asarray(out.sw) >= s_min
            out = dataclasses.replace(
                out,
                nu=out.nu[keep], sw=out.sw[keep], elower=out.elower[keep],
                stim_ref=out.stim_ref[keep], broad=out.broad[:, keep],
            )
        return out

    def fetch_partition_fn(self, gas_id: int, iso_id: int):
        """(temp, q) table for one isotopologue."""
        ll = self.fetch_line_data(gas_id, iso_id)
        return ll.pf_temp, ll.pf_q

    def fetch_pseudo_continuum(self, gas_id: int, iso_id: int,
                               temperature: Optional[float] = None,
                               ambient: str = "AIR"):
        ll = self.fetch_line_data(gas_id, iso_id, ambient=ambient)
        return read_ans_pseudo_continuum(
            self.continuum_database, gas_id, iso_id, ambient=ambient,
            temperature=temperature, pf_temp=ll.pf_temp, pf_q=ll.pf_q,
        )
