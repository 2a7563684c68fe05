"""Line data and the runtime line-by-line spectroscopy structure.

Port of the JAX package's ``io/linedata.py``. Line lists and partition
functions stay host float64 numpy, as there: the float32 synthesis splits
the float64 line centres into two floats (``ops/lbl.py``), which it can only
do while they are float64.

Two file formats hold the same line data:

- "ans" HDF5 (reference database/filetypes/ans_line_data_file.py): groups
  ``line_data/<MOL>/<iso>/line_set_NNNN`` with per-line datasets nu, sw,
  elower, gamma_self, n_self and per-broadener gamma_amb/n_amb/delta_amb;
  attrs t_ref (K), p_ref (atm). Partition functions under
  ``partition_function/<MOL>/<iso>/pf_data_NNNN`` as tabulated (temp, q).
  Read with ``h5py``.
- its ``.npz`` export (``export_ans_linedata``): the same datasets of one
  (molecule, isotope, ambient gas), the line sets already concatenated in
  their stored order, so that a machine without ``h5py`` reads the same
  numbers. ``read_ans_linedata`` picks the format by the path's suffix.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np

from archnemesis_tpu_torch.constants import C2_CGS
from archnemesis_tpu_torch.utils.datafiles import gas_info

# per-line datasets of a line set, then those of its ambient broadener
_LINE_FIELDS = ("nu", "sw", "elower", "gamma_self", "n_self")
_AMB_FIELDS = ("gamma_amb", "n_amb", "delta_amb")


@dataclass
class LineList:
    """All lines of one isotopologue + its partition function."""

    gas_id: int
    iso_id: int
    mol_name: str
    t_ref: float
    p_ref: float
    mass: float  # isotopic molar mass (g/mol)
    abundance: float  # terrestrial isotopic abundance

    nu: np.ndarray  # (N,) line centres [cm-1]
    sw: np.ndarray  # (N,) line intensity at t_ref
    elower: np.ndarray  # (N,) lower-state energy [cm-1]
    stim_ref: np.ndarray  # (N,) stimulated-emission factor at t_ref
    # broadening rows: [gamma_self, n_self, delta_self,
    #                   gamma_amb, n_amb, delta_amb] (one ambient gas)
    broad: np.ndarray  # (6, N)

    pf_temp: np.ndarray
    pf_q: np.ndarray

    @property
    def n_lines(self) -> int:
        return self.nu.shape[0]


def _mol_name(gas_id: int) -> str:
    return gas_info()[str(gas_id)]["name"]


def _raw_h5(path: str, name: str, iso_id: int, ambient: str) -> dict:
    """The stored datasets of one isotopologue, line sets concatenated in
    sorted set order; t_ref/p_ref of the last set."""
    import h5py

    raw = {k: [] for k in _LINE_FIELDS + _AMB_FIELDS}
    with h5py.File(path, "r") as f:
        grp = f[f"line_data/{name}/{iso_id}"]
        for s in sorted(k for k in grp.keys() if k.startswith("line_set")):
            g = grp[s]
            t_ref = float(g.attrs["t_ref"])
            p_ref = float(g.attrs["p_ref"])
            for k in _LINE_FIELDS:
                raw[k].append(g[k][()])
            b = g[f"broadeners/{ambient}"]
            for k in _AMB_FIELDS:
                raw[k].append(b[k][()])
        pf = f[f"partition_function/{name}/{iso_id}"]
        pfk = sorted(k for k in pf.keys() if k.startswith("pf_data"))[0]
        pf_temp = pf[f"{pfk}/temp"][()]
        pf_q = pf[f"{pfk}/q"][()]
    out = {k: np.concatenate(v) for k, v in raw.items()}
    out.update(t_ref=t_ref, p_ref=p_ref, pf_temp=pf_temp, pf_q=pf_q)
    return out


def _npz_prefix(name: str, iso_id: int) -> str:
    return f"{name}/{iso_id}/"


def _raw_npz(path: str, name: str, iso_id: int, ambient: str) -> dict:
    """The same datasets from an ``export_ans_linedata`` file."""
    pre = _npz_prefix(name, iso_id)
    with np.load(path) as f:
        out = {k: f[pre + k] for k in _LINE_FIELDS}
        out.update({k: f[f"{pre}broadeners/{ambient}/{k}"]
                    for k in _AMB_FIELDS})
        out.update(t_ref=float(f[pre + "t_ref"]),
                   p_ref=float(f[pre + "p_ref"]),
                   pf_temp=f[pre + "pf_temp"], pf_q=f[pre + "pf_q"])
    return out


def export_ans_linedata(h5_path: str, npz_path: str, gas_id: int,
                        iso_id: int, ambient: str = "AIR") -> None:
    """Write the datasets of one (molecule, isotope, ambient gas) of an
    "ans" HDF5 file to ``npz_path`` (needs ``h5py``)."""
    name = _mol_name(gas_id)
    raw = _raw_h5(h5_path, name, iso_id, ambient)
    pre = _npz_prefix(name, iso_id)
    arrays = {pre + k: raw[k] for k in _LINE_FIELDS}
    arrays.update({f"{pre}broadeners/{ambient}/{k}": raw[k]
                   for k in _AMB_FIELDS})
    for k in ("t_ref", "p_ref", "pf_temp", "pf_q"):
        arrays[pre + k] = np.asarray(raw[k], dtype=np.float64)
    np.savez(npz_path, **arrays)


def read_ans_linedata(path: str, gas_id: int, iso_id: int,
                      ambient: str = "AIR") -> LineList:
    """One isotopologue's lines from an "ans" HDF5 file or, when ``path``
    ends in ``.npz``, from its export; lines sorted by centre."""
    name = _mol_name(gas_id)
    if path.endswith(".npz"):
        raw = _raw_npz(path, name, iso_id, ambient)
    else:
        raw = _raw_h5(path, name, iso_id, ambient)
    t_ref, p_ref = raw["t_ref"], raw["p_ref"]
    order = np.argsort(raw["nu"])
    nu = raw["nu"][order]
    sw = raw["sw"][order]
    elower = raw["elower"][order]
    gamma_self = raw["gamma_self"][order]
    n_self = raw["n_self"][order]
    gamma_amb = raw["gamma_amb"][order]
    n_amb = raw["n_amb"][order]
    delta_amb = raw["delta_amb"][order]

    # missing self-broadening falls back to the ambient values
    # (reference ans_line_data_file.py:455-465)
    m = np.isnan(n_self) | (n_self == 0)
    n_self[m] = n_amb[m]
    m = np.isnan(gamma_self) | (gamma_self == 0)
    gamma_self[m] = gamma_amb[m]

    stim_ref = 1.0 - np.exp(-C2_CGS * nu / t_ref)
    broad = np.stack(
        [gamma_self, n_self, np.zeros_like(n_self), gamma_amb, n_amb, delta_amb]
    )
    iso = gas_info()[str(gas_id)]["isotope"][str(iso_id if iso_id != 0 else 1)]
    return LineList(
        gas_id=gas_id,
        iso_id=iso_id,
        mol_name=name,
        t_ref=t_ref,
        p_ref=p_ref,
        mass=float(iso["mass"]),
        abundance=float(iso["abun"]),
        nu=nu,
        sw=sw,
        elower=elower,
        stim_ref=stim_ref,
        broad=broad,
        pf_temp=raw["pf_temp"],
        pf_q=raw["pf_q"],
    )


def read_ans_pseudo_continuum(path: str, gas_id: int, iso_id: int,
                              ambient: str = "AIR",
                              temperature: float | None = None,
                              pf_temp=None, pf_q=None):
    """Read an "ans" pseudo-continuum HDF5 file into a PseudoContinuum.

    Layout (reference database/filetypes/ans_pseudo_continuum_file.py):
    groups ``pseudo_continuum/<MOL>/<iso>/pc_data_NNNN`` with datasets
    wn_bin_center/wn_bin_width/line_strength_sum/
    line_strength_weighted_mean_lower_energy_state/..._gamma_self/..._n_self
    and per-broadener ``broadeners/<GAS>`` subgroups; attrs t_cont, s_max,
    p_ref. Leaf selection follows the reference (:280-302): leaves are
    ordered by (s_max, t_cont); the best t_cont is the lowest one >= the
    target temperature (last leaf when none qualifies or no target given).
    Missing broadener data falls back to the self coefficients (:590-596).
    """
    import h5py

    from archnemesis_tpu_torch.ops.pseudo_continuum import PseudoContinuum

    name = _mol_name(gas_id)
    with h5py.File(path, "r") as f:
        grp = f[f"pseudo_continuum/{name}/{iso_id}"]
        leaves = sorted(k for k in grp.keys() if k.startswith("pc_data"))
        if temperature is not None:
            best = None
            for k in leaves:
                tc = float(grp[k].attrs["t_cont"])
                if tc >= temperature and (
                    best is None or tc < float(grp[best].attrs["t_cont"])
                ):
                    best = k
            leaf = best if best is not None else leaves[-1]
        else:
            leaf = leaves[-1]
        g = grp[leaf]
        t_cont = float(g.attrs["t_cont"])
        p_ref = float(g.attrs.get("p_ref", 1.0))

        def f64(ds):
            return np.asarray(ds[()], dtype=np.float64)

        gamma_self = f64(g["line_strength_weighted_gamma_self"])
        n_self = f64(g["line_strength_weighted_n_self"])
        if "broadeners" in g and ambient in g["broadeners"]:
            b = g[f"broadeners/{ambient}"]
            gamma_amb = f64(b["line_strength_weighted_gamma_amb"])
            n_amb = f64(b["line_strength_weighted_n_amb"])
        else:
            gamma_amb, n_amb = gamma_self, n_self
        pc_kwargs = dict(
            wn_bin_center=f64(g["wn_bin_center"]),
            wn_bin_width=f64(g["wn_bin_width"]),
            strength_sum=f64(g["line_strength_sum"]),
            lsw_e_lower=f64(
                g["line_strength_weighted_mean_lower_energy_state"]),
        )

    iso = gas_info()[str(gas_id)]["isotope"][str(iso_id if iso_id != 0 else 1)]
    if pf_temp is None:
        # partition function comes from the PF database (same as the line
        # list's); a flat Q disables the Q-ratio scaling
        pf_temp, pf_q = np.array([1.0, 1.0e4]), np.array([1.0, 1.0])
    return PseudoContinuum(
        t_ref=t_cont,
        p_ref=p_ref,
        mass=float(iso["mass"]),
        abundance=float(iso["abun"]),
        lsw_gamma_self=gamma_self,
        lsw_n_self=n_self,
        lsw_gamma_amb=gamma_amb,
        lsw_n_amb=n_amb,
        pf_temp=np.asarray(pf_temp, dtype=np.float64),
        pf_q=np.asarray(pf_q, dtype=np.float64),
        **pc_kwargs,
    )


@dataclass
class RuntimeLBL:
    """Runtime line-by-line spectroscopy (the reference's ILBL=1 RUNTIME
    ``.lls`` format, Spectroscopy_0.py:960-1270): per-gas line lists +
    lineshape parameters on a fixed wave grid.

    A host structure (numpy, float64) that takes the k-tables' place in the
    forward model (wave / del_g / gas_id / iso_id / ilbl);
    ``layer_optical_depths`` dispatches on ``ilbl``. It is never cast or
    moved: a synthesis on the card keeps its gas's kernel inputs in
    ``packed_inputs``, packed in the run's type at the first forward.
    """

    wave: np.ndarray
    gas_id: tuple
    iso_id: tuple
    line_lists: tuple  # per gas: LineList
    lineshape: tuple  # per gas: a name of ops.voigt.LINESHAPES
    wn_calc_window: tuple
    wn_approx_window: tuple
    s_floor: tuple
    include_pressure_shift: tuple
    blocks: tuple = ()  # per gas: LblBlocks (built by ``windowed``)
    # per gas: PseudoContinuum (ops.pseudo_continuum) or None; weak-line
    # continuum added when include_continuum is set (reference
    # INCLUDE_CONTINUUM / DBASE_PC, Spectroscopy_0.py:975-1010)
    pseudo_continuum: tuple = ()
    include_lines: tuple = ()
    include_continuum: tuple = ()

    # wave-sharded synthesis (parallel/sharded.py:shard_runtime_lbl): per
    # gas the partition with this rank's packed kernel inputs, and the
    # rank's part of the grid; empty / None -> the whole grid in one
    # synthesis per gas
    shard_data: tuple = ()
    wave_slice: object = None

    del_g: np.ndarray = None
    ilbl: int = 1  # SpectralCalculationMode.LINE_BY_LINE_RUNTIME

    # per gas: the LBL kernel's static inputs by (dtype, device)
    # (``packed_inputs``); a copy made by ``dataclasses.replace`` starts
    # empty
    packed: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    def __post_init__(self):
        if self.del_g is None:
            self.del_g = np.array([1.0])
        n = len(self.gas_id)
        if not self.pseudo_continuum:
            self.pseudo_continuum = (None,) * n
        if not self.include_lines:
            self.include_lines = (True,) * n
        if not self.include_continuum:
            self.include_continuum = (True,) * n

    @property
    def ngas(self):
        return len(self.gas_id)

    def packed_inputs(self, i: int) -> dict:
        """The dict in which gas ``i``'s kernel launches keep their static
        inputs (line columns, wave grid, block ranges) by (dtype, device)
        (``ops/lbl_cuda.py:static_inputs``): packed at the first launch of
        each, so that later forwards on the card pack and copy none."""
        return self.packed.setdefault(i, {})

    def windowed(self, wavemin, wavemax):
        """Restrict the LINE LISTS to [wavemin, wavemax] and build the
        static line blocks on the (full) calc grid.

        Mirrors the reference's runtime read_tables (Spectroscopy_0.py:
        1468-1485): the wave grid stays the full .lls WAVE grid, but lines
        are fetched only inside the per-geometry ILS range — lines just
        outside it do NOT contribute their wings.
        """
        from archnemesis_tpu_torch.ops.lbl import build_blocks

        lls = tuple(
            _slice_lines(ll, wavemin, wavemax) for ll in self.line_lists
        )
        blocks = tuple(
            build_blocks(self.wave, ll.nu,
                         wn_approx_window=self.wn_approx_window[i])
            for i, ll in enumerate(lls)
        )
        return dataclasses.replace(self, line_lists=lls, blocks=blocks)


def _slice_lines(ll: LineList, wavemin: float, wavemax: float) -> LineList:
    sel = (ll.nu >= wavemin) & (ll.nu <= wavemax)
    return dataclasses.replace(
        ll,
        nu=ll.nu[sel], sw=ll.sw[sel], elower=ll.elower[sel],
        stim_ref=ll.stim_ref[sel], broad=ll.broad[:, sel],
    )


# integer values follow the reference SpectroscopicLineProfileEnum
# (enum/spectroscopic_line_profile_enum.py: VOIGT=0, LORENTZ=4,
# SUBLORENTZ_CO2_BROADENING_VENUS=7, DOPPLER=12); names accepted too
_LINESHAPE_NAMES = {
    0: "voigt", 4: "lorentz", 7: "tonkov96_sublorentz_co2_venus",
    12: "gaussian",
    "VOIGT": "voigt", "LORENTZ": "lorentz", "DOPPLER": "gaussian",
    "GAUSSIAN": "gaussian",
    "SUBLORENTZ_CO2_BROADENING_VENUS": "tonkov96_sublorentz_co2_venus",
    "HARTMANN_CH4_H2": "hartmann_ch4_h2",
    "VOIGT_CH4_H2": "voigt_ch4_h2",
}


def _flag(value: str) -> bool:
    return value.upper() in ("TRUE", "T", "1")


def read_lls_runtime(path: str) -> RuntimeLBL:
    """Parse a RUNTIME-format .lls file (reference Spectroscopy_0.py:960:
    WAVE/DBASE_*/LINESHAPE/WN_*_WINDOW/AMB_GAS/MOL blocks with
    flow-downwards defaults). Relative database paths are taken from the
    file's directory; ``ARCHNEMESIS_PATH`` in a path is replaced by that
    environment variable, the root of the original archNEMESIS tree (a
    path that names it while it is unset raises)."""
    base_dir = os.path.dirname(os.path.abspath(path))
    wave_spec = None
    cur = dict(
        ld=None, pf=None, pc=None, lineshape="voigt", wn_calc=25.0,
        wn_approx=75.0, amb="AIR", s_floor=0.0, shift=True,
        inc_lines=True, inc_cont=True,
    )
    gases = []

    def resolve(p):
        if "ARCHNEMESIS_PATH" in p:
            root = os.environ.get("ARCHNEMESIS_PATH")
            if root is None:
                raise ValueError(f"{path}: {p} names ARCHNEMESIS_PATH, "
                                 "which is not set")
            p = p.replace("ARCHNEMESIS_PATH", root)
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    with open(path) as fh:
        lines = fh.readlines()
    for raw in lines:
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        key = line.split()[0]
        arg = line.split()[1] if len(line.split()) > 1 else ""
        if key == "WAVE":
            wave_spec = tuple(float(x) for x in line.split()[1:])
        elif key == "DBASE_PF":
            cur["pf"] = resolve(line.split(maxsplit=1)[1])
        elif key == "DBASE_LD":
            cur["ld"] = resolve(line.split(maxsplit=1)[1])
        elif key == "DBASE_PC":
            cur["pc"] = resolve(line.split(maxsplit=1)[1])
        elif key == "LINESHAPE":
            cur["lineshape"] = _LINESHAPE_NAMES[
                arg if not arg.isdigit() else int(arg)]
        elif key == "WN_CALC_WINDOW":
            cur["wn_calc"] = float(arg)
        elif key == "WN_APPROX_WINDOW":
            cur["wn_approx"] = float(arg)
        elif key == "AMB_GAS":
            cur["amb"] = arg
        elif key == "S_FLOOR":
            cur["s_floor"] = float(arg)
        elif key == "INCLUDE_PRESSURE_SHIFT":
            cur["shift"] = _flag(arg)
        elif key == "INCLUDE_LINES":
            cur["inc_lines"] = _flag(arg)
        elif key == "INCLUDE_CONTINUUM":
            cur["inc_cont"] = _flag(arg)
        elif key == "MOL":
            parts = line.split()
            gid = next((int(k) for k, v in gas_info().items()
                        if v["name"] == parts[1]), None)
            if gid is None:
                gid = int(parts[1])
            gases.append((gid, int(parts[2]), dict(cur)))

    if wave_spec is None:
        raise ValueError(f"{path}: RUNTIME .lls must define WAVE")
    wave = np.arange(*wave_spec, dtype=float)

    lls, pcs = [], []
    for gid, iso, c in gases:
        lls.append(read_ans_linedata(c["ld"], gid, iso if iso != 0 else 1,
                                     ambient=c["amb"]))
        if c["pc"] is not None and c["inc_cont"]:
            pcs.append(read_ans_pseudo_continuum(
                c["pc"], gid, iso if iso != 0 else 1, ambient=c["amb"],
                pf_temp=lls[-1].pf_temp, pf_q=lls[-1].pf_q,
            ))
        else:
            pcs.append(None)

    def per_gas(key):
        return tuple(c[key] for _, _, c in gases)

    return RuntimeLBL(
        wave=wave,
        gas_id=tuple(g for g, _, _ in gases),
        iso_id=tuple(i for _, i, _ in gases),
        line_lists=tuple(lls),
        lineshape=per_gas("lineshape"),
        wn_calc_window=per_gas("wn_calc"),
        wn_approx_window=per_gas("wn_approx"),
        s_floor=per_gas("s_floor"),
        include_pressure_shift=per_gas("shift"),
        pseudo_continuum=tuple(pcs),
        include_lines=per_gas("inc_lines"),
        include_continuum=per_gas("inc_cont"),
    )
