"""CIA table readers (.tab Fortran binary and .h5).

Mirrors reference CIA_0.read_ciatable_tab (CIA_0.py:455) and
read_ciatable_hdf5 (:585). Units are converted from cm^-1 amagat^-2 to
cm^5 molecule^-2 on read (.tab only; .h5 tables store cm^5 already).
``h5py`` is imported only to read a ``.h5`` table.
"""

import numpy as np
import torch

from archnemesis_tpu_torch.core.spectra import CIATables
from archnemesis_tpu_torch.enums import ParaH2Ratio
from archnemesis_tpu_torch.utils.device import resolve_device

AMAGAT = 2.68675e19  # molecule cm-3

# gas ids (Radtran): H2=39, He=40, N2=22, CH4=6
_H2, _HE, _N2, _CH4 = 39, 40, 22, 6


def read_cia_tab(path: str, dnu: float, npara: int,
                 inormal=ParaH2Ratio.EQUILIBRIUM, device=None) -> CIATables:
    """Read a .tab CIA table into float64 tensors on ``device``
    (None = CUDA)."""
    from scipy.io import FortranFile

    device = resolve_device(device)
    with FortranFile(path, "r") as f:
        if npara != 0:
            npair = 2
            temps = f.read_reals(dtype="float32").astype(np.float64)
            frac = np.abs(f.read_reals(dtype="float32")).astype(np.float64)
            k_h2h2 = f.read_reals(dtype="float32")
            k_h2he = f.read_reals(dtype="float32")
            kcia_list = np.vstack([k_h2h2, k_h2he]).reshape((-1,), order="F")
            g1 = (_H2, _H2)
            g2 = (_H2, _HE)
            e = int(ParaH2Ratio.EQUILIBRIUM)
            inormalt = (e, e)
        else:
            npair = 9
            temps = f.read_reals(dtype="float64")
            kcia_list = f.read_reals(dtype="float32")
            frac = np.zeros(1)
            g1 = (_H2, _H2, _H2, _H2, _H2, _N2, _N2, _CH4, _H2)
            g2 = (_H2, _HE, _H2, _HE, _N2, _CH4, _N2, _CH4, _CH4)
            e, n = int(ParaH2Ratio.EQUILIBRIUM), int(ParaH2Ratio.NORMAL)
            inormalt = (e, e, n, n, e, e, e, e, e)

    nt = len(temps)
    nwave = int(len(kcia_list) / nt / npair / max(npara, 1))
    waven = np.linspace(0, dnu * (nwave - 1), nwave)
    # stored order: wave-major, then temp, then para, then pair
    k = np.asarray(kcia_list, dtype=np.float64).reshape(
        nwave, nt, max(npara, 1), npair
    )
    k = np.transpose(k, (3, 2, 1, 0))  # (NPAIR, NPARA1, NT, NWAVE)
    k = k / AMAGAT**2

    return _tables(waven, temps, frac, k, g1, g2, inormalt, npara, inormal,
                   device)


def read_cia_h5(path: str, inormal=ParaH2Ratio.EQUILIBRIUM,
                device=None) -> CIATables:
    """Read a .h5 CIA table (reference read_ciatable_hdf5 CIA_0.py:585)
    into float64 tensors on ``device`` (None = CUDA)."""
    import h5py

    device = resolve_device(device)
    if not path.endswith(".h5"):
        path += ".h5"
    with h5py.File(path, "r") as f:
        npara = int(np.asarray(f.get("NPARA", 0)))
        g1 = tuple(int(x) for x in f["IPAIRG1"][()])
        g2 = tuple(int(x) for x in f["IPAIRG2"][()])
        inormalt = tuple(int(x) for x in f["INORMALT"][()])
        waven = f["WAVEN"][()].astype(np.float64)
        temp = f["TEMP"][()].astype(np.float64)
        frac = (f["FRAC"][()].astype(np.float64) if npara != 0
                else np.zeros(1))
        k = f["K_CIA"][()].astype(np.float64)
    if k.ndim == 3:
        k = k[:, None, :, :]
    return _tables(waven, temp, frac, k, g1, g2, inormalt, npara, inormal,
                   device)


def _tables(waven, temp, frac, k, g1, g2, inormalt, npara, inormal,
            device) -> CIATables:
    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64),
                               device=device)

    return CIATables(
        waven=dev(waven),
        temp=dev(temp),
        frac=dev(frac),
        k_cia=dev(k),
        pair_gas1=g1,
        pair_gas2=g2,
        inormalt=inormalt,
        npara=npara,
        inormal=ParaH2Ratio(inormal),
    )
