"""Least time of the adding-doubling's work on an H100, from the cell's
inputs.

What the matrix operator method asks for these optical depths, whatever
implements it: for every (wave, g, Fourier component), each layer's
doubling ladder of archNEMESIS's length (``double1``: nn = int(log2(tau)
+ 12), at most 35, none below 1) and the NLAY - 1 combines that add the
layers along the path. A combine (``add`` / ``addp``) of two NMU x NMU
layers counts the operations of its series branch: five matrix products,
the source's two matrix-vector products, its sums and its norm. The
inverse of E - Rsub R1, which the branch takes only where the norm passes
its threshold, is not counted, so the count is a floor wherever the
method takes it. Bytes: what no implementation can avoid moving, the
inputs read once and the radiance written once; a layer's R, T and J
need never leave the chip (a kernel may add each layer as its ladder
ends), so no combine counts bytes of its own. Peaks as ``bounds.py``'s.
"""

from __future__ import annotations

import numpy as np

from nembench.harness.bounds import PEAK_BYTES_S, PEAK_F32_OPS_S
from nembench.reference.scattering import IPOW0, NN_MAX


def combine_ops(nmu: int) -> int:
    """Operations of one combine on its series branch: 5 products at 2
    NMU^3 each (Rsub R1, T1 (E + Rsub R1), its products with Rsub and T1,
    with Tsub); Rsub J1 and Ccom (Rsub J1 + Jsub) at 2 NMU^2 each; 4 NMU^2
    of matrix sums and the norm (E + ., R1 + ., the squares and their
    sum); 2 NMU of vector sums (Rsub J1 + Jsub, J1 + .)."""
    return 10 * nmu**3 + 8 * nmu**2 + 2 * nmu


def io_bytes(shape, nf: int, nmu: int, nmode: int, itemsize: int) -> int:
    """Bytes read and written once by the adding-doubling of one forward
    over ``shape`` = (NWAVE, NG, NLAY): each (wave, g, layer)'s optical
    depth; each (wave, layer)'s Rayleigh and aerosol scattering optical
    depths, Planck radiance and NMODE mode shares; per component the
    ``+`` and ``-`` phase matrices of Rayleigh and of each mode at each
    wave; the (wave, g) radiance."""
    nwave, ng, nlay = shape
    words = (nwave * ng * nlay + nwave * nlay * (3 + nmode)
             + (nf + 1) * (1 + nmode * nwave) * 2 * nmu * nmu
             + nwave * ng)
    return words * itemsize


def doublings(taut) -> int:
    """Doubling combines of the layers' ladders: the sum over ``taut``'s
    elements (host float64 array, every (wave, g, layer)) of archNEMESIS's
    nn, at most 35 and none where nn < 1 or tau <= 0."""
    taut = np.asarray(taut, np.float64)
    live = taut > 0
    nn = np.trunc(np.log2(np.where(live, taut, 1.0)) + IPOW0)
    return int(np.where(live, np.clip(nn, 0, NN_MAX), 0).sum())


def combines(taut, nf: int) -> int:
    """Combines of one forward over ``taut`` (NWAVE, NG, NLAY): the
    doublings and the NLAY - 1 path combines of every (wave, g), for each
    of the NF + 1 Fourier components."""
    nwave, ng, nlay = np.shape(taut)
    return (nf + 1) * (doublings(taut) + nwave * ng * (nlay - 1))


def least_ms(taut, nf: int, nmu: int, nmode: int, itemsize: int) -> float:
    """Least time [ms] of the adding-doubling of one forward: the larger of
    its operations over the float32 peak and its bytes over HBM
    bandwidth."""
    ops_ms = combines(taut, nf) * combine_ops(nmu) / PEAK_F32_OPS_S * 1e3
    bytes_ms = (io_bytes(np.shape(taut), nf, nmu, nmode, itemsize)
                / PEAK_BYTES_S * 1e3)
    return max(ops_ms, bytes_ms)
