"""ExoMol ``.states`` / ``.trans`` (+ ``.broad``) line-list ingestion.

Port of the JAX package's ``io/exomol.py``: the third database path whose
ids the reference maps (``database/datatypes/exomol/gas_descriptor.py``
notes ExoMol shares the GEISA gas numbering) but never parses. The ExoMol
data model (Tennyson et al. 2016, JMS 327) is state-resolved:

- ``.states``: one row per rovibronic state: ``id  E[cm-1]  g_tot  J``
  (+ lifetime/Lande/quantum-number columns, ignored);
- ``.trans``: one row per transition: ``id_upper  id_lower  A[s-1]``
  (+ optional precomputed wavenumber as a 4th column);
- ``.broad`` (optional): ``a0  gamma_ref  n  J_lower`` rows keyed by the
  lower-state J.

The HITRAN-convention line intensity at ``t_ref`` is

    S = g_up * A / (8 pi c nu^2) * exp(-c2 E_low / T) * (1 - exp(-c2 nu / T)) / Q(T)

with the partition function summed from the states file itself
(``Q(T) = sum_i g_i exp(-c2 E_i / T)``), so no TIPS table is needed.

A name ending in ``.gz`` or ``.bz2`` is opened with ``gzip``, as the JAX
package does: a ``.bz2`` file raises there and here alike.
"""

from __future__ import annotations

import gzip

import numpy as np

from archnemesis_tpu_torch.constants import C2_CGS
from archnemesis_tpu_torch.io.hitran import assemble_linelist
from archnemesis_tpu_torch.io.linedata import LineList

C_CGS = 2.99792458e10  # cm/s


def _open(path):
    if str(path).endswith(".gz") or str(path).endswith(".bz2"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_states(path):
    """(energy, g_tot, J) arrays indexed by (state id - 1).

    ExoMol state ids are 1-based consecutive integers; rows may carry
    trailing columns (lifetimes, quantum numbers) which are ignored.
    """
    with _open(path) as f:
        raw = np.loadtxt(f, usecols=(0, 1, 2, 3), ndmin=2)
    ids = raw[:, 0].astype(np.int64)
    n = int(ids.max())
    e = np.zeros(n)
    g = np.zeros(n)
    j = np.zeros(n)
    e[ids - 1] = raw[:, 1]
    g[ids - 1] = raw[:, 2]
    j[ids - 1] = raw[:, 3]
    return e, g, j


def read_trans(path):
    """(id_upper, id_lower, A) arrays; a 4th wavenumber column, when
    present, is ignored (nu is recomputed from the states for exactness)."""
    with _open(path) as f:
        raw = np.loadtxt(f, usecols=(0, 1, 2), ndmin=2)
    return (raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64),
            raw[:, 2])


def read_broad(path):
    """ExoMol ``.broad``: ``code gamma n J`` rows; only the ``a0``
    (J-dependent) records are used. Returns (J, gamma, n) arrays."""
    js, gs, ns = [], [], []
    with _open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4 or parts[0] != b"a0":
                continue
            gs.append(float(parts[1]))
            ns.append(float(parts[2]))
            js.append(float(parts[3]))
    return np.asarray(js), np.asarray(gs), np.asarray(ns)


def partition_function(e, g, temps):
    """Q(T) = sum_i g_i exp(-c2 E_i / T) from the states file."""
    temps = np.asarray(temps, dtype=np.float64)
    return np.sum(
        g[None, :] * np.exp(-C2_CGS * e[None, :] / temps[:, None]), axis=1
    )


def linelist_from_exomol(
    states_path,
    trans_path,
    gas_id: int,
    iso_id: int,
    broad_path=None,
    t_ref: float = 296.0,
    p_ref: float = 1.0,
    s_min: float = 0.0,
    default_gamma: float = 0.07,
    default_n: float = 0.5,
    pf_temps=None,
) -> LineList:
    """Assemble a LineList from an ExoMol states/trans pair.

    Broadening: the J''-keyed ``a0`` records of ``broad_path`` when given,
    else the ExoMol catalogue defaults (gamma=0.07 cm-1/atm, n=0.5, the
    values the ExoMol def files quote when no broadener file exists).
    Self-broadening falls back to the ambient values, as the HITRAN/GEISA
    readers do.
    """
    e, g, j = read_states(states_path)
    iu, il, a_ein = read_trans(trans_path)

    nu = e[iu - 1] - e[il - 1]
    pos = nu > 0
    nu, iu, il, a_ein = nu[pos], iu[pos], il[pos], a_ein[pos]

    if pf_temps is None:
        pf_temps = np.concatenate(
            [np.arange(10.0, 300.0, 10.0), np.arange(300.0, 3100.0, 100.0)]
        )
    pf_q = partition_function(e, g, pf_temps)
    q_ref = float(np.interp(t_ref, pf_temps, pf_q))

    e_low = e[il - 1]
    g_up = g[iu - 1]
    sw = (
        g_up * a_ein / (8.0 * np.pi * C_CGS * nu**2)
        * np.exp(-C2_CGS * e_low / t_ref)
        * (1.0 - np.exp(-C2_CGS * nu / t_ref))
        / q_ref
    )
    if s_min > 0.0:
        keep = sw >= s_min
        nu, sw, e_low, il = nu[keep], sw[keep], e_low[keep], il[keep]

    order = np.argsort(nu)
    nu, sw, e_low, il = nu[order], sw[order], e_low[order], il[order]

    if broad_path is not None:
        bj, bg, bn = read_broad(broad_path)
        j_low = j[il - 1]
        idx = np.searchsorted(bj, j_low).clip(0, bj.size - 1)
        exact = np.abs(bj[idx] - j_low) < 1e-9
        gamma_amb = np.where(exact, bg[idx], default_gamma)
        n_amb = np.where(exact, bn[idx], default_n)
    else:
        gamma_amb = np.full(nu.shape, default_gamma)
        n_amb = np.full(nu.shape, default_n)

    broad = np.stack(
        [gamma_amb, n_amb, np.zeros_like(n_amb),  # self <- ambient fallback
         gamma_amb, n_amb, np.zeros_like(n_amb)]
    )
    return assemble_linelist(gas_id, iso_id, t_ref, p_ref, nu, sw, e_low,
                             broad, np.asarray(pf_temps, dtype=np.float64),
                             pf_q)
