"""jupiter_ck_oe: an optimal-estimation iteration on ``jupiter_ck``, one
forward and its Jacobian in float32.

The state vector x is the retrieval's at its linearisation point: the
levels' temperatures, then one multiplier for each scaled gas's VMR
profile (``state_vector`` in the file), all 1. The program's side is
``jupiter_ck``'s with ``jacobian(t, mult)``: one call of the port's
``retrieval/oe.py:forward_and_jacobian`` on x, whose forward is
``forward_nadir`` with temperatures ``x[:NLEVEL]`` and scaled-gas VMRs the
profile times ``mult`` times ``x[NLEVEL + g]``. The reference's side adds
the same Jacobian of the plain float64 reference, ``torch.func.jacfwd``
at the compared waves in blocks of ``BLOCK`` waves.
"""

from __future__ import annotations

import torch

from nembench.harness import manifest as mf

_, _base = mf.config("jupiter_ck")
profiles = _base.profiles
BLOCK = 128  # waves of one block of the reference's Jacobian


def _check_state(spec) -> int:
    """NLEVEL of the state vector, which has to be the configuration's
    levels and scaled gases in order."""
    sv = spec["state_vector"]
    if (sv["temperature_levels"] != spec["nlevel"]
            or list(sv["gas_scales"]) != list(spec["scaled_gases"])):
        raise ValueError("state_vector: every level's temperature and the "
                         "scaled gases in their order")
    return spec["nlevel"]


def _state(t, mult, nlevel):
    """(x, fn): the state at (t, scales 1) and fn(x) -> (temperatures,
    multipliers)."""
    x = torch.cat([t, t.new_ones(mult.shape[1])])

    def split(z):
        return z[:nlevel], mult * z[nlevel:][None, :]

    return x, split


class Program(_base.Program):
    """``jupiter_ck``'s program with ``jacobian(t, mult)``: (spectrum
    (NWAVE,), K (NWAVE, NX)) on the device."""

    def __init__(self, spec, seed: int, device):
        self.nlevel = _check_state(spec)
        super().__init__(spec, seed, device)

    def state_function(self, t, mult):
        """(x, fn) with fn(x) the spectrum of the state x."""
        x, split = _state(t, mult, self.nlevel)
        return x, lambda z: self.forward(*split(z))

    def jacobian(self, t, mult):
        from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian

        x, fn = self.state_function(t, mult)
        return forward_and_jacobian(fn, x)


class Reference(_base.Reference):
    """``jupiter_ck``'s reference with ``jacobian(t, mult, wave_idx)``:
    (spectrum, K) at the waves ``wave_idx`` in its type."""

    def __init__(self, spec, seed: int, device, dtype=torch.float64):
        self.nlevel = _check_state(spec)
        super().__init__(spec, seed, device, dtype)

    def jacobian(self, t, mult, wave_idx):
        x, split = _state(t.to(self.dtype), mult.to(self.dtype), self.nlevel)
        ys, ks = [], []
        for i in range(0, len(wave_idx), BLOCK):
            block = wave_idx[i:i + BLOCK]

            def fn(z, block=block):
                y = self.forward(*split(z), block)
                return y, y

            kk, y = torch.func.jacfwd(fn, has_aux=True)(x)
            ys.append(y)
            ks.append(kk)
        return torch.cat(ys), torch.cat(ks)
