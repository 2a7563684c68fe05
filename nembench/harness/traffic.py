"""The one traffic generator: per-call atmospheric states drawn from the
seed, made on the device in float64.

A mix's parameters (``traffic/<name>.json``):

- ``loop``, ``clients``: a closed loop of one client (the only kind yet).
- ``call``: the kind of call, ``calls/<call>.py``.
- ``warmup_calls``: calls made before the window, in set-up.
- ``states``: the pool of distinct states; call i takes state i modulo it.
- ``temperature``: ``amplitude_k`` and ``modes``: the levels' temperatures
  are the configuration's plus a sum of ``modes`` sines in the level's
  height index (wavenumber m = 1..modes, each with a phase in [0, 2 pi)
  and an amplitude in [-1, 1] amplitude_k / modes, all drawn).
- ``gases``: the same form, ``amplitude_ln`` in the log of each scaled
  gas's VMR multiplier, drawn per gas.
- ``check``: how many finished calls (``calls``) the comparison with the
  reference takes, drawn from the seed, and at which waves
  (``wave_blocks`` runs of ``block_width`` consecutive waves, drawn).
- ``trace_calls``: the calls that a traced run profiles.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device):
    """A ``torch.Generator`` on ``device`` for the states' draws (any whole
    number seeds it: it is hashed to 63 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + 0xBF58476D1CE4E5B9)
                  % (2**63 - 1))
    return g


def _smooth(n, nlevel, modes, amplitude, gen, device, width=1):
    """(n, nlevel, width) sums of ``modes`` sines of the level index."""
    z = torch.linspace(0.0, 1.0, nlevel, dtype=torch.float64, device=device)
    m = torch.arange(1, modes + 1, dtype=torch.float64, device=device)
    amp = (torch.rand((n, width, modes), generator=gen, dtype=torch.float64,
                      device=device) * 2.0 - 1.0) * (amplitude / modes)
    phase = torch.rand((n, width, modes), generator=gen, dtype=torch.float64,
                       device=device) * (2.0 * math.pi)
    waves = torch.sin(math.pi * m[None, None, None, :] * z[None, None, :, None]
                      + phase[:, :, None, :])  # (n, width, nlevel, modes)
    return (waves * amp[:, :, None, :]).sum(-1).transpose(1, 2)


def states(mix: dict, base_t: np.ndarray, n_scaled: int, seed: int, device):
    """(t (STATES, NLEVEL), mult (STATES, NLEVEL, NSCALED)), float64 on
    ``device``."""
    n, nlevel = mix["states"], base_t.shape[0]
    gen = generator(seed, device)
    temp, gas = mix["temperature"], mix["gases"]
    t = torch.as_tensor(base_t, device=device)[None, :] + _smooth(
        n, nlevel, temp["modes"], temp["amplitude_k"], gen, device)[..., 0]
    mult = torch.exp(_smooth(n, nlevel, gas["modes"], gas["amplitude_ln"],
                             gen, device, width=n_scaled))
    return t, mult


def check_sample(mix: dict, n_done: int, nwave: int, seed: int):
    """(calls, waves): the finished calls the comparison takes and the
    waves it reads, both sorted host integer arrays drawn from the seed."""
    chk = mix["check"]
    rng = np.random.default_rng([int(seed) % 2**63, 2])
    calls = np.sort(rng.choice(n_done, size=min(chk["calls"], n_done),
                               replace=False))
    return calls, check_waves(mix, nwave, seed)


def check_waves(mix: dict, nwave: int, seed: int):
    """The waves the comparison reads: ``wave_blocks`` runs of
    ``block_width`` consecutive waves, drawn from the seed (a stream of its
    own, so that they do not depend on the number of calls)."""
    chk = mix["check"]
    rng = np.random.default_rng([int(seed) % 2**63, 3])
    width = min(chk["block_width"], nwave)
    nblock = nwave // width
    blocks = np.sort(rng.choice(nblock, size=min(chk["wave_blocks"], nblock),
                                replace=False))
    return (blocks[:, None] * width + np.arange(width)[None, :]).reshape(-1)


def vmr_multiplier(mult, scaled, ncol):
    """(NLEVEL, NCOL) multipliers of every VMR column: ``mult``'s columns
    at the scaled gases' columns ``scaled``, ones elsewhere."""
    one = torch.ones_like(mult[:, 0])
    return torch.stack([mult[:, scaled.index(j)] if j in scaled else one
                        for j in range(ncol)], dim=1)
