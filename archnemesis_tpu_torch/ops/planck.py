"""Planck function with NEMESIS-rounded radiation constants.

The reference uses c1=1.1911e-12 W cm2, c2=1.439 cm K (ForwardModel_0.py:6215)
rather than CODATA values; matching them is required for rtol 1e-5 golden
parity.
"""

import torch

C1 = 1.1911e-12  # W cm^2 sr^-1 (2 h c^2, NEMESIS-rounded)
C2 = 1.439  # cm K (h c / k_B, NEMESIS-rounded)


def planck(wave, temp, ispace=0):
    """Blackbody spectral radiance; broadcasts wave against temp.

    ispace=0: wave in cm-1 -> W cm-2 sr-1 (cm-1)-1
    ispace=1: wave in um   -> W cm-2 sr-1 um-1
    """
    if ispace == 0:
        y = wave
        a = C1 * y**3
    else:
        y = 1.0e4 / wave
        a = C1 * y**5 / 1.0e4
    return a / (torch.exp(C2 * y / temp) - 1.0)
