"""Non-LTE atmospheric-emission tables (fluorescence / chemical / photolysis).

Port of the JAX package's ``core/emissions.py`` (reference ``Emissions_0``,
``Emissions_0.py:52``): per-emission look-up tables of emission rates
K(NWAVE, NT, NEM) plus reaction-rate coefficients RATE_COEFF(NT, NEM), all on
a shared (wave, temperature) grid. The tables are tensors, so a Jacobian
can differentiate through them; emission types and gas identities are host
metadata.
"""

from __future__ import annotations

from typing import Any, Tuple

from archnemesis_tpu_torch.enums import EmissionType, WaveUnit
from archnemesis_tpu_torch.utils.pytree import static_field, tensor_dataclass


@tensor_dataclass
class EmissionTables:
    """Stacked emission look-up tables for NEM atmospheric emissions.

    The reference table layout (``Emissions_0.py:92-103``):
      - K: fluorescence g-factors [photon molecule-1 s-1 (cm-1)-1] or
        chemical/photolysis strengths [photon molecule-1 (cm-1)-1]
      - RATE_COEFF: reaction-rate coefficient [s-1] (single-species
        emissions), used only for CHEMICAL/PHOTOLYSIS types
      - DIST_REF: stellar distance of tabulation (AU), used to rescale
        fluorescence/photolysis rates to the actual planet-star distance
    """

    wave: Any  # (NWAVE_EM,)
    temp: Any  # (NT,)
    k: Any  # (NWAVE_EM, NT, NEM)
    rate_coeff: Any  # (NT, NEM)
    dist_ref: Any  # (NEM,)

    emtype: Tuple[EmissionType, ...] = static_field(default=())
    gas_id: Tuple[int, ...] = static_field(default=())  # one gas per emission
    iso_id: Tuple[int, ...] = static_field(default=())
    ispace: WaveUnit = static_field(default=WaveUnit.Wavenumber_cm)

    @property
    def nem(self) -> int:
        return len(self.emtype)

    @property
    def nt(self) -> int:
        return self.temp.shape[0]
