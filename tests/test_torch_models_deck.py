"""The remaining models through the retrieval set-up of the PyTorch port,
against the JAX package's set-up on the same composed deck,
``models_nadir`` (``chip_smoke.models_nadir_deck``, which the card runs at
full width too): jupiter_nadir (81 levels, 11 gases, 7 k-tables, NY 698)
with model 0 and nine fixture blocks (knee 1, scalings 2 and 3, CH4
humidity 45, cloud 9, cross sections 887, Doppler 447, polynomial 231,
dilution 667), 101 state elements.

The forward at the a priori at rtol 1e-8 (the packages' sorts and
reductions differ in order) and one JVP column per model family within
1e-8 of the column's peak (``port_cases.models_deck_case``; the JAX side
is jitted). The ``models_ils`` deck (the "dynamic" ILS of model 229 with
model 447) is held the same way in ``tests/test_torch_models_ils.py``, so
that neither file runs both decks' plain combines. The port's full
Jacobians run on the card (``chip_smoke.py``, phase "models"), where they
are held to these CPU set-ups."""

import numpy as np
import pytest

import chip_smoke
from port_cases import models_deck_case, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the JVP columns: (model id, offset in its block), one per model family
# (profile, scatter, measurement, spectrum); the cloud of model 9 and the
# other profile models are held through apply_state's JVP in
# tests/test_torch_models_profile.py
NADIR_COLUMNS = {"knee_1": (1, 0), "xsc_887": (887, 3),
                 "doppler_447": (447, 0), "poly_231": (231, 1)}


@pytest.fixture(scope="module")
def nadir(tmp_path_factory):
    return models_deck_case(tmp_path_factory, chip_smoke.models_nadir_deck,
                            NADIR_COLUMNS)


def test_models_nadir_setup(nadir):
    sv = nadir["port"].sv
    assert sv.nx == 101 and nadir["y"].shape == (698,)
    assert [e.model_id for e in sv.entries] == [
        0, 1, 2, 3, 45, 9, 887, 447, 231, 667]


def test_models_nadir_forward_matches_jax(nadir):
    assert np.all(nadir["y"] > 0)
    np.testing.assert_allclose(nadir["y"], nadir["jy"], rtol=1e-8, atol=0)


@pytest.mark.parametrize("column", list(NADIR_COLUMNS))
def test_models_nadir_jvp_matches_jax(nadir, column):
    got, want = nadir["dy"][column], nadir["jdy"][column]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())
