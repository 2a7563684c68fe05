"""The port's nadir multiple- and single-scattering forwards
(``archnemesis_tpu_torch/forward.py:forward_scattering_nadir``,
``forward_singlescat_nadir``) on the Jupiter scattering deck, against the
reference goldens at the JAX tests' bounds (``tests/test_forward_scattering
.py``, ``test_forward_singlescat.py``) and against the JAX package's
forwards on the same deck at rtol 1e-10. The surfaces are in
``test_torch_scattering_brdf.py``."""

import numpy as np
import pytest

from port_cases import (  # noqa: F401
    one_torch_thread,
    scatter_decks,
    scatter_forwards,
    speconv,
)

SCAT_GOLDEN = "tests/goldens/jupiter_scatter_fm.npz"
SINGLE_GOLDEN = "tests/goldens/jupiter_singlescat_fm.npz"

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def decks():
    return scatter_decks()


@pytest.fixture(scope="module")
def multiple(decks):
    return scatter_forwards(decks, single=False)


@pytest.mark.parametrize("name,key", [
    ("taugas", "TAUGAS"), ("taucia", "TAUCIA"), ("tauray", "TAURAY"),
    ("taudust", "TAUDUST"), ("tauscat", "TAUSCAT"), ("tautot", "TAUTOT"),
])
def test_multiple_scattering_layer_taus(multiple, name, key):
    want = np.load(SCAT_GOLDEN)[key]
    got = multiple[1][name].numpy()
    atol = 1e-12 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=name)


def test_multiple_scattering_spectrum(multiple):
    d = np.load(SCAT_GOLDEN)
    tspec, _, jspec = multiple
    got, nconv = speconv(d, tspec)
    np.testing.assert_allclose(got, d["SPECONV"][:nconv, 0], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(tspec.numpy(), jspec, rtol=1e-10, atol=0)


def test_single_scattering_spectrum(decks):
    d = np.load(SINGLE_GOLDEN)
    tspec, _, jspec = scatter_forwards(decks, single=True)
    got, nconv = speconv(d, tspec)
    np.testing.assert_allclose(got, d["SPECONV"][:nconv, 0], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(tspec.numpy(), jspec, rtol=1e-10, atol=0)
