"""The retrieval entry point of the PyTorch port on the runtime line-by-line
deck (``tests/fixtures/co_runtime``: NX = 15, temperature model 0; NY = 60,
FWHM = 0) against the JAX package: the measurement vector, its covariance
and the a priori, the forward function at the a priori and its ``jacfwd``
Jacobian, whose tangents reach the line synthesis through the kernel
wrapper's ``jvp`` rule while its primal is computed once per gas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.retrievals import make_retrieval_setup as jax_setup
from archnemesis_tpu_torch.io.linedata import RuntimeLBL
from archnemesis_tpu_torch.ops import lbl_cuda
from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
from archnemesis_tpu_torch.retrievals import make_retrieval_setup
from port_cases import CO_RUNTIME
from port_cases import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setups():
    return (jax_setup(CO_RUNTIME, "cirstest"),
            make_retrieval_setup(CO_RUNTIME, "cirstest", device="cpu"))


@pytest.fixture(scope="module")
def jacobians(setups):
    """The JAX package's spectrum and Jacobian at the a priori (one eager
    ``jacfwd`` with the spectrum as auxiliary output), the port's, and the
    port's primal syntheses in its evaluation."""
    want, got = setups
    xa = np.asarray(want.sv.xa)
    kk_jax, yn_jax = jax.jacfwd(lambda x: (want.forward_fn(x),) * 2,
                                has_aux=True)(jnp.asarray(xa))
    calls = lbl_cuda.lbl_cross_section.calls
    yn, kk = forward_and_jacobian(got.forward_fn, torch.as_tensor(xa))
    calls = lbl_cuda.lbl_cross_section.calls - calls
    return (np.asarray(yn_jax), np.asarray(kk_jax)), (yn.numpy(), kk.numpy()), \
        calls


def test_setup_matches_jax(setups):
    want, got = setups
    assert isinstance(got.deck.ktables, RuntimeLBL)
    assert (got.sv.nx, got.y.shape[0]) == (15, 60)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.se, want.se)
    np.testing.assert_array_equal(got.sv.xa, want.sv.xa)
    np.testing.assert_array_equal(got.sv.sa, want.sv.sa)
    for g, w in zip(got.vconv_list, want.vconv_list):
        np.testing.assert_array_equal(g, w)


def test_forward_fn_matches_jax(setups, jacobians):
    """forward_fn(xa) at rtol 1e-8, and the same spectrum from the
    Jacobian's pass."""
    (yn_jax, _), (yn, _), _ = jacobians
    _, got = setups
    y0 = got.forward_fn(np.asarray(got.sv.xa))
    np.testing.assert_allclose(y0.numpy(), yn_jax, rtol=1e-8, atol=0)
    np.testing.assert_array_equal(yn, y0.numpy())


def test_jacobian_matches_jax(jacobians):
    """Within 1e-8 of each column's peak of JAX's jacfwd."""
    (_, kk_jax), (_, kk), _ = jacobians
    assert kk.shape == kk_jax.shape == (60, 15)
    col_peak = np.abs(kk_jax).max(axis=0)
    assert (col_peak > 0).all()
    assert (np.abs(kk - kk_jax) <= 1e-8 * col_peak[None, :]).all()


def test_one_primal_synthesis_per_gas(setups, jacobians):
    """All 15 tangents ride the plain version's jvp; the primal (the kernel
    on the card) runs once per gas per evaluation."""
    _, got = setups
    assert jacobians[2] == got.deck.ktables.ngas == 1
