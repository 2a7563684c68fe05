"""Layering, nadir path, dust renormalisation and the interpolation and
quadrature helpers of the PyTorch port vs the JAX package, and the
layering vs the reference golden (``tests/goldens/jupiter_layering.npz``),
in float64."""

import numpy as np
import pytest
import torch

from archnemesis_tpu.core.types import LayerConfig
from archnemesis_tpu.forward import apply_dust_renorm as jax_apply_dust_renorm
from archnemesis_tpu.rt.layer import build_layers as jax_build_layers
from archnemesis_tpu.rt.path import nadir_path as jax_nadir_path
from archnemesis_tpu.utils import interp as jax_interp
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.forward import apply_dust_renorm
from archnemesis_tpu_torch.rt.layer import build_layers
from archnemesis_tpu_torch.rt.path import nadir_path
from archnemesis_tpu_torch.utils.interp import (
    interp1d_extrap,
    interp1d_extrap_with_weights,
    simpson,
    simpson_weights,
)
from port_cases import flat, layering_atmosphere, np64

LAYER_FIELDS = ("baseh", "basep", "baset", "delh", "height", "press", "temp",
                "totam", "amount", "pp", "cont", "frac", "laysf")
PATH_FIELDS = ("layinc", "scale", "emtemp", "mask", "sol_ang", "emiss_ang",
               "azi_ang")


@pytest.fixture(scope="module")
def atmospheres():
    atm, dl = layering_atmosphere()
    return atm, convert.atmosphere(flat(atm), device="cpu"), dl


def _config(dl, laytyp, layint):
    return LayerConfig(
        nlay=int(dl["NLAY"]), laytyp=laytyp, layint=layint,
        layht=max(float(dl["LAYHT"]), float(dl["H"][0])),
        p_base=dl["BASEP"] if laytyp == 4 else None,
        h_base=dl["BASEH"] if laytyp == 5 else None,
    )


@pytest.mark.parametrize("layint", [0, 1])
@pytest.mark.parametrize("laytyp,layang", [(0, 0.0), (1, 0.0), (2, 0.0),
                                           (3, 0.0), (3, 45.0), (4, 0.0),
                                           (5, 0.0)])
def test_layers_and_path_match_jax(atmospheres, laytyp, layang, layint):
    jatm, atm, dl = atmospheres
    jcfg = _config(dl, laytyp, layint)
    cfg = convert.layer_config(flat(jcfg))
    want = jax_build_layers(jatm, jcfg, layang=layang)
    got = build_layers(atm, cfg, layang=layang)
    for name in LAYER_FIELDS:
        w = np64(getattr(want, name))
        atol = 1e-12 * np.abs(w).max() if w.size else 0.0
        np.testing.assert_allclose(np64(getattr(got, name)), w, rtol=1e-10,
                                   atol=atol, err_msg=name)

    jpath = jax_nadir_path(want, jatm.radius, jatm.h[-1], 30.0,
                           sol_ang=120.0, azi_ang=10.0)
    path = nadir_path(got, atm.radius, atm.h[-1], 30.0, sol_ang=120.0,
                      azi_ang=10.0)
    for name in PATH_FIELDS:
        np.testing.assert_allclose(np64(getattr(path, name)),
                                   np64(getattr(jpath, name)), rtol=1e-10,
                                   atol=0, err_msg=name)
    assert path.imod == jpath.imod and path.npath == 1


@pytest.mark.parametrize("field,key", [(f, f.upper()) for f in LAYER_FIELDS])
def test_layers_match_golden(atmospheres, field, key):
    _, atm, dl = atmospheres
    cfg = convert.layer_config(flat(_config(dl, int(dl["LAYTYP"]),
                                            int(dl["LAYINT"]))))
    got = np64(getattr(build_layers(atm, cfg, layang=float(dl["LAYANG"])),
                       field))
    want = dl[key]
    # the reference golden's bound (tests/test_layering.py)
    atol = 1e-18 * np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=field)


@pytest.mark.parametrize("renorm", [None, [0.0], [0.7]])
def test_apply_dust_renorm_matches_jax(atmospheres, renorm):
    jatm, atm, dl = atmospheres
    if renorm is not None:
        jatm = jatm.replace(dust_renorm=np.asarray(renorm))
        atm = atm.replace(dust_renorm=torch.as_tensor(renorm,
                                                      dtype=torch.float64))
    jcfg = _config(dl, int(dl["LAYTYP"]), int(dl["LAYINT"]))
    want = jax_apply_dust_renorm(jax_build_layers(jatm, jcfg), jatm).cont
    got = apply_dust_renorm(
        build_layers(atm, convert.layer_config(flat(jcfg))), atm).cont
    np.testing.assert_allclose(np64(got), np64(want), rtol=1e-10,
                               atol=1e-12 * np.abs(np64(want)).max())


def test_interp_helpers_match_jax():
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(-5.0, 5.0, 12))
    fp = rng.standard_normal((12, 3))
    x = rng.uniform(-8.0, 8.0, (4, 5))  # inside and beyond both ends
    np.testing.assert_allclose(
        interp1d_extrap(torch.as_tensor(xp), torch.as_tensor(fp),
                        torch.as_tensor(x)).numpy(),
        np.asarray(jax_interp.interp1d_extrap(xp, fp, x)), rtol=1e-13)
    j, f = interp1d_extrap_with_weights(torch.as_tensor(xp),
                                        torch.as_tensor(x))
    jj, jf = jax_interp.interp1d_extrap_with_weights(xp, x)
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-13)


@pytest.mark.parametrize("n", [2, 3, 8, 101])
def test_simpson_matches_jax(n):
    np.testing.assert_array_equal(simpson_weights(n),
                                  jax_interp.simpson_weights(n))
    y = np.random.default_rng(n).standard_normal((3, n))
    np.testing.assert_allclose(
        simpson(torch.as_tensor(y), 0.25, dim=1).numpy(),
        np.asarray(jax_interp.simpson(y, 0.25, axis=1)), rtol=1e-13)
