"""Non-LTE emissions in the PyTorch port (``core/emissions.py``,
``io/emissions.py``, ``ops/emissions.py``, the ``emis`` inputs of
``forward.forward_nadir``) against the JAX package: the tables read from
the HDF5 fixtures and from their committed ``.npz`` exports equal the JAX
reader's; ``emission_rates`` and ``layer_emission`` at rtol 1e-10 on seeded
layers (with and without the stellar distance, and a one-temperature
table); the ``jupiter_emissions_fm`` golden at the JAX test's rtol 1e-5
from the exports; and a ``jacfwd`` through the emission term (temperature
and the NH3 and C2H2 columns) against JAX's, column by column."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.io.emissions import read_emission_tables as jax_read
from archnemesis_tpu.ops import emissions as jem
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.forward import forward_nadir
from archnemesis_tpu_torch.io.emissions import read_emission_tables
from archnemesis_tpu_torch.ops import emissions as tem
from archnemesis_tpu_torch.ops.convolution import conv_channel_interp
from archnemesis_tpu_torch.rt.atmosphere import set_column
import chip_smoke
from port_cases import (
    EM_GOLDEN,
    EMISS_DIR,
    EMISS_NAMES,
    assert_same_structure,
    cuda,  # noqa: F401 (a fixture)
    flat,
    jax_golden_deck,
    one_torch_thread,  # noqa: F401 (a fixture)
    to_port,
    torch_threads,
    write_emission_exports,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H5 = [os.path.join(EMISS_DIR, n + ".h5") for n in EMISS_NAMES]
# the window of the Jacobian comparison: the C2H2 band, 40 calc waves
JAC_WINDOW = (700.0, 800.0)


@pytest.fixture(scope="module")
def jtables():
    return jax_read(H5)


@pytest.mark.parametrize("source", ["h5", "npz"])
def test_tables_match_jax(jtables, source):
    paths = H5 if source == "h5" else list(chip_smoke.EMISS_EXPORTS)
    got = read_emission_tables(paths)
    assert got.k.device.type == "cpu" and got.k.dtype == torch.float64
    assert_same_structure(got, jtables, "emissions")
    d = np.load(EM_GOLDEN)
    np.testing.assert_array_equal(got.k.numpy(), d["EM_K"][:, :, [1, 0]])


def test_committed_exports_equal_fresh_exports(tmp_path):
    write_emission_exports(str(tmp_path))
    for name in EMISS_NAMES:
        fresh = np.load(tmp_path / f"{name}.npz")
        committed = np.load(os.path.join(chip_smoke.PORT_DATA, name + ".npz"))
        assert sorted(fresh.files) == sorted(committed.files)
        for key in fresh.files:
            np.testing.assert_array_equal(fresh[key], committed[key], key)


def test_emissions_group_matches_jax(jtables, tmp_path):
    """A run file's ``Emissions`` group (NEM and the tables' LOCATIONs)
    read as the JAX reader reads it, from the ``.h5`` and from its
    ``.npz`` export; no group, or NEM = 0, reads as None."""
    import shutil

    import h5py

    from archnemesis_tpu.io.emissions import read_emissions_group as jgroup
    from archnemesis_tpu_torch.io.emissions import read_emissions_group
    from archnemesis_tpu_torch.io.hdf5 import export_deck_hdf5

    run = tmp_path / "run.h5"
    shutil.copy(chip_smoke.SO_DECK + "/" + chip_smoke.SO_RUN + ".h5", run)
    assert read_emissions_group(str(run)) is None is jgroup(str(run))
    with h5py.File(run, "a") as f:
        g = f.create_group("Emissions")
        g["NEM"] = 2
        g["LOCATION"] = np.asarray([os.path.abspath(p).encode() for p in H5])
    want = jgroup(str(run))
    export_deck_hdf5(str(run), str(tmp_path / "run.npz"))
    for path in (run, tmp_path / "run.npz"):
        assert_same_structure(read_emissions_group(str(path)), want,
                              "emissions")
    with h5py.File(run, "a") as f:
        f["Emissions/NEM"][()] = 0
    assert read_emissions_group(str(run)) is None is jgroup(str(run))


def test_write_emission_table_matches_jax(jtables, tmp_path):
    """A table written by the port reads back through the JAX reader as
    the fixture does, and the port's file holds the JAX writer's
    datasets."""
    from archnemesis_tpu.io.emissions import write_emission_table as jwrite
    from archnemesis_tpu_torch.io.emissions import write_emission_table
    from archnemesis_tpu_torch.io.hdf5 import read_run_groups

    for i in range(jtables.nem):
        kw = dict(gas_id=jtables.gas_id[i], iso_id=jtables.iso_id[i],
                  emtype=jtables.emtype[i], ispace=jtables.ispace,
                  wave=np.asarray(jtables.wave),
                  temp=np.asarray(jtables.temp),
                  k=np.asarray(jtables.k)[:, :, i],
                  dist_ref=float(np.asarray(jtables.dist_ref)[i]),
                  rate_coeff=np.asarray(jtables.rate_coeff)[:, i])
        write_emission_table(str(tmp_path / f"port{i}"), **kw)
        jwrite(str(tmp_path / f"jax{i}"), **kw)
        a = read_run_groups(str(tmp_path / f"port{i}.h5"))
        b = read_run_groups(str(tmp_path / f"jax{i}.h5"))
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], key)
    got = jax_read([str(tmp_path / f"port{i}") for i in range(jtables.nem)])
    assert_same_structure(convert.emission_tables(flat(got), device="cpu"),
                          jtables, "written")


def _tables(jtables, nt1: bool):
    """(JAX tables, port tables): the fixtures', or their first
    temperature only (the NT=1 branch)."""
    if nt1:
        jtables = jtables.replace(temp=np.asarray(jtables.temp)[:1],
                                  k=np.asarray(jtables.k)[:, :1],
                                  rate_coeff=np.asarray(jtables.rate_coeff)[:1])
    return jtables, convert.emission_tables(flat(jtables), device="cpu")


@pytest.mark.parametrize("nt1", [False, True])
@pytest.mark.parametrize("dist", [None, 9.546])
def test_layer_emission_matches_jax(jtables, nt1, dist):
    """Seeded layer temperatures (some beyond the table's 80-260 K, where
    the rates clamp) and columns, on a calc grid reaching past the table's
    ends (zero fill): rtol 1e-10."""
    jt, tt = _tables(jtables, nt1)
    rng = np.random.default_rng(14)
    nlay, nvmr = 17, 5
    temp = rng.uniform(60.0, 300.0, nlay)
    amount = 10.0 ** rng.uniform(18.0, 24.0, (nlay, nvmr))
    wave = np.sort(rng.uniform(-10.0, 1420.0, 300))
    cols = (3, 1)
    want_r = np.asarray(jem.emission_rates(jt, jnp.asarray(temp), dist=dist))
    got_r = tem.emission_rates(tt, torch.as_tensor(temp), dist=dist).numpy()
    np.testing.assert_allclose(got_r, want_r, rtol=1e-10, atol=0)
    want = np.asarray(jem.layer_emission(jt, jnp.asarray(wave),
                                         jnp.asarray(temp),
                                         jnp.asarray(amount), cols, dist=dist))
    got = tem.layer_emission(tt, torch.as_tensor(wave),
                             torch.as_tensor(temp), torch.as_tensor(amount),
                             cols, dist=dist).numpy()
    assert np.abs(want).max() > 0 and np.all(got[(wave < 1.0)] == 0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_locate_emission_gases(jtables):
    tt = convert.emission_tables(flat(jtables), device="cpu")
    atm = jax_golden_deck()[0]
    assert tem.locate_emission_gases(tt, atm.gas_id, atm.iso_id) == \
        jem.locate_emission_gases(jtables, atm.gas_id, atm.iso_id) == (2, 0)
    with pytest.raises(ValueError, match="exactly one"):
        tem.locate_emission_gases(tt, (1, 2), (0, 0))


@pytest.fixture(scope="module")
def port_deck():
    return to_port(jax_golden_deck())


def _dist():
    d = np.load(EM_GOLDEN)
    return float(d["DIST"]) if bool(d["SOLEXIST"]) else None


def test_emissions_golden_from_exports(port_deck):
    """The golden deck with both tables read from the exports: SPECONV of
    ``jupiter_emissions_fm`` at the JAX test's rtol 1e-5 (the emission
    carries ~8 % of it)."""
    atm, laycfg, ktab, cia, aero, surf, cfg = port_deck
    em = read_emission_tables(list(chip_smoke.EMISS_EXPORTS))
    cols = tem.locate_emission_gases(em, atm.gas_id, atm.iso_id)
    with torch_threads(2):
        spec = forward_nadir(atm, laycfg, ktab, cia, aero, surf, cfg,
                             emiss_ang=0.0, sol_ang=180.0, emis=em,
                             emis_gas_cols=cols, emis_dist=_dist(),
                             device="cpu")
    d = np.load(EM_GOLDEN)
    nconv = int(d["NCONV"][0])
    got = conv_channel_interp(torch.as_tensor(d["WAVE"]), spec[:, 0],
                              torch.as_tensor(d["VCONV"][:nconv, 0])).numpy()
    np.testing.assert_allclose(got, d["SPECONV"][:nconv, 0], rtol=1e-5,
                               atol=0)


def _windowed(jdeck):
    """The golden deck with its k-tables cut to ``JAC_WINDOW``."""
    atm, laycfg, ktab, cia, aero, surf, cfg = jdeck
    w = np.asarray(ktab.wave)
    sel = np.where((w >= JAC_WINDOW[0]) & (w <= JAC_WINDOW[1]))[0]
    ktab = ktab.replace(wave=w[sel], k=np.asarray(ktab.k)[:, sel])
    return atm, laycfg, ktab, cia, aero, surf, cfg


def test_emission_jacobian_matches_jax(jtables):
    """jacfwd of the forward with both tables in the state (the temperature
    profile's scale and the NH3 and C2H2 VMR scales) against JAX's jitted
    jacfwd, column by column within 1e-10 of each column's peak, on the
    C2H2 band; the emission term moves every column."""
    jdeck = _windowed(jax_golden_deck())
    jatm, jlay, jkt, jcia, jaero, jsurf, jcfg = jdeck
    atm, laycfg, ktab, cia, aero, surf, cfg = to_port(jdeck)
    tt = convert.emission_tables(flat(jtables), device="cpu")
    cols = tem.locate_emission_gases(tt, atm.gas_id, atm.iso_id)
    dist = _dist()
    x0 = np.array([1.0, 1.0, 1.0])

    def port_f(x, with_emis=True):
        vmr = atm.vmr
        for i, c in enumerate(cols):
            vmr = set_column(vmr, c, vmr[:, c] * x[1 + i])
        a = atm.replace(t=atm.t * x[0], vmr=vmr)
        kw = (dict(emis=tt, emis_gas_cols=cols, emis_dist=dist)
              if with_emis else {})
        return forward_nadir(a, laycfg, ktab, cia, aero, surf, cfg,
                             emiss_ang=0.0, sol_ang=180.0, device="cpu",
                             **kw)[:, 0]

    def jax_f(x):
        from archnemesis_tpu.forward import forward_nadir as jfwd

        vmr = jnp.asarray(jatm.vmr)
        for i, c in enumerate(cols):
            vmr = vmr.at[:, c].multiply(x[1 + i])
        a = jatm.replace(t=jnp.asarray(jatm.t) * x[0], vmr=vmr)
        return jfwd(a, jlay, jkt, jcia, jaero, jsurf, jcfg, emiss_ang=0.0,
                    sol_ang=180.0, emis=jtables, emis_gas_cols=cols,
                    emis_dist=dist)[:, 0]

    with torch_threads(2):
        got = torch.func.jacfwd(port_f)(torch.as_tensor(x0)).numpy()
        bare = torch.func.jacfwd(lambda x: port_f(x, False))(
            torch.as_tensor(x0)).numpy()
    want = np.asarray(jax.jit(jax.jacfwd(jax_f))(jnp.asarray(x0)))
    peak = np.abs(want).max(axis=0)
    assert np.all(peak > 0)
    col_err = np.abs(got - want).max(axis=0) / peak
    assert col_err.max() < 1e-10, col_err
    moved = np.abs(got - bare).max(axis=0) / peak
    assert np.all(moved > 1e-3), moved


@pytest.mark.cuda
def test_emission_forward_on_card_matches_plain(cuda):
    """On the card, phase 23's emission case on the C2H2 band (the golden
    deck read by the port, the tables from their exports): the forward
    through kernel 1 (6 launches) and its jacfwd (temperature, C2H2 and
    NH3 scales) through kernel 1t (6 launches) equal to the plain
    combine's on the CPU within 1e-10 (each column of its peak)."""
    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_with_tangents,
    )

    card = chip_smoke.emission_state_forward(
        chip_smoke.emission_case(cuda, window=JAC_WINDOW), cuda)
    cpu = chip_smoke.emission_state_forward(
        chip_smoke.emission_case("cpu", window=JAC_WINDOW), "cpu")
    one = torch.ones(3, dtype=torch.float64)
    before = combine_pair.launches
    y = card(one.to(cuda))
    torch.cuda.synchronize()
    assert combine_pair.launches - before == 6
    np.testing.assert_allclose(y.cpu().numpy(), cpu(one).numpy(),
                               rtol=1e-10, atol=0)
    before = combine_pair_with_tangents.launches
    k = torch.func.jacfwd(card)(one.to(cuda)).cpu()
    torch.cuda.synchronize()
    assert combine_pair_with_tangents.launches - before == 6
    want = torch.func.jacfwd(cpu)(one)
    err = (k - want).abs().max(dim=0).values / want.abs().max(dim=0).values
    assert float(err.max()) < 1e-10, err
