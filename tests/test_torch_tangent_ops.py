"""The correlated-k forward's tangent passes (``ops/tangent_cuda.py``,
``csrc/tangent_ops.cu``): one gas's stacked optical-depth tangents from its
factored k, and the random overlap's skip rule on a combine's tangents;
the plain versions on the CPU against the formulas they stand for, the
mixture step (``ops/overlap_cuda.py:mix_pair``) against ``combine_pair``
and ``torch.where`` under ``jacfwd``, and the kernels against the plain
versions on the card (``cuda``: skipped without one)."""

import numpy as np
import pytest
import torch

from archnemesis_tpu_torch.ops import overlap_cuda, tangent_cuda


@pytest.fixture
def cuda():
    """The card, or a skip: the kernels are built with nvcc and have no
    CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are built with nvcc "
                    "and have no CPU mode")
    return torch.device("cuda")


def _factors(dtype, nwave=37, nlay=11, ng=20, n_tan=9, n_batch=2, seed=0,
             device="cpu"):
    g = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64).to(
            dtype=dtype, device=device)

    return ([draw(n_batch, nwave, nlay, ng) for _ in range(3)],
            [draw(n_tan, n_batch, nlay) for _ in range(3)])


def _mixture_rows(rows=300, ng=8, seed=1):
    """(tau_a, tau_b, del_g): rows sorted along g, some all zero in a, in
    b or in both (the skip rule's three cases)."""
    rng = np.random.default_rng(seed)
    a, b = (np.sort(np.exp(rng.normal(-2, 2, (rows, ng))), axis=1)
            for _ in range(2))
    a[::7] = 0.0
    b[::5] = 0.0
    del_g = 0.5 * np.polynomial.legendre.leggauss(ng)[1]
    return torch.as_tensor(a), torch.as_tensor(b), del_g


def test_gas_tau_tangent_plain_is_the_formula():
    (k, fv, fu), (a, b, c) = _factors(torch.float64)
    got = tangent_cuda.gas_tau_tangent(k, fv, fu, a, b, c)
    want = (fv[None] * a[:, :, None, :, None]
            + fu[None] * b[:, :, None, :, None]
            + k[None] * c[:, :, None, :, None])
    torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)


def test_skip_rows_plain_takes_the_rule():
    g = torch.Generator().manual_seed(2)
    dout, da, db = (torch.randn(4, 50, 6, generator=g) for _ in range(3))
    skip_a = torch.arange(50) % 3 == 0
    skip_b = torch.arange(50) % 4 == 0
    want = dout.clone()
    want[:, skip_a] = db[:, skip_a]
    want[:, skip_b] = da[:, skip_b]
    got = tangent_cuda.skip_rows_(dout, da, db, skip_a, skip_b)
    assert got is dout and torch.equal(got, want)


def _batched_gas_tau(nest, device="cpu", seed=5):
    """(factored, linear): the Jacobian of one gas's optical depth in three
    states each (per-layer v, u and amount of a 3-element x), by
    ``LayerK.tau`` and by the plain first-order expansion of k about the
    states, under ``nest``: ``vmap`` over the states of ``jacfwd``, or
    ``jacfwd`` of that ``vmap``."""
    from archnemesis_tpu_torch.ops.ktab import LayerK

    g = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=g,
                           dtype=torch.float64).to(device)

    n, nwave, nlay, ng = 3, 5, 4, 6
    k, fv, fu = (draw(n, 2, nwave, nlay, ng) for _ in range(3))
    x, w = draw(n, 3), draw(3, nlay)

    def state(xs):
        return (torch.tanh(xs[0] * w[0]), torch.sigmoid(xs[1] * w[1]),
                torch.exp(xs[2] * w[2]))

    v0, u0, _ = torch.func.vmap(state)(x)

    def factored(xs, kk, dv_, du_, v0_, u0_):
        v, u, amount = state(xs)
        return LayerK(k=kk, dk_dv=dv_, dk_du=du_, v=v, u=u).tau(1, amount)

    def linear(xs, kk, dv_, du_, v0_, u0_):
        v, u, amount = state(xs)
        lay = (slice(None), None)
        k1 = kk[1] + dv_[1] * (v - v0_)[lay] + du_[1] * (u - u0_)[lay]
        return k1 * amount[lay]

    args = (x, k, fv, fu, v0, u0)

    def jac(f):
        if nest == "vmap_of_jacfwd":
            return torch.func.vmap(torch.func.jacfwd(f))(*args)
        return torch.func.jacfwd(
            lambda z: torch.func.vmap(f)(z, *args[1:]))(x)

    primal = torch.func.vmap(factored)(*args)
    assert torch.equal(primal, k[:, 1] * torch.func.vmap(state)(x)[2][
        :, None, :, None])
    return jac(factored), jac(linear)


@pytest.mark.parametrize("nest", ["vmap_of_jacfwd", "jacfwd_of_vmap"])
def test_gas_tau_tangent_of_batched_states(nest):
    """Batched factors (vmap over states, inside or outside ``jacfwd``):
    ``LayerK.tau``'s Jacobian is the first-order expansion's."""
    got, want = _batched_gas_tau(nest)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)


def _old_mixture(a, b, del_g):
    mixed = overlap_cuda.combine_pair(a, b, del_g)
    return torch.where((b[:, -1] <= 0)[:, None], a,
                       torch.where((a[:, -1] <= 0)[:, None], b, mixed))


def test_mix_pair_equals_combine_and_where_under_jacfwd():
    """The primal bit for bit and the Jacobian at rtol 1e-12 (float64) of a
    mixture whose rows take each branch of the skip rule."""
    a, b, del_g = _mixture_rows()
    scales = torch.linspace(0.5, 1.5, 6, dtype=torch.float64)

    def mixture(mix, s):
        aa = a * s[0] + (a * s[1]) ** 2
        bb = b * s[2] + b * s[3] * s[4] + s[5] * 0.0
        return mix(aa, bb, del_g)

    assert torch.equal(mixture(overlap_cuda.mix_pair, scales),
                       mixture(_old_mixture, scales))
    got = torch.func.jacfwd(
        lambda s: mixture(overlap_cuda.mix_pair, s))(scales)
    want = torch.func.jacfwd(lambda s: mixture(_old_mixture, s))(scales)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)


def test_mix_pair_under_vmap_of_states():
    """Batched primals (vmap over states) fold into rows: the same mixture
    and tangents as one state at a time."""
    a, b, del_g = _mixture_rows(rows=40)
    scales = torch.stack([torch.linspace(0.5, 1.5, 2, dtype=torch.float64),
                          torch.linspace(1.1, 0.7, 2, dtype=torch.float64)])

    def mixture(s):
        return overlap_cuda.mix_pair(a * s[0], b * s[1], del_g)

    batched = torch.func.vmap(torch.func.jacfwd(mixture))(scales)
    for i in range(2):
        torch.testing.assert_close(batched[i],
                                   torch.func.jacfwd(mixture)(scales[i]),
                                   rtol=1e-13, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gas_tau_tangent_kernel_matches_plain_on_card(cuda, dtype):
    (k, fv, fu), (a, b, c) = _factors(dtype, nwave=301, nlay=71, n_tan=86,
                                      n_batch=1, seed=3)
    want = tangent_cuda.gas_tau_tangent(k, fv, fu, a, b, c)
    before = tangent_cuda.gas_tau_tangent.launches
    got = tangent_cuda.gas_tau_tangent(*(x.to(cuda) for x in
                                         (k, fv, fu, a, b, c)))
    torch.cuda.synchronize()
    assert tangent_cuda.gas_tau_tangent.launches == before + 1
    # the kernel's two fused multiply-adds against the plain version's
    # separate roundings: a few units in the last place of each term
    eps = torch.finfo(dtype).eps
    scale = (fv.abs() * a.abs().amax() + fu.abs() * b.abs().amax()
             + k.abs() * c.abs().amax())[None]
    assert ((got.cpu() - want).abs() <= 4 * eps * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nest", ["vmap_of_jacfwd", "jacfwd_of_vmap"])
def test_gas_tau_tangent_of_batched_states_on_card(cuda, nest):
    """Batched factors on the card: one launch for all states and
    tangents, the CPU's Jacobian within float64 rounding."""
    before = tangent_cuda.gas_tau_tangent.launches
    got, _ = _batched_gas_tau(nest, device=cuda)
    assert tangent_cuda.gas_tau_tangent.launches == before + 1
    want, _ = _batched_gas_tau(nest)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-13, atol=1e-15)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_skip_rows_kernel_matches_plain_on_card(cuda, dtype):
    g = torch.Generator().manual_seed(4)
    dout, da, db = (torch.randn(86, 4099, 20, generator=g).to(dtype)
                    for _ in range(3))
    skip_a = torch.arange(4099) % 3 == 0
    skip_b = torch.arange(4099) % 4 == 0
    on_card = [x.to(cuda) for x in (dout, da, db, skip_a, skip_b)]
    got = tangent_cuda.skip_rows_(*on_card)
    want = tangent_cuda.skip_rows_(dout, da, db, skip_a, skip_b)
    assert got is on_card[0] and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_mix_pair_tangents_on_card_match_the_cpu(cuda):
    """The mixture's Jacobian on the card (the fused combine and the skip
    kernel) against the plain versions' on the CPU, float64."""
    a, b, del_g = _mixture_rows(rows=2000, ng=20)
    scales = torch.linspace(0.5, 1.5, 4, dtype=torch.float64)

    def jac(device):
        aa, bb, s = a.to(device), b.to(device), scales.to(device)
        return torch.func.jacfwd(lambda z: overlap_cuda.mix_pair(
            aa * z[0] + aa * aa * z[1], bb * z[2] + z[3] * bb,
            del_g))(s).cpu()

    # 1e-12 of the peak, kernel 1t's own card test's bound: the kernel's
    # weight scan adds in another order than torch.cumsum, and where an
    # element ends near a bin edge the overlap's rounding shows in that
    # bin (on an H100, 2 of these 160,000 elements differ by 1.8e-9 of
    # their own value)
    want = jac("cpu")
    torch.testing.assert_close(jac(cuda), want, rtol=0,
                               atol=1e-12 * want.abs().max().item())
