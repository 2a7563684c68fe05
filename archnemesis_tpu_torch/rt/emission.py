"""Thermal-emission radiative transfer along line-of-sight paths.

Port of the JAX package's ``rt/emission.py`` (reference
``ForwardModel_0.py:6288`` calc_thermal_emission_spectrum): the running
transmission is a cumulative sum over the path axis, one
cumsum+exp+weighted-reduction over the (wave, g, layer, path) block.

spec = sum_j (T_{j-1} - T_j) * B(T_emission_j) + T_N * radground
with T_j = exp(-cumsum(tau)_j) along the path (observer -> far end).

``path_emission_spectrum`` is the same spectrum, g-integrated, taken from
the layer optical depths (``forward.py:path_spectrum``), with a
forward-mode rule of its own: its primal runs the ops of
``thermal_emission_spectrum``, bit for bit, and its tangents, all of
``jacfwd``'s at once, are one call of ``ops/tangent_cuda.py:
emission_tangent`` (one kernel launch on the card), which reads the
optical-depth tangents once, where PyTorch's forward-mode rules of those
ops made some 25 passes over tangents of their size.
"""

import torch

from archnemesis_tpu_torch.ops.planck import planck
from archnemesis_tpu_torch.utils.profiling import annotate

TANGENT_SPAN = "nemesis.spectrum.tangent"


def ground_radiance(wave, emtemp, tsurf, emissivity, gasgiant: bool,
                    ispace=0):
    """The ground's radiance under the paths: (NWAVE, NPATH) Planck at the
    bottom layer's temperature of each path for a gas giant, else (NWAVE,
    1) Planck at ``tsurf`` times ``emissivity``."""
    if gasgiant:
        return planck(wave[:, None], emtemp[-1, :][None, :], ispace)
    return planck(wave, tsurf, ispace)[:, None] * emissivity[:, None]


def _layer_emission(wave, tau_path, emtemp, mask, radground, ispace,
                    emission_path=None):
    """(spec (NWAVE, NG, NPATH), tr, taud): the layers' emission along the
    paths, the non-LTE emission where given, and the ground's radiance
    ``radground`` attenuated by the whole path where given."""
    tau_l = tau_path * mask[None, None, :, :]
    taud = torch.cumsum(tau_l, dim=2)
    tr = torch.exp(-taud)
    trold = torch.cat([torch.ones_like(tr[:, :, :1, :]), tr[:, :, :-1, :]],
                      dim=2)
    bb = planck(wave[:, None, None], emtemp[None, :, :], ispace)
    # T_{j-1} - T_j = T_{j-1} (1 - exp(-tau_j)), with expm1: the plain
    # difference of two transmissions near 1 loses every layer with
    # tau < 6e-8 in float32, and with it the whole temperature Jacobian of
    # the levels above the weighting functions
    dtr = trold * (-torch.expm1(-tau_l))
    spec = torch.einsum("wgjp,wjp->wgp", dtr, bb * mask[None, :, :])
    if emission_path is not None:
        spec = spec + torch.einsum("wgjp,wjp->wgp", tr,
                                   emission_path * mask[None, :, :])
    if radground is not None:
        spec = spec + tr[:, :, -1, :] * radground[:, None, :]
    return spec, tr, taud


def thermal_emission_spectrum(
    wave,
    tau_path,
    emtemp,
    mask,
    tsurf,
    emissivity,
    surface_visible: bool,
    gasgiant: bool,
    solflux=None,
    reflectance=None,
    sol_ang=None,
    emiss_ang=None,
    emission_path=None,
    ispace=0,
):
    """Thermal-emission spectra for all paths at once.

    Parameters
    ----------
    wave : (NWAVE,)
    tau_path : (NWAVE, NG, NLAYIN, NPATH) LOS optical depth per layer
    emtemp : (NLAYIN, NPATH) emission temperatures along each path
    mask : (NLAYIN, NPATH) 1 where the layer participates
    tsurf : scalar surface temperature (<=0 -> bottom-layer Planck)
    emissivity : (NWAVE,) surface emissivity on the calc grid
    surface_visible : False for limb paths (no ground term)
    gasgiant : True -> radground = Planck(bottom layer T)
    solflux, reflectance : optional (NWAVE,) solar flux and surface
        reflectance; with both given, a visible surface adds the
        plane-parallel reflection of the attenuated solar beam
    sol_ang, emiss_ang : (NPATH,) solar and emission angles (degrees) of
        each path for that term, which is zero on a path where either is
        90 or more
    emission_path : optional (NWAVE, NLAYIN, NPATH) non-LTE emission of
        each path layer, weighted by the transmission after the layer
        (the JAX package's ``rt/emission.py:60-63``)

    Returns
    -------
    spec : (NWAVE, NG, NPATH)
    """
    radground = (ground_radiance(wave, emtemp, tsurf, emissivity, gasgiant,
                                 ispace) if surface_visible else None)
    spec, tr, taud = _layer_emission(wave, tau_path, emtemp, mask, radground,
                                     ispace, emission_path)

    if surface_visible and solflux is not None and reflectance is not None:
        # plane-parallel surface reflection (ForwardModel_0.py:6368-6374),
        # active only where both angles are < 90; off those paths the
        # cosines are replaced before the division, so the term (and its
        # derivatives) stays finite where it is zeroed
        def angle(a):
            return torch.as_tensor(a, dtype=spec.dtype, device=spec.device)

        emiss_ang, sol_ang = angle(emiss_ang), angle(sol_ang)
        active = (emiss_ang < 90.0) & (sol_ang < 90.0)
        mu = torch.where(active, torch.cos(torch.deg2rad(emiss_ang)), 0.0)
        mu0 = torch.where(active, torch.cos(torch.deg2rad(sol_ang)), 1.0)
        refl = (tr[:, :, -1, :] * torch.exp(-taud[:, :, -1, :] * mu / mu0)
                * (solflux * reflectance)[:, None, None])
        spec = spec + refl * active.to(spec.dtype)
    return spec


def path_emission_spectrum(wave, tautot, layinc, scale, mask, emtemp,
                           radground, del_g, ispace=0):
    """(NWAVE, NPATH) g-integrated thermal emission of the paths from the
    layer optical depths ``tautot`` (NWAVE, NG, NLAY): the paths' layers
    ``layinc``, ``scale``, ``mask`` and ``emtemp`` (NLAYIN, NPATH), the
    ground's radiance ``radground`` (NWAVE, NPATH; None where the ground is
    not seen), the g weights ``del_g`` (NG,). The values of
    ``thermal_emission_spectrum`` on ``tautot[:, :, layinc] * scale``
    contracted with ``del_g``, bit for bit; forward-mode derivatives
    (``torch.func.jvp``/``jacfwd``, ``forward_ad``) in tautot, scale,
    emtemp and radground go through ``emission_tangent``, all tangents in
    one call, also under a ``vmap`` over locations inside ``jacfwd``."""
    return _PathEmission.apply(tautot.unsqueeze(0), scale, emtemp,
                               radground, layinc, mask, None, wave, del_g,
                               int(ispace), layinc.shape[1])


def _primal_spectrum(tau, scale, emtemp, ground, layinc, mask, loc, wave,
                     del_g, ispace, group):
    """``path_emission_spectrum``'s values on the Functions' operands: tau
    (B, NWAVE, NG, NLAY) of B locations, the paths in groups of ``group``
    on the locations ``loc`` (all on 0 where None)."""
    if loc is None:
        tau_path = tau[0][:, :, layinc] * scale[None, None, :, :]
    else:
        from archnemesis_tpu_torch.ops.tangent_cuda import path_locations

        at = path_locations(loc, group, layinc.shape[1], tau.device)
        tau_path = (tau[at[None, :], :, :, layinc].permute(2, 3, 0, 1)
                    * scale[None, None, :, :])
    spec = _layer_emission(wave, tau_path, emtemp, mask, ground, ispace)[0]
    return torch.einsum("wgp,g->wp", spec, del_g)


def _fold_paths(x, dim, n):
    """A vmapped (..., A, NPATH) operand as (..., A, n NPATH): batch entry
    b's path p at b NPATH + p."""
    from archnemesis_tpu_torch.ops.overlap_cuda import _stack_batch

    if x is None:
        return None
    return _stack_batch(x, dim, n).movedim(0, -2).flatten(-2)


def _fold_batch(n, dims, tau, scale, emtemp, ground, layinc, mask, loc,
                tau_batched: bool):
    """The Functions' primal operands of a vmapped batch as one set of
    paths: each batch entry's paths their own groups, on the entry's own
    locations of tau where ``tau_batched`` (the batch joins tau's location
    axis, entry b's location j at b B + j), else on the locations they
    had."""
    from archnemesis_tpu_torch.ops.overlap_cuda import _stack_batch

    if any(d is not None for d in dims[6:9]):
        raise ValueError("path_emission_spectrum: one set of locations, "
                         "one wave grid and one set of g weights for every "
                         "batch entry")
    if loc is None:
        loc = torch.zeros(1, dtype=torch.int64, device=tau.device)
    if tau_batched:
        tau = _stack_batch(tau, dims[0], n)
        offset = torch.arange(n, device=tau.device)[:, None] * tau.shape[1]
        tau, loc = tau.flatten(0, 1), (offset + loc[None, :]).flatten()
    else:
        loc = loc.repeat(n)
    return (tau, *(_fold_paths(x, d, n) for x, d in zip(
        (scale, emtemp, ground, layinc, mask), dims[1:6])), loc)


class _PathEmission(torch.autograd.Function):
    """``path_emission_spectrum`` on tau (B, NWAVE, NG, NLAY), paths in
    groups of ``group`` on the locations ``loc``; forward mode only, its
    tangents through ``_PathEmissionTangent``."""

    @staticmethod
    def forward(tau, scale, emtemp, ground, layinc, mask, loc, wave, del_g,
                ispace, group):
        return _primal_spectrum(tau, scale, emtemp, ground, layinc, mask,
                                loc, wave, del_g, ispace, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:9])
        ctx.ispace, ctx.group = inputs[9:]

    @staticmethod
    def jvp(ctx, dtau, dscale, demtemp, dground, *_):
        tangents = [None if x is None else x.unsqueeze(0)
                    for x in (dtau, dscale, demtemp, dground)]
        primals = ctx.saved_tensors
        if all(x is None for x in tangents):
            return primals[0].new_zeros((primals[7].shape[0],
                                         primals[4].shape[1]))
        return _PathEmissionTangent.apply(*primals, ctx.ispace, ctx.group,
                                          *tangents)[0]

    @staticmethod
    def vmap(info, in_dims, tau, scale, emtemp, ground, layinc, mask, loc,
             wave, del_g, ispace, group):
        # batched primals (a vmap over locations): the batch's paths as
        # one set, the batch joining tau's locations
        n = info.batch_size
        folded = _fold_batch(n, in_dims, tau, scale, emtemp, ground, layinc,
                             mask, loc, in_dims[0] is not None)
        out = _PathEmission.apply(*folded, wave, del_g, ispace, group)
        return out.unflatten(1, (n, -1)).movedim(1, 0), 0


class _PathEmissionTangent(torch.autograd.Function):
    """The primal operands of ``_PathEmission`` and stacked tangents (T,
    ...) of tau, scale, emtemp and the ground's radiance (each None where
    absent) -> (T, NWAVE, NPATH) tangents of the spectrum: one
    ``emission_tangent`` call. A vmap folds its batch into T where the
    primals are shared (the tangents of ``jacfwd``) and into the paths and
    locations where they are not, so every level ends in one call."""

    @staticmethod
    def forward(tau, scale, emtemp, ground, layinc, mask, loc, wave, del_g,
                ispace, group, dtau, dscale, demtemp, dground):
        from archnemesis_tpu_torch.ops.tangent_cuda import emission_tangent

        with annotate(TANGENT_SPAN):
            return emission_tangent(
                tau, layinc, scale, mask, emtemp, ground, wave, del_g,
                ispace=ispace, loc=loc, group=group, dtau=dtau,
                dscale=dscale, demtemp=demtemp, dground=dground)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, tau, scale, emtemp, ground, layinc, mask, loc,
             wave, del_g, ispace, group, dtau, dscale, demtemp, dground):
        from archnemesis_tpu_torch.ops.overlap_cuda import _stack_batch

        n = info.batch_size
        tangents = (dtau, dscale, demtemp, dground)
        tan_dims = in_dims[11:]
        if all(d is None for d in in_dims[:9]):
            # primals shared: the batch joins the tangents
            stacked = [None if x is None else
                       _stack_batch(x, d, n).flatten(0, 1)
                       for x, d in zip(tangents, tan_dims)]
            out = _PathEmissionTangent.apply(
                tau, scale, emtemp, ground, layinc, mask, loc, wave, del_g,
                ispace, group, *stacked)
            return out.unflatten(0, (n, -1)), 0
        # batched primals: the batch joins the paths, and tau's locations
        # wherever tau or its tangent differs between entries
        tau_batched = in_dims[0] is not None or tan_dims[0] is not None
        folded = _fold_batch(n, in_dims, tau, scale, emtemp, ground, layinc,
                             mask, loc, tau_batched)
        if dtau is not None:
            dtau = _stack_batch(dtau, tan_dims[0], n)  # (n, T, B, ...)
            dtau = (dtau.movedim(0, 1).flatten(1, 2) if tau_batched
                    else dtau[0])
        dpaths = [_fold_paths(x, d, n) for x, d in
                  zip(tangents[1:], tan_dims[1:])]
        out = _PathEmissionTangent.apply(*folded, wave, del_g, ispace,
                                         group, dtau, *dpaths)
        return out.unflatten(2, (n, -1)).movedim(2, 0), 0


def transmission_spectrum(tau_total_path):
    """Pure transmission: exp(-tau) (reference
    calculate_transmission_spectrum)."""
    return torch.exp(-tau_total_path)


def absorption_spectrum(tau_total_path):
    """1 - exp(-tau) (reference calculate_absorption_spectrum)."""
    return 1.0 - torch.exp(-tau_total_path)
