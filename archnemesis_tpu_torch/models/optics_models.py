"""Aerosol/CIA optical-property parameterisations: retrieved particle sizes
and refractive indices (reference Models/PreRTModels/model_444.py,
model_446.py) and the gaussian-basis CIA opacity (model_500.py).

Port of the JAX package's optics-model module. These act on the "scatter"
(``AerosolOptics``) and "cia" (``CIATables``) domains. For model 444,
Kramers-Kronig and the Mie chain run inside the forward, so Jacobians come
from ``torch.func.jacfwd`` instead of the reference's finite differences.
Model 202 scales a profile of the telluric (Earth) atmosphere
(``rt/telluric.py``), in the "telluric" domain.
"""

from __future__ import annotations

import numpy as np
import torch

from archnemesis_tpu_torch.models.base import (
    AprParseResult,
    host_array,
    register_model,
)
from archnemesis_tpu_torch.models.domain_models import _entry
from archnemesis_tpu_torch.ops.mie import kk_new_sub, makephase, radius_grid
from archnemesis_tpu_torch.rt.atmosphere import set_column
from archnemesis_tpu_torch.utils.interp import interp


@register_model
class Model446:
    """Aerosol extinction/albedo from a particle-size lookup table
    (reference model_446.py): the state holds one particle size; KEXT and
    SGLALB are bilinearly interpolated from an HDF5 lookup (WAVE, REFF)
    onto the aerosol wave grid, with optional normalisation at a given
    wavelength."""

    id = 446
    domain = "scatter"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        import h5py

        s = f.readline().split()
        idust, wavenorm = int(s[0]), int(s[1])
        xwave = float(s[2]) if wavenorm == 1 else 0.0
        fname = f.readline().split()[0]
        s = f.readline().split()
        r0, err = float(s[0]), float(s[1])

        with h5py.File(fname, "r") as h:
            wave_lu = np.asarray(h["WAVE"])
            reff = np.asarray(h["REFF"])
            kext_lu = np.asarray(h["KEXT"])  # (NWAVE, NSIZE)
            sglalb_lu = np.asarray(h["SGLALB"])

        return AprParseResult(
            entry=_entry(
                varident, 446, ix, 1,
                extra=(idust, wavenorm, xwave, wave_lu, reff, kext_lu,
                       sglalb_lu),
            ),
            x0=np.array([r0]),
            sx_diag=np.array([err**2]),
            lx=np.zeros(1, dtype=int),
            inum=np.ones(1, dtype=int),
        )

    @staticmethod
    def apply_scatter(entry, aero, x, **_kw):
        idust, wavenorm, xwave, wave_lu, reff, kext_lu, sglalb_lu = (
            entry.extra
        )
        wave = aero.wave.to(x.dtype)

        def table(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   dtype=x.dtype, device=x.device)

        # axis-0 interpolation of the lookup onto the aerosol wave grid,
        # as (NSIZE, NWAVE_AERO)
        wave_lu_t = table(wave_lu)
        kext1 = _interp_columns(wave, wave_lu_t, table(kext_lu))
        alb1 = _interp_columns(wave, wave_lu_t, table(sglalb_lu))
        # size interpolation at the (clamped) retrieved radius
        rsize = torch.minimum(
            torch.maximum(x[0], x.new_full((), float(np.min(reff)))),
            x.new_full((), float(np.max(reff))))
        reff_t = table(reff)
        kextx = interp(rsize, reff_t, kext1)
        albx = interp(rsize, reff_t, alb1)
        if wavenorm == 1:
            kextx = kextx / interp(x.new_tensor(xwave), wave, kextx)
        kscax = albx * kextx
        return aero.replace(
            kext=set_column(aero.kext, idust, kextx.to(aero.kext.dtype)),
            ksca=set_column(aero.ksca, idust, kscax.to(aero.ksca.dtype)),
        )


def _interp_columns(x, xp, fp):
    """``jnp.interp(x, xp, fp[:, k])`` for every column k of ``fp``
    (NXP, K), as rows of a (K, NX) result."""
    return torch.stack([interp(x, xp, fp[:, k]) for k in range(fp.shape[1])])


@register_model
class Model500:
    """CIA opacity as a gaussian basis with constant P/T dependence
    (reference model_500.py): the whole K_CIA table is replaced by the
    basis expansion on pair VARIDENT[1] over the spectroscopy wave range;
    amplitudes are retrieved in log space and scaled by 1e-40."""

    id = 500
    domain = "cia"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        fname = f.readline().split()[0]
        with open(fname) as af:
            toks = af.read().split()
        nbasis = int(float(toks[0]))
        clen = float(toks[1])
        amp = np.array([float(toks[2 + 2 * j]) for j in range(nbasis)])
        eamp = np.array([float(toks[3 + 2 * j]) for j in range(nbasis)])
        var = (eamp / amp) ** 2
        sx = np.diag(var).copy()
        for j in range(nbasis):
            for k in range(nbasis):
                xfac = np.exp(-abs((j - k) / clen))
                if xfac >= 0.001 and j != k:
                    sx[j, k] = np.sqrt(var[j] * var[k]) * xfac
        return AprParseResult(
            entry=_entry(varident, 500, ix, nbasis,
                         extra=(int(varident[1]),)),
            x0=np.log(amp),
            sx_diag=var,
            lx=np.ones(nbasis, dtype=int),
            inum=np.zeros(nbasis, dtype=int),
            corr=sx,
        )

    @staticmethod
    def apply_cia(entry, cia, x, wave_range=None, waven_host=None, **_kw):
        """wave_range = (vlo, vhi) in cm-1, the spectroscopy table range
        (reference hook, model_500.py:185-196); ``waven_host``: the CIA
        grid as host numpy (static deck data), read from ``cia.waven``
        when None."""
        icia = entry.extra[0]
        waven = host_array(cia.waven if waven_host is None else waven_host)
        vlo, vhi = wave_range
        ilo = int(np.argmin(np.abs(waven - vlo)))
        ihi = int(np.argmin(np.abs(waven - vhi)))
        nbasis = entry.nx
        width = (ihi - ilo) / nbasis
        centers = np.linspace(ilo, ihi, nbasis)
        idx = np.arange(ilo, ihi + 1)
        g_mat = np.exp(
            -((idx[:, None] - centers[None, :]) ** 2) / (2.0 * width**2)
        )
        # amplitudes are in raw 1e-40 cm^5 units; fold in any balance
        # prescale the table carries (CIATables.k_scale) so the rebuilt
        # k_cia stays consistent with ops.cia.cia_tau's residual handling
        k_cia = cia.k_cia
        curve = torch.as_tensor(g_mat, dtype=x.dtype, device=x.device) @ (
            x * (1e-40 * cia.k_scale))
        # the rebuilt table, out of place: zero but on pair icia over
        # [ilo, ihi], where every (para, temperature) row is the curve
        row = torch.nn.functional.pad(
            curve, (ilo, k_cia.shape[-1] - ihi - 1)).to(k_cia.dtype)
        pair = torch.arange(k_cia.shape[0], device=k_cia.device) == icia
        k = torch.where(pair[:, None, None, None],
                        row.expand(k_cia.shape), k_cia.new_zeros(()))
        return cia.replace(k_cia=k)


@register_model
class Model444:
    """Retrieved particle-size distribution + imaginary refractive-index
    spectrum (reference model_444.py): state = [log a, log b,
    log k_im(haze waves)]. Per evaluation: Kramers-Kronig for the real
    index anchored at (WAVE_REF, NREAL), Mie makephase over the aerosol
    wave grid, extinction normalised at WAVE_NORM. As in the JAX package the
    phase-function refit (reference class makephase IMIE=0 double-HG fit)
    is not applied: KEXT/KSCA update only.
    """

    id = 444
    domain = "scatter"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        s = f.readline().split()
        with open(s[0]) as hf:
            x0l, varl = [], []
            for _ in range(2):  # a, b
                t = hf.readline().split()
                x0l.append(np.log(float(t[0])))
                varl.append((float(t[1]) / float(t[0])) ** 2)
            nwave_s, clen_s = hf.readline().split("!")[0].split()
            vref_s, nreal_s = hf.readline().split("!")[0].split()
            vnorm_s = hf.readline().split("!")[0]
            nwave, clen = int(nwave_s), float(clen_s)
            haze_waves = []
            for _ in range(nwave):
                t = hf.readline().split()
                x0l.append(np.log(float(t[1])))
                varl.append((float(t[2]) / float(t[1])) ** 2)
                haze_waves.append(float(t[0]))
                if clen < 0:
                    break
        nx = len(x0l)
        var = np.asarray(varl)
        sx = np.diag(var).copy()
        if clen > 0:
            # spectral correlation between the k_im entries; the reference
            # indexes this block off the END of the variable
            # (model_444.py:236-244, writing into the next model's rows);
            # the JAX package applies it to the k_im block itself, and so
            # does the port
            for j in range(len(haze_waves)):
                for k in range(len(haze_waves)):
                    xfac = np.exp(-abs((haze_waves[k] - haze_waves[j]) / clen))
                    if xfac >= 0.001 and j != k:
                        sx[2 + j, 2 + k] = (
                            np.sqrt(var[2 + j] * var[2 + k]) * xfac
                        )
        return AprParseResult(
            entry=_entry(
                varident, 444, ix, nx,
                extra=(
                    int(varident[1]) - 1,  # aerosol species index
                    1,  # iscat (reference hard-codes gamma, model_444.py:246)
                    tuple(haze_waves),
                    float(vref_s),
                    float(nreal_s),
                    float(vnorm_s),
                ),
            ),
            x0=np.asarray(x0l),
            sx_diag=var,
            lx=np.ones(nx, dtype=int),
            inum=np.zeros(nx, dtype=int),
            corr=sx,
        )

    @staticmethod
    def apply_scatter(entry, aero, x, ispace=0, rs_cap=1024, wave_host=None,
                      **_kw):
        """``wave_host``: the aerosol wave grid as host numpy (a tensor's
        values cannot be read inside ``torch.func`` transforms); read from
        ``aero.wave`` when None."""
        idust, iscat, haze_waves, vref, nreal_ref, vnorm = entry.extra
        # Kramers-Kronig and Mie run in float64 whatever the run's type: in
        # float32 the series' |a_n|^2+|b_n|^2 can stall just above its
        # 1e-14 cutoff (the upward Riccati-Bessel recurrence loses psi_n
        # past n ~ x) until chi_n overflows and the cross sections turn NaN
        x = x.to(torch.float64)
        haze_np = np.asarray(haze_waves, dtype=np.float64)
        haze_w = x.new_tensor(haze_np)
        a, b = x[0], x[1]
        k_im = x[2:]
        if k_im.shape[0] == 1:
            k_im = k_im.expand(haze_np.shape[0])
        n_real = kk_new_sub(haze_np, k_im, vref, nreal_ref)

        # calculation wavelengths in microns, ascending
        # (reference class makephase Scatter_0.py:1294-1300); the aerosol
        # grid is static deck data
        wave = (aero.wave.detach().cpu().double().numpy()
                if wave_host is None else np.asarray(wave_host, np.float64))
        if ispace == 0:
            wavel = np.sort(1.0e4 / wave)
            iord = np.argsort(1.0e4 / wave)
        else:
            wavel = wave
            iord = np.arange(wave.size)
        wavel_t = x.new_tensor(wavel)
        re_w = interp(wavel_t, haze_w, n_real)
        im_w = interp(wavel_t, haze_w, k_im)
        refindx = torch.stack([re_w, im_w], dim=1)

        if iscat == 1:
            pars = torch.stack([a, b, (1.0 - 3.0 * b) / b])
        elif iscat == 2:
            pars = torch.stack([a, b, torch.zeros_like(a)])
        else:
            raise NotImplementedError(f"model 444 iscat={iscat}")

        r0 = 0.015 * float(wavel.min())
        rs = (r0, 0.0, r0)  # reference auto mode (Scatter_0.py:1319-1323)
        # static Mie series caps: the retrieved refractive index is
        # differentiated, so the data-dependent caps inside makephase
        # (Scatter_0.py:1458 analog) are not read from it: |m| is bounded by
        # 3 (real planetary aerosols stay well under this) and the caps come
        # from the static radius/wavelength grid
        radii_np, _, _ = radius_grid(rs, cap=rs_cap)
        xmax = float(2.0 * np.pi * np.max(radii_np) / wavel.min())
        n_start = max(150, int(1.2 * 3.0 * xmax) + 20)
        nmax = min(n_start,
                   max(60, int(xmax + 4.05 * xmax ** (1.0 / 3.0)) + 20))
        xscat, xext, _, _ = makephase(
            wavel_t, iscat, pars, rs, refindx,
            np.array([0.0, 90.0]), rs_cap=rs_cap,
            nmax=nmax, n_start=n_start,
        )
        # back to the aerosol wave ordering, normalise at vnorm
        inv = torch.as_tensor(np.argsort(iord), device=x.device)
        kextx = xext[inv]
        kscax = xscat[inv]
        norm = interp(x.new_tensor(vnorm), aero.wave.to(x.dtype), kextx)
        kextx = kextx / norm
        kscax = kscax / norm
        return aero.replace(
            kext=set_column(aero.kext, idust, kextx.to(aero.kext.dtype)),
            ksca=set_column(aero.ksca, idust, kscax.to(aero.ksca.dtype)),
        )


@register_model
class Model202:
    """Constant scaling of a telluric atmospheric profile (reference
    model_202.py): varident[0]==0 scales the Earth temperature profile,
    varident[0]>0 scales the VMR of gas (varident[0], varident[1])."""

    id = 202
    domain = "telluric"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        t = f.readline().rsplit("!", 1)[0].split()
        x0, err = float(t[0]), float(t[1])
        return AprParseResult(
            entry=_entry(varident, 202, ix, 1),
            x0=np.array([x0]),
            sx_diag=np.array([err**2]),
            lx=np.zeros(1, dtype=int),
            inum=np.ones(1, dtype=int),
        )

    @staticmethod
    def apply_telluric(entry, tel, x, **_kw):
        if tel is None:
            return tel
        varid1, varid2 = entry.varident[0], entry.varident[1]
        atm = tel.atm
        if varid1 == 0:
            return tel.replace(atm=atm.replace(t=atm.t * x[0]))
        jvmr = None
        for j, (g, s) in enumerate(zip(atm.gas_id, atm.iso_id)):
            if g == varid1 and s == varid2:
                jvmr = j
        if jvmr is None:
            raise ValueError(
                f"model 202: gas {varid1}/{varid2} not in telluric atmosphere")
        return tel.replace(atm=atm.replace(
            vmr=set_column(atm.vmr, jvmr, atm.vmr[:, jvmr] * x[0])))
