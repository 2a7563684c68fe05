"""Parameterisations acting outside the atmosphere profiles: surface,
measurement geometry, aerosol cross-sections, planet radius, the post-RT
spectral corrections and the instrument lineshape.

Port of the JAX package's ``models/domain_models.py``. Each model declares
``domain``:

- "surface":     apply_surface(entry, surf, x) -> SurfaceSpec
- "measurement": apply_measurement(entry, meas_state, x) -> dict updates
                 (e.g. {"tanhe_shift": dh}, {"v_doppler": v})
- "scatter":     apply_scatter(entry, aero, x) -> AerosolOptics
- "atmosphere":  apply(entry, atm, x) -> Atmosphere (pressure/radius models)
- "spectrum":    apply_spectrum(entry, igeom, vconv, spec, x) -> spec
                 (reference PostRT models, applied by subspecret
                 ForwardModel_0.py:2570 after convolution)
- "ils":         apply_ils(entry, igeom, vconv, x) -> (vconv', offset, fwhm,
                 amp), the double-Gaussian lineshape of models 228-230
"""

from __future__ import annotations

import numpy as np
import torch

from archnemesis_tpu_torch.models.base import (
    AprParseResult,
    ModelEntry,
    ProfileTarget,
    host_array,
    register_model,
)
from archnemesis_tpu_torch.rt.atmosphere import adjust_hydrostat_p, set_column
from archnemesis_tpu_torch.utils import datafiles


def _entry(varident, model_id, ix, nx, extra=()):
    return ModelEntry(
        varident=tuple(int(v) for v in varident),
        model_id=model_id,
        ix=ix,
        nx=nx,
        target=ProfileTarget.NOT_ATMOSPHERIC,
        target_idx=None,
        extra=extra,
    )


def _two(f):
    return [float(v) for v in f.readline().rsplit("!", 1)[0].split()[:2]]


@register_model
class Model999:
    """Retrieved surface temperature (reference model_999.py)."""

    id = 999
    domain = "surface"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        tsurf, err = _two(f)
        return AprParseResult(
            entry=_entry(varident, 999, ix, 1),
            x0=np.array([tsurf]),
            sx_diag=np.array([err**2]),
            lx=np.zeros(1, dtype=int),
            inum=np.zeros(1, dtype=int),
        )

    @staticmethod
    def apply_surface(entry, surf, x):
        return surf.replace(tsurf=x[0])


@register_model
class Model777:
    """Tangent-height correction for limb/SO geometries (reference
    model_777.py): shifts all measured tangent heights by a constant."""

    id = 777
    domain = "measurement"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        hcorr, herr = _two(f)
        return AprParseResult(
            entry=_entry(varident, 777, ix, 1),
            x0=np.array([hcorr]),
            sx_diag=np.array([herr**2]),
            lx=np.zeros(1, dtype=int),
            inum=np.ones(1, dtype=int),
        )

    @staticmethod
    def apply_measurement(entry, meas_state: dict, x):
        out = dict(meas_state)
        out["tanhe_shift"] = out.get("tanhe_shift", 0.0) + x[0]
        return out


@register_model
class Model666:
    """Tangent-pressure retrieval: re-anchor the pressure grid so
    p(htan) = ptan (reference model_666.py via adjust_hydrostatP)."""

    id = 666
    domain = "atmosphere"
    target = ProfileTarget.NOT_ATMOSPHERIC

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        htan = float(f.readline().split()[0])
        ptan, perr = _two(f)
        return AprParseResult(
            entry=_entry(varident, 666, ix, 1, extra=(htan,)),
            x0=np.array([np.log(ptan)]),
            sx_diag=np.array([(perr / ptan) ** 2]),
            lx=np.ones(1, dtype=int),
            inum=np.ones(1, dtype=int),
        )

    @staticmethod
    def apply(entry, atm, x):
        htan_m = entry.extra[0] * 1.0e3
        return adjust_hydrostat_p(atm, htan_m, x[0] * 101325.0)


def _catalogue_radius_m(atm) -> float:
    return datafiles.planet_info()[str(int(atm.planet))]["radius"] * 1.0e3


@register_model
class Model555:
    """Planet-radius correction in km (reference model_555.py). Note the
    reference's calc_grav re-reads the catalogue radius for known planets,
    silently discarding this correction unless IPLANET=-1; here, as in the
    JAX package, the override is honoured for every planet."""

    id = 555
    domain = "atmosphere"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        corr, err = _two(f)
        return AprParseResult(
            entry=_entry(varident, 555, ix, 1),
            x0=np.array([corr]),
            sx_diag=np.array([err**2]),
            lx=np.zeros(1, dtype=int),
            inum=np.ones(1, dtype=int),
        )

    @staticmethod
    def apply(entry, atm, x):
        return atm.replace(
            planet_radius=_catalogue_radius_m(atm) + x[0] * 1.0e3)


@register_model
class Model556:
    """Planet-radius scaling factor (reference model_556.py; same catalogue
    caveat as model 555)."""

    id = 556
    domain = "atmosphere"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        fac, err = _two(f)
        return AprParseResult(
            entry=_entry(varident, 556, ix, 1),
            x0=np.array([fac]),
            sx_diag=np.array([err**2]),
            lx=np.zeros(1, dtype=int),
            inum=np.ones(1, dtype=int),
        )

    @staticmethod
    def apply(entry, atm, x):
        return atm.replace(planet_radius=_catalogue_radius_m(atm) * x[0])


@register_model
class Model887:
    """Retrieved aerosol extinction cross-section spectrum (reference
    model_887.py): one (logged) value per .xsc wavelength with spectral
    correlation."""

    id = 887
    domain = "scatter"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        s = f.readline().split()
        nwv, icloud, clen = int(s[0]), int(s[1]), float(s[2])
        wv = np.zeros(nwv)
        xsc = np.zeros(nwv)
        err = np.zeros(nwv)
        for i in range(nwv):
            s = f.readline().split()
            wv[i], xsc[i], err[i] = float(s[0]), float(s[1]), float(s[2])
        var = (err / xsc) ** 2
        sx = np.diag(var).astype(float)
        for j in range(nwv):
            for k in range(nwv):
                xfac = np.exp(-abs((wv[k] - wv[j]) / clen))
                if xfac >= 0.001 and j != k:
                    sx[j, k] = np.sqrt(var[j] * var[k]) * xfac
        return AprParseResult(
            entry=_entry(varident, 887, ix, nwv, extra=(icloud,)),
            x0=np.log(xsc),
            sx_diag=var,
            lx=np.ones(nwv, dtype=int),
            inum=np.zeros(nwv, dtype=int),
            corr=sx,
        )

    @staticmethod
    def apply_scatter(entry, aero, x, **_kw):
        return aero.replace(
            kext=set_column(aero.kext, entry.extra[0], x.to(aero.kext.dtype)))


# ---------------------------------------------------------------------------
# PostRT spectral models (reference Models/PostRTModels, subspecret hook)
# ---------------------------------------------------------------------------


def _polyval(p, x):
    """``jnp.polyval(p, x)`` (highest power first) by Horner's rule."""
    y = torch.zeros_like(x)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


@register_model
class Model231:
    """Per-geometry polynomial scaling of the convolved spectrum in
    (wave - wave0) (reference PostRTModels/model_231.py)."""

    id = 231
    domain = "spectrum"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        fname = f.readline().split()[0]
        with open(fname) as fh:
            toks = fh.read().split()
        ngeom, ndeg = int(toks[0]), int(toks[1])
        vals = [float(v) for v in toks[2:]]
        x0, var = [], []
        k = 0
        for _ in range(ngeom):
            for _ in range(ndeg + 1):
                x0.append(vals[k])
                var.append(vals[k + 1] ** 2)
                k += 2
        n = ngeom * (ndeg + 1)
        return AprParseResult(
            entry=_entry(varident, 231, ix, n, extra=(ngeom, ndeg)),
            x0=np.asarray(x0),
            sx_diag=np.asarray(var),
            lx=np.zeros(n, dtype=int),
            inum=np.zeros(n, dtype=int),
        )

    @staticmethod
    def apply_spectrum(entry, igeom, vconv, spec, x):
        ngeom, ndeg = entry.extra
        coeff = x.reshape(ngeom, ndeg + 1)[igeom]
        dw = vconv - vconv[0]
        return spec * _polyval(coeff.flip(0), dw)


@register_model
class Model232:
    """Angstrom-law continuum dimming exp(-tau0 (w/w0)^-alpha) per geometry
    (reference PostRTModels/model_232.py)."""

    id = 232
    domain = "spectrum"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        wavenorm = float(f.readline().split()[0])
        fname = f.readline().split()[0]
        with open(fname) as fh:
            toks = fh.read().split()
        ngeom = int(toks[0])
        vals = [float(v) for v in toks[1:]]
        x0, var = [], []
        for i in range(ngeom):
            t0, e0, a, ea = vals[4 * i : 4 * i + 4]
            x0 += [t0, a]
            var += [e0**2, ea**2]
        n = 2 * ngeom
        return AprParseResult(
            entry=_entry(varident, 232, ix, n, extra=(ngeom, wavenorm)),
            x0=np.asarray(x0),
            sx_diag=np.asarray(var),
            lx=np.zeros(n, dtype=int),
            inum=np.zeros(n, dtype=int),
        )

    @staticmethod
    def apply_spectrum(entry, igeom, vconv, spec, x):
        ngeom, wavenorm = entry.extra
        tau0 = x[2 * igeom]
        alpha = x[2 * igeom + 1]
        return spec * torch.exp(-tau0 * (vconv / wavenorm) ** (-alpha))


@register_model
class Model233:
    """Log-quadratic continuum opacity exp(-exp(A0 + A1 ln w + A2 ln^2 w))
    per geometry (reference PostRTModels/model_233.py)."""

    id = 233
    domain = "spectrum"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        fname = f.readline().split()[0]
        with open(fname) as fh:
            toks = fh.read().split()
        ngeom = int(toks[0])
        vals = [float(v) for v in toks[1:]]
        x0, var = [], []
        for i in range(ngeom):
            a0, e0, a1, e1, a2, e2 = vals[6 * i : 6 * i + 6]
            x0 += [a0, a1, a2]
            var += [e0**2, e1**2, e2**2]
        n = 3 * ngeom
        return AprParseResult(
            entry=_entry(varident, 233, ix, n, extra=(ngeom,)),
            x0=np.asarray(x0),
            sx_diag=np.asarray(var),
            lx=np.zeros(n, dtype=int),
            inum=np.zeros(n, dtype=int),
        )

    @staticmethod
    def apply_spectrum(entry, igeom, vconv, spec, x):
        a0 = x[3 * igeom]
        a1 = x[3 * igeom + 1]
        a2 = x[3 * igeom + 2]
        lw = torch.log(vconv)
        tau = torch.exp(a0 + a1 * lw + a2 * lw**2)
        return spec * torch.exp(-tau)


@register_model
class Model667:
    """Spectral dilution factor (reference PostRTModels/model_667.py):
    multiplies the whole spectrum by one scalar."""

    id = 667
    domain = "spectrum"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        xfac, err = _two(f)
        return AprParseResult(
            entry=_entry(varident, 667, ix, 1),
            x0=np.array([xfac]),
            sx_diag=np.array([err**2]),
            lx=np.zeros(1, dtype=int),
            inum=np.zeros(1, dtype=int),
        )

    @staticmethod
    def apply_spectrum(entry, igeom, vconv, spec, x):
        return spec * x[0]


@register_model
class Model447:
    """Retrieved Doppler velocity shift (reference model_447.py):
    measurement-domain, sets v_doppler (km/s)."""

    id = 447
    domain = "measurement"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        v, err = _two(f)
        return AprParseResult(
            entry=_entry(varident, 447, ix, 1),
            x0=np.array([v]),
            sx_diag=np.array([err**2]),
            lx=np.zeros(1, dtype=int),
            inum=np.ones(1, dtype=int),
        )

    @staticmethod
    def apply_measurement(entry, meas_state: dict, x):
        out = dict(meas_state)
        out["v_doppler"] = x[0]
        return out


# ---------------------------------------------------------------------------
# Instrument-lineshape calibration models (ACS-MIR double Gaussian).
#
# Domain "ils": apply_ils(entry, igeom, vconv, x) -> (vconv', offset, fwhm,
# amp) with per-channel (NC, 2) Gaussian parameters, consumed by
# ops.convolution.double_gauss_ils_weights inside the differentiable forward
# function (the reference instead mutates Measurement.NFIL/VFIL/AFIL from
# subprofretg, model_228/229/230.py).
# ---------------------------------------------------------------------------


def _double_gauss_params(vconv, offset_main, deldg, fwhm_at_min, amp_lo,
                         amp_hi, wavemin, wavemax):
    """Shared tail of models 228-230: per-channel (NC, 2) offset/fwhm/amp.

    FWHM constant in wavelength units -> quadratic in wavenumber
    (model_229.py:127-132); second-Gaussian amplitude linear in wavenumber
    (model_229.py:134-139)."""
    offset = torch.stack([offset_main, offset_main + deldg], dim=1)
    fwhm0 = (fwhm_at_min / wavemin**2) * vconv**2
    fwhm = torch.stack([fwhm0, fwhm0], dim=1)
    ampgrad = (amp_hi - amp_lo) / (wavemax - wavemin)
    amp1 = (vconv - wavemin) * ampgrad + amp_lo
    amp = torch.stack([torch.ones_like(amp1), amp1], dim=1)
    return offset, fwhm, amp


@register_model
class Model228:
    """Wavelength calibration + double-Gaussian ILS for ACS MIR solar
    occultation (reference model_228.py): V0, dV = C0 + C1*i + C2*i^2
    rebuild VCONV; P0..P3 define the two Gaussians."""

    id = 228
    domain = "ils"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        vals, errs = [], []
        for _ in range(8):  # V0 C0 C1 C2 P0 P1 P2 P3
            v, e = _two(f)
            vals.append(v)
            errs.append(e)
        return AprParseResult(
            entry=_entry(varident, 228, ix, 8),
            x0=np.array(vals),
            sx_diag=np.array(errs) ** 2,
            lx=np.zeros(8, dtype=int),
            inum=np.ones(8, dtype=int),
        )

    @staticmethod
    def apply_ils(entry, igeom, vconv, x, **_kw):
        v0, c0, c1, c2, p0, p1, p2, p3 = (x[i] for i in range(8))
        nconv = vconv.shape[0]
        i = torch.arange(nconv - 1, dtype=x.dtype, device=x.device)
        dv = c0 + c1 * i + c2 * i**2
        vconv1 = v0 + torch.cat([dv.new_zeros(1), torch.cumsum(dv, 0)])
        wavemin, wavemax = vconv1[0], vconv1[-1]
        offset_main = torch.zeros_like(vconv1)
        off, fwhm, amp = _double_gauss_params(
            vconv1, offset_main, p0, p1, p2, p3, wavemin, wavemax
        )
        return vconv1, off, fwhm, amp


@register_model
class Model229:
    """Double-Gaussian ILS for ACS MIR (reference model_229.py): piecewise-
    linear main-Gaussian offset (A0 at wavemin, A1 at mid, A2 at wavemax),
    constant second-Gaussian offset DELDG, FWHM quadratic in wavenumber,
    linear relative amplitude."""

    id = 229
    domain = "ils"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        vals, errs = [], []
        for _ in range(7):
            v, e = _two(f)
            vals.append(v)
            errs.append(e)
        return AprParseResult(
            entry=_entry(varident, 229, ix, 7),
            x0=np.array(vals),
            sx_diag=np.array(errs) ** 2,
            lx=np.zeros(7, dtype=int),
            inum=np.zeros(7, dtype=int),
        )

    @staticmethod
    def apply_ils(entry, igeom, vconv, x, **_kw):
        a0, a1, a2, deldg, fw, amp_lo, amp_hi = (x[i] for i in range(7))
        nconv = vconv.shape[0]
        imid = nconv // 2
        wavemin, wavemax = vconv[0], vconv[-1]
        wavemid = vconv[imid]
        grad1 = (a1 - a0) / (wavemid - wavemin)
        grad2 = (a1 - a2) / (wavemid - wavemax)
        off_lo = (vconv - wavemin) * grad1 + a0
        off_hi = (vconv - wavemax) * grad2 + a2
        lower = torch.arange(nconv, device=vconv.device) < imid
        offset_main = torch.where(lower, off_lo, off_hi)
        off, fwhm, amp = _double_gauss_params(
            vconv, offset_main, deldg, fw, amp_lo, amp_hi, wavemin, wavemax
        )
        return vconv, off, fwhm, amp


@register_model
class Model230:
    """Windowed double-Gaussian ILS for ACS MIR (reference model_230.py):
    model-229 parameters fitted independently in NWINDOWS spectral windows
    given by static (liml, limh) bounds read from an auxiliary file."""

    id = 230
    domain = "ils"

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        aux = f.readline().split()[0]
        with open(aux) as fh:
            toks = fh.read().split()
        it = iter(toks)
        nwin = int(next(it))
        lims = []
        for _ in range(nwin):
            lims.append((float(next(it)), float(next(it))))
        vals, errs = [], []
        for _ in range(nwin):
            for _ in range(7):
                vals.append(float(next(it)))
                errs.append(float(next(it)))
        return AprParseResult(
            entry=_entry(varident, 230, ix, 7 * nwin,
                         extra=(nwin, tuple(lims))),
            x0=np.array(vals),
            sx_diag=np.array(errs) ** 2,
            lx=np.zeros(7 * nwin, dtype=int),
            inum=np.zeros(7 * nwin, dtype=int),
        )

    @staticmethod
    def apply_ils(entry, igeom, vconv, x, vconv_host=None, **_kw):
        """``vconv_host``: the measured grid as host numpy (static: only
        model 228 moves it), whose windows are index sets; read from
        ``vconv`` when None."""
        nwin, lims = entry.extra
        v_np = host_array(vconv if vconv_host is None else vconv_host)
        nconv = v_np.shape[0]
        offset_main = vconv.new_zeros(nconv)
        deldg = vconv.new_zeros(nconv)
        fw = vconv.new_zeros(nconv)
        amp1 = vconv.new_zeros(nconv)
        for iw in range(nwin):
            lo, hi = lims[iw]
            sel = np.where((v_np >= lo) & (v_np < hi))[0]
            if sel.size == 0:
                continue
            inwin = torch.as_tensor((v_np >= lo) & (v_np < hi),
                                    device=vconv.device)
            a0, a1, a2, dd, f5, p6, p7 = (x[7 * iw + i] for i in range(7))
            # window-local piecewise-linear offset split at the window's
            # middle channel (model_230.py iconvmid = nconv1/2)
            wavemin = float(v_np[sel[0]])
            wavemax = float(v_np[sel[-1]])
            wavemid = float(v_np[sel[sel.size // 2]])
            grad1 = (a1 - a0) / (wavemid - wavemin)
            grad2 = (a1 - a2) / (wavemid - wavemax)
            below = torch.as_tensor(v_np < wavemid, device=vconv.device)
            off_w = torch.where(
                below,
                (vconv - wavemin) * grad1 + a0,
                (vconv - wavemax) * grad2 + a2,
            )
            ampgrad = (p7 - p6) / (wavemax - wavemin)
            amp_w = (vconv - wavemin) * ampgrad + p6
            offset_main = torch.where(inwin, off_w, offset_main)
            deldg = torch.where(inwin, dd, deldg)
            fw = torch.where(inwin, (f5 / wavemin**2) * vconv**2, fw)
            amp1 = torch.where(inwin, amp_w, amp1)
        offset = torch.stack([offset_main, offset_main + deldg], dim=1)
        fwhm = torch.stack([fw, fw], dim=1)
        amp = torch.stack([torch.ones_like(amp1), amp1], dim=1)
        return vconv, offset, fwhm, amp
