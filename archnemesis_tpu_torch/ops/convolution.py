"""Instrument-lineshape convolution of calculated spectra.

Port of the JAX package's ``ops/convolution.py``. Mirrors the reference
Measurement convolution entry points
(``Measurement_0.py``: conv :2288, lblconv :2125, numba kernels :3335+):

- FWHM == 0: channel-integrator mode — k-tables already include the filter;
  just interpolate the calc grid onto the convolution wavelengths.
- FWHM > 0: square/triangular/Gaussian ILS: precomputed banded weight
  matrix applied as a matrix product (replaces the per-channel loops).
- FWHM < 0: per-channel filter functions (.fil): weight matrix built from
  the tabulated filters.

The static weight matrices are built host-side in numpy and applied as a
single (NCONV, NWAVE) @ (NWAVE, ...) contraction on tensors. Two are
tensor functions of the state, differentiable under ``torch.func``: the
double-Gaussian ILS of models 228-230 and the filter integration with a
retrieved Doppler shift (model 447).
"""

import numpy as np
import torch

from archnemesis_tpu_torch.enums import InstrumentLineshape, WaveUnit
from archnemesis_tpu_torch.utils.interp import interp1d_extrap

_C_LIGHT = 299792458.0  # m/s


def doppler_corrected_wave(wave, v_doppler, ispace):
    """Shift a rest-frame calc grid into the observer frame
    (reference Measurement_0.correct_doppler_shift:2851-2875).

    v_doppler [km/s] is positive for motion towards the observer; in
    wavenumber space the grid shrinks, in wavelength space it stretches.
    Works for numpy arrays and tensors alike.
    """
    beta = v_doppler * 1.0e3 / _C_LIGHT
    fac = (1.0 - beta) if int(ispace) == int(WaveUnit.Wavenumber_cm) \
        else (1.0 + beta)
    return wave * fac


def invert_doppler_shift(wave, v_doppler, ispace):
    """Observer-frame wavelengths -> rest frame (reference
    Measurement_0.invert_doppler_shift:2824-2848); used to widen the calc
    range before synthesis."""
    beta = v_doppler * 1.0e3 / _C_LIGHT
    fac = (1.0 - beta) if int(ispace) == int(WaveUnit.Wavenumber_cm) \
        else (1.0 + beta)
    return wave / fac


def conv_channel_interp(wave, spec, vconv):
    """FWHM=0 channel mode: linear interpolation onto vconv
    (Measurement_0.py conv:2428-2434)."""
    return interp1d_extrap(wave, spec, vconv)


def ils_weights_lbl(wave: np.ndarray, vconv: np.ndarray, fwhm: float,
                    ishape: InstrumentLineshape) -> np.ndarray:
    """(NCONV, NWAVE) weights reproducing the reference numba lblconv kernel
    (Measurement_0.py:3335) exactly: discrete ILS samples at the calc-grid
    points inside the window, normalised by their sum (no quadrature
    weighting).
    """
    nconv = vconv.shape[0]
    nwave = wave.shape[0]
    out = np.zeros((nconv, nwave))
    for ic in range(nconv):
        vc = vconv[ic]
        if ishape == InstrumentLineshape.Square:
            v1, v2 = vc - 0.5 * fwhm, vc - 0.5 * fwhm + fwhm
            fn = lambda w: np.ones_like(w)
        elif ishape == InstrumentLineshape.Triangular:
            v1, v2 = vc - fwhm, vc + fwhm
            fn = lambda w: 1.0 - np.abs(w - vc) / fwhm
        elif ishape == InstrumentLineshape.Gaussian:
            sig = 0.5 * fwhm / np.sqrt(np.log(2.0))
            v1, v2 = vc - 3.0 * sig, vc + 3.0 * sig
            fn = lambda w: np.exp(-(((w - vc) / sig) ** 2))
        elif ishape == InstrumentLineshape.Hamming:
            # Hamming-apodized FTS sinc (reference lblconv kernel
            # Measurement_0.py:3392-3430). The reference window has a typo
            # (v2 = vcen - 1.1*fwhm, making it empty); the documented intent
            # — and what we implement — is the symmetric +-1.1*FWHM window.
            v1, v2 = vc - 1.1 * fwhm, vc + 1.1 * fwhm

            def fn(w, vc=vc, fwhm=fwhm):
                a = 0.907 / fwhm
                k = w - vc
                x = 2.0 * a * k  # sinc argument
                # f = a*(1.08 - 0.64 a^2 k^2) * sinc(x) / (1 - x^2), with
                # removable singularities at x=0 (-> 1.08*a) and x=+-1
                # (-> 0.46*a by L'Hopital).
                denom = 1.0 - x * x
                safe = np.abs(denom) > 1e-8
                core = np.where(safe, np.sinc(x) / np.where(safe, denom, 1.0),
                                0.5)
                return a * (1.08 - 0.16 * x * x) * core
        elif ishape == InstrumentLineshape.Hanning:
            # The reference has no working Hanning ILS (build_ils raises
            # "ishape not included yet", Measurement_0.py:1994; the lblconv
            # kernel leaves f1=0). Kept unimplemented for honest parity.
            raise NotImplementedError(
                "Hanning ILS is unimplemented in the reference as well "
                "(Measurement_0.py:1994)")
        else:
            raise NotImplementedError(f"ISHAPE {ishape} not implemented")
        sel = np.where((wave >= v1) & (wave <= v2))[0]
        a = fn(wave[sel])
        a = np.where(a > 0.0, a, 0.0)  # reference only accumulates f1 > 0
        out[ic, sel] = a / a.sum()
    return out


def apply_ils(weights, spec):
    """Apply a (NCONV, NWAVE) ILS weight matrix to spec (NWAVE, ...)."""
    weights = torch.as_tensor(weights, dtype=spec.dtype, device=spec.device)
    return torch.tensordot(weights, spec, dims=([1], [0]))


def ils_weights_filter(wave: np.ndarray, vconv: np.ndarray,
                       nfil: np.ndarray, vfil: np.ndarray,
                       afil: np.ndarray) -> np.ndarray:
    """(NCONV, NWAVE) weights from per-channel tabulated filter functions
    (.fil files, FWHM<0), reproducing the reference numba lblconv_fil kernel
    (Measurement_0.py:3549): linear-interp the filter onto the calc-grid
    points inside its span, keep f>0, normalise by the sum.
    """
    nconv = vconv.shape[0]
    out = np.zeros((nconv, wave.shape[0]))
    for j in range(nconv):
        n = int(nfil[j])
        xp, yp = vfil[:n, j], afil[:n, j]
        sel = np.where((wave >= xp[0]) & (wave <= xp[-1]))[0]
        f = np.interp(wave[sel], xp, yp)
        f = np.where(f > 0.0, f, 0.0)
        s = f.sum()
        if s > 0:
            out[j, sel] = f / s
    return out


def double_gauss_ils_weights(wave, vconv, offset, fwhm, amp, xdist=5.0):
    """Differentiable (NCONV, NWAVE) ILS weights for a per-channel
    double-Gaussian lineshape (ACS-MIR models 228/229/230).

    The JAX package's reformulation of the reference's two-step
    construction (model_229.py:141-190 builds per-channel sampled filters
    with ngauss, then lblconv_fil linearly re-interpolates them onto the
    calc grid): the Gaussians are evaluated directly at the calc-grid
    wavenumbers, the exact limit of the reference's sample-then-interp,
    with the same xdist * FWHM/2 per-Gaussian support window, then
    row-normalised. The support mask comes before the normalisation, so a
    Gaussian's far wing, which underflows in float32, never enters a row.

    Parameters: wave (NW,), vconv (NC,), offset/fwhm/amp (NC, NG) tensors
    (``wave`` may be host numpy).
    """
    wave = torch.as_tensor(wave, dtype=offset.dtype, device=offset.device)
    mean = vconv[:, None, None] + offset[:, :, None]  # (NC, NG, 1)
    sig = fwhm[:, :, None] / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    d = wave[None, None, :] - mean
    gauss = amp[:, :, None] * torch.exp(-0.5 * (d / sig) ** 2)
    support = torch.abs(d) <= (xdist * 0.5 * fwhm[:, :, None])
    f = torch.sum(torch.where(support, gauss, 0.0), dim=1)  # (NC, NW)
    f = torch.where(f > 0.0, f, 0.0)
    return f / torch.sum(f, dim=1, keepdim=True)


def _trapz_weights(x: np.ndarray) -> np.ndarray:
    """Weights w with w @ y == np.trapz(y, x)."""
    w = np.zeros_like(x)
    if x.size < 2:
        return w
    dx = np.diff(x)
    w[:-1] += 0.5 * dx
    w[1:] += 0.5 * dx
    return w


def conv_quad_weights(wave: np.ndarray, vconv: np.ndarray, fwhm: float,
                      vfwhm: np.ndarray = None, xfwhm: np.ndarray = None,
                      nstep: int = 20) -> np.ndarray:
    """(NCONV, NWAVE) weights for the k-table (ILBL=0) FWHM>0 convolution:
    a cubic-spline boxcar average over [vc - f/2, vc + f/2] sampled at nstep
    points (reference Measurement_0.conv:2288-2419). Per-channel FWHM comes
    from a .fwh table (vfwhm, xfwhm) when given (conv's FWHMEXIST path,
    :2383-2400).

    Deviations from the reference, which we fix rather than reproduce
    (documented because conv's FWHM>0 branch is numerically broken there):
    the accumulator at :2416 telescopes (yi[j]-yold)*dx/2 instead of the
    trapezoid (yi[j]+yold)*dx/2, and the edge-extension at :2369 mixes
    ModSpec[1]-ModSpec[2] with Wave[1]-Wave[0]. We use the exact trapezoid
    and consistent two-point linear extrapolation.

    The whole operation (extend grid -> cubic spline -> sample -> trapezoid
    / fwhm) is linear in the input spectrum, so it is one
    (NCONV, NWAVE) matrix product.
    """
    from scipy.interpolate import CubicSpline

    nconv, nwave = vconv.shape[0], wave.shape[0]
    fw = (np.interp(vconv, vfwhm, xfwhm) if vfwhm is not None
          else np.full(nconv, float(fwhm)))

    # extend the calc grid so channel windows near the edges stay in range
    # (reference :2349-2371), keeping the map linear in the spectrum
    lo_needed = (vconv - fw).min() < wave[0]
    hi_needed = (vconv + fw).max() > wave[-1]
    ext_x = [wave]
    # E maps the original spectrum onto the extended grid: y_ext = E @ y
    rows = [np.eye(nwave)]
    if lo_needed:
        x0 = (vconv - fw).min() - fw.max()
        slope_row = np.zeros(nwave)
        d = wave[1] - wave[0]
        slope_row[0] = 1.0 + (wave[0] - x0) / d
        slope_row[1] = -(wave[0] - x0) / d
        rows.insert(0, slope_row[None, :])
        ext_x.insert(0, np.array([x0]))
    if hi_needed:
        x1 = (vconv + fw).max() + fw.max()
        slope_row = np.zeros(nwave)
        d = wave[-1] - wave[-2]
        slope_row[-1] = 1.0 + (x1 - wave[-1]) / d
        slope_row[-2] = -(x1 - wave[-1]) / d
        rows.append(slope_row[None, :])
        ext_x.append(np.array([x1]))
    E = np.concatenate(rows, axis=0)
    xg = np.concatenate(ext_x)

    # spline-evaluation as a matrix: CubicSpline is linear in the data, so
    # splining the identity gives S with spline(y)(xi) == S(xi) @ y_ext
    cs = CubicSpline(xg, np.eye(xg.size), axis=0)
    out = np.zeros((nconv, nwave))
    for ic in range(nconv):
        xi = np.linspace(vconv[ic] - 0.5 * fw[ic], vconv[ic] + 0.5 * fw[ic],
                         nstep)
        S = cs(xi)  # (nstep, n_ext)
        tw = _trapz_weights(xi) / fw[ic]
        out[ic] = (tw @ S) @ E
    return out


def integrate_filter_weights(wave: np.ndarray, vconv: np.ndarray,
                             nfil: np.ndarray, vfil: np.ndarray,
                             afil: np.ndarray) -> np.ndarray:
    """(NCONV, NWAVE) weights for IFORM=Integrated_radiance: trapezoid
    integral of spectrum x filter over each channel's filter span, NOT
    normalised (units W cm-2 sr-1; reference integrate_filter
    Measurement_0.py:2696 + numba kernel :4079-4127)."""
    nconv = vconv.shape[0]
    out = np.zeros((nconv, wave.shape[0]))
    for j in range(nconv):
        n = int(nfil[j])
        xp, yp = vfil[:n, j], afil[:n, j]
        sel = np.where((wave >= xp[0]) & (wave <= xp[-1]))[0]
        if sel.size == 0:
            continue
        af = np.interp(wave[sel], xp, yp)
        out[j, sel] = af * _trapz_weights(wave[sel])
    return out


def _interp_rows(x, xp, fp, n):
    """``jnp.interp(x[j], xp[j, :n[j]], fp[j, :n[j]])`` for every row j at
    once: x (NC, M), xp/fp (NC, NF) with rows padded past n[j] by +inf /
    anything, n (NC,) long tensor."""
    i = torch.searchsorted(xp, x.contiguous(), right=True)
    i = torch.minimum(torch.clamp(i, min=1), (n - 1).clamp(min=1)[:, None])
    xp0, xp1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    fp0, fp1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    dx = xp1 - xp0
    delta = x - xp0
    eps = np.spacing(torch.finfo(xp.dtype).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp0, fp0 + (delta / torch.where(dx0, 1.0, dx))
                    * (fp1 - fp0))
    first = xp[:, :1]
    last_i = (n - 1)[:, None]
    f = torch.where(x < first, fp[:, :1], f)
    return torch.where(x > torch.gather(xp, 1, last_i),
                       torch.gather(fp, 1, last_i), f)


def integrate_filter_apply(wave, spec, nfil, vfil, afil,
                           v_doppler=0.0, ispace=0, v_doppler_nominal=None):
    """Differentiable IFORM=Integrated_radiance integration with a possibly
    retrieved Doppler velocity (model 447 retrieves v_doppler; the
    reference integrate_filter corrects the calc grid first,
    Measurement_0.py:2720).

    Channel membership (which calc points fall inside each filter span) is
    fixed at the grid corrected by the *nominal* velocity, as in the JAX
    package, where membership is a static index set under jit; the
    integrand stays exactly differentiable in ``v_doppler`` around that
    nominal. The JAX package loops over the channels; here the members
    are one padded (NCONV, max members) gather (a channel's members are a
    contiguous run of the ascending grid) and each channel's filter is
    interpolated and trapezoid-integrated over its run under a mask, so an
    evaluation makes the same few launches whatever NCONV.

    ``wave``: the rest-frame calc grid (host numpy or a tensor); ``spec``
    (NWAVE,) tensor; ``nfil``/``vfil``/``afil`` the .fil tables (host).
    """
    if v_doppler_nominal is None:
        v_doppler_nominal = float(v_doppler)
    # a tensor's values through .tolist(): .numpy() raises inside torch.func
    wave_np = np.asarray(wave.detach().cpu().tolist()
                         if isinstance(wave, torch.Tensor) else wave,
                         dtype=np.float64)
    wave_nom = doppler_corrected_wave(wave_np, v_doppler_nominal, ispace)
    nfil = np.asarray(nfil).astype(np.int64)
    vfil, afil = np.asarray(vfil), np.asarray(afil)
    nconv = nfil.shape[0]
    first = np.empty(nconv, dtype=np.int64)
    count = np.empty(nconv, dtype=np.int64)
    for j in range(nconv):
        sel = np.where((wave_nom >= vfil[0, j])
                       & (wave_nom <= vfil[nfil[j] - 1, j]))[0]
        first[j] = sel[0] if sel.size else 0
        count[j] = sel.size
    m = max(int(count.max()), 2)
    k = np.arange(m)
    idx = first[:, None] + np.minimum(k[None, :],
                                      np.maximum(count[:, None] - 1, 0))
    # the padded filter tables, one row per channel, +inf past each filter
    nmax = int(nfil.max())
    col = np.arange(nmax)[None, :] < nfil[:, None]
    xp = np.where(col, vfil[:nmax].T, np.inf)
    fp = np.where(col, afil[:nmax].T, 0.0)

    dev = dict(device=spec.device)
    dt = dict(dtype=spec.dtype, **dev)
    idx_t = torch.as_tensor(idx, **dev)
    pair = torch.as_tensor(k[None, 1:] < count[:, None], **dev)
    wavecorr = doppler_corrected_wave(torch.as_tensor(wave_np, **dt),
                                      v_doppler, ispace)
    xs = wavecorr[idx_t]
    af = _interp_rows(xs, torch.as_tensor(xp, **dt), torch.as_tensor(fp, **dt),
                      torch.as_tensor(nfil, **dev))
    y = af * spec[idx_t]
    seg = (xs[:, 1:] - xs[:, :-1]) * (y[:, 1:] + y[:, :-1])
    return 0.5 * torch.sum(torch.where(pair, seg, 0.0), dim=1)
