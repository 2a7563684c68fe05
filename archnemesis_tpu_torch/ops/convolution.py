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

All weight matrices are built host-side in numpy (static grids) and applied
as a single (NCONV, NWAVE) @ (NWAVE, ...) contraction on tensors. The
differentiable double-Gaussian ILS (models 228-230) and the filter
integration with a retrieved Doppler shift (model 447) come with their
models.
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
    """Differentiable double-Gaussian ILS weights of models 228/229/230."""
    raise NotImplementedError(
        "the double-Gaussian ILS comes with models 228-230 "
        "(ROADMAP Queue 1 item 12)")


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


def integrate_filter_apply(wave, spec, nfil, vfil, afil,
                           v_doppler=0.0, ispace=0, v_doppler_nominal=None):
    """IFORM=Integrated_radiance integration with a retrieved Doppler
    velocity (model 447)."""
    raise NotImplementedError(
        "filter integration with a retrieved Doppler shift comes with "
        "model 447 (ROADMAP Queue 1 item 12)")
