"""Diagnostic plotting for atmospheres, spectra and retrievals.

Port of the JAX package's ``plotting.py``: the same figures, colours and
styling. The reference attaches ``plot_*`` methods to most component
classes (Atmosphere_0.plot_Atm:1703, Measurement_0.plot_SO /
plot_ils:2880, OptimalEstimation_0.plot_bestfit:1119, NestedSampling
make_plots:107). Here they are free functions over the port's atmosphere,
geometry, set-up and result objects, whose fields may be numpy arrays or
tensors on any device, with or without grad: every input reaches numpy
through one host helper (``_host``). matplotlib is imported only inside
``_plt()``, so importing this module does not import it (the card's machine
has no matplotlib).

Conventions: one y-scale per axes (measures of different scale get their
own panel), a fixed colorblind-validated categorical order (never cycled
mid-figure), viridis for magnitude fields, recessive grids, legends
whenever two or more series share an axes.
"""

from __future__ import annotations

import numpy as np
import torch

# categorical series colors in fixed assignment order (colorblind-validated
# 8-slot order: blue, orange, aqua, yellow, magenta, green, violet, red)
SERIES_COLORS = (
    "#2a78d6", "#eb6834", "#1baf7a", "#eda100",
    "#e87ba4", "#008300", "#4a3aa7", "#e34948",
)
_GRID = dict(color="#898781", alpha=0.25, linewidth=0.6)


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array: a tensor is detached and copied to the
    CPU (``np.asarray`` raises on a CUDA tensor and on one that requires
    grad)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _plt():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg", "module://ipympl"):
        try:
            import matplotlib.pyplot as plt  # noqa: F401
        except Exception:
            matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax, xlabel=None, ylabel=None):
    ax.grid(True, **_GRID)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)


def plot_atmosphere(atm, gas_names=None, fig=None):
    """T(P), VMR(P) and aerosol profiles, pressure decreasing upward
    (reference plot_Atm, Atmosphere_0.py:1703)."""
    plt = _plt()
    ndust = atm.dust.shape[1] if _host(atm.dust).ndim == 2 else 0
    ncols = 2 + (1 if ndust else 0)
    if fig is None:
        fig, axs = plt.subplots(1, ncols, figsize=(4 * ncols, 5),
                                sharey=True)
    else:
        axs = fig.subplots(1, ncols, sharey=True)
    axs = np.atleast_1d(axs)
    p_atm = _host(atm.p) / 101325.0

    ax = axs[0]
    ax.plot(_host(atm.t), p_atm, color=SERIES_COLORS[0], lw=2)
    ax.set_yscale("log")
    ax.invert_yaxis()
    _style(ax, "Temperature (K)", "Pressure (atm)")

    ax = axs[1]
    vmr = _host(atm.vmr)
    for j in range(vmr.shape[1]):
        name = (gas_names[j] if gas_names is not None
                else f"gas {atm.gas_id[j]}.{atm.iso_id[j]}")
        ax.plot(vmr[:, j], p_atm,
                color=SERIES_COLORS[j % len(SERIES_COLORS)], lw=2,
                label=name)
    ax.set_xscale("log")
    if vmr.shape[1] >= 2:
        ax.legend(fontsize=8, frameon=False)
    _style(ax, "Volume mixing ratio")

    if ndust:
        ax = axs[2]
        dust = _host(atm.dust)
        for j in range(ndust):
            ax.plot(dust[:, j], p_atm,
                    color=SERIES_COLORS[j % len(SERIES_COLORS)], lw=2,
                    label=f"aerosol {j + 1}")
        if ndust >= 2:
            ax.legend(fontsize=8, frameon=False)
        _style(ax, "Aerosol density")
    fig.tight_layout()
    return fig


def plot_spectrum(geom, igeom=0, fig=None):
    """One geometry's measured spectrum with its uncertainty band
    (reference Measurement_0.plot_spec)."""
    plt = _plt()
    if fig is None:
        fig, ax = plt.subplots(figsize=(8, 4))
    else:
        ax = fig.subplots()
    nc = int(_host(geom.nconv)[igeom])
    v = _host(geom.vconv)[:nc, igeom]
    y = _host(geom.meas)[:nc, igeom]
    e = _host(geom.errmeas)[:nc, igeom]
    ax.fill_between(v, y - e, y + e, color=SERIES_COLORS[0], alpha=0.25,
                    linewidth=0)
    ax.plot(v, y, color=SERIES_COLORS[0], lw=2)
    _style(ax, "Wavenumber / wavelength", "Radiance")
    fig.tight_layout()
    return fig


def plot_bestfit(setup, res, fig=None):
    """Measured vs modelled spectrum with a residual panel (reference
    OptimalEstimation_0.plot_bestfit:1119). One y-scale per panel."""
    plt = _plt()
    if fig is None:
        fig, (ax, axr) = plt.subplots(
            2, 1, figsize=(8, 6), sharex=True,
            gridspec_kw={"height_ratios": [3, 1]},
        )
    else:
        ax, axr = fig.subplots(2, 1, sharex=True)
    x = np.concatenate([_host(v) for v in setup.vconv_list])
    y = _host(setup.y)
    yn = _host(res.yn)
    err = np.sqrt(np.diag(_host(setup.se)))
    order = np.argsort(x)
    x, y, yn, err = x[order], y[order], yn[order], err[order]

    ax.fill_between(x, y - err, y + err, color=SERIES_COLORS[0], alpha=0.25,
                    linewidth=0)
    ax.plot(x, y, color=SERIES_COLORS[0], lw=2, label="measured")
    ax.plot(x, yn, color=SERIES_COLORS[1], lw=2, label="modelled")
    ax.legend(frameon=False, fontsize=9)
    _style(ax, ylabel="Radiance")

    axr.axhline(0.0, color="#898781", lw=0.8)
    axr.plot(x, (yn - y) / np.where(err > 0, err, 1.0),
             color=SERIES_COLORS[1], lw=1.5)
    _style(axr, "Wavenumber / wavelength", r"residual / $\sigma$")
    fig.tight_layout()
    return fig


def plot_averaging_kernel(res, fig=None):
    """Averaging-kernel matrix (viridis heatmap) and its row sums — the
    measure of information content per state-vector element."""
    plt = _plt()
    if fig is None:
        fig, (ax, ax2) = plt.subplots(1, 2, figsize=(9, 4))
    else:
        ax, ax2 = fig.subplots(1, 2)
    aa = _host(res.aa)
    im = ax.imshow(aa, cmap="viridis", aspect="auto", origin="lower")
    fig.colorbar(im, ax=ax, label="AA")
    _style(ax, "state index", "state index")
    ax.grid(False)

    ax2.plot(aa.sum(axis=1), color=SERIES_COLORS[0], lw=2)
    _style(ax2, "state index", "row sum (d.o.f.)")
    fig.tight_layout()
    return fig


def plot_phi_history(res, fig=None):
    """Cost-function trajectory over OE iterations (reference writes
    phi_chisq.txt, OptimalEstimation_0.py:1361)."""
    plt = _plt()
    if fig is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    else:
        ax = fig.subplots()
    ax.plot(_host(res.phi_history), marker="o", ms=4,
            color=SERIES_COLORS[0], lw=2)
    ax.set_yscale("log")
    _style(ax, "iteration", r"$\varphi$")
    fig.tight_layout()
    return fig


def plot_ils(wave, weights, vconv, channels=(0, None, -1), fig=None):
    """Instrument-lineshape rows of a (NCONV, NWAVE) weight matrix at a few
    channels (reference Measurement_0.plot_ils:2880)."""
    plt = _plt()
    if fig is None:
        fig, ax = plt.subplots(figsize=(7, 4))
    else:
        ax = fig.subplots()
    w = _host(weights)
    vconv = _host(vconv)
    nconv = w.shape[0]
    idx = [c if c is not None else nconv // 2 for c in channels]
    idx = sorted({(c if c >= 0 else nconv + c) for c in idx})
    for k, ic in enumerate(idx):
        ax.plot(_host(wave) - vconv[ic], w[ic],
                color=SERIES_COLORS[k % len(SERIES_COLORS)], lw=2,
                label=f"channel at {vconv[ic]:.2f}")
    if len(idx) >= 2:
        ax.legend(frameon=False, fontsize=9)
    _style(ax, "offset from channel centre", "ILS weight")
    fig.tight_layout()
    return fig


def plot_corner(samples, names=None, weights=None, bins=25, fig=None):
    """Corner plot of nested-sampling posterior samples (the reference
    shells out to the ``corner`` package, NestedSampling_0.make_plots:107;
    this is a dependency-free equivalent): histograms on the diagonal,
    2-D density (viridis) below."""
    plt = _plt()
    s = _host(samples)
    weights = None if weights is None else _host(weights)
    ndim = s.shape[1]
    if fig is None:
        fig, axs = plt.subplots(ndim, ndim,
                                figsize=(2.2 * ndim, 2.2 * ndim))
    else:
        axs = fig.subplots(ndim, ndim)
    axs = np.atleast_2d(axs)
    for i in range(ndim):
        for j in range(ndim):
            ax = axs[i, j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(s[:, i], bins=bins, weights=weights,
                        color=SERIES_COLORS[0], alpha=0.85)
            else:
                h, xe, ye = np.histogram2d(s[:, j], s[:, i], bins=bins,
                                           weights=weights)
                ax.pcolormesh(xe, ye, h.T, cmap="viridis", rasterized=True)
            ax.tick_params(labelsize=6)
            if names is not None:
                if i == ndim - 1:
                    ax.set_xlabel(names[j], fontsize=8)
                if j == 0 and i > 0:
                    ax.set_ylabel(names[i], fontsize=8)
    fig.tight_layout()
    return fig
