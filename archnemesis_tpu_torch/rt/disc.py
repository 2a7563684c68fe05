"""Disc-averaging quadrature for unresolved (exoplanet) observations.

Port of the JAX package's ``rt/disc.py`` (numpy only, copied so that the
port imports nothing of the JAX package). Host-side static geometry
construction mirroring the reference
``Measurement_0.calc_avepoints_exoplanet`` (Measurement_0.py:1680, after
Irwin et al. 2020 / nemesispy): Gauss-Lobatto rings in emission zenith,
trapezium sampling in azimuth with extra points pinned at the day/night
terminator, and per-point (lat, lon, solar zenith, emission zenith, azimuth,
weight) assuming a tidally-locked planet on an edge-on orbit.

The output feeds the disc forward model (``forward.forward_disc``): the
quadrature is static per phase, so the rays run as batches of nadir paths
over one set of layer optical depths.
"""

from __future__ import annotations

import numpy as np

DTR = np.pi / 180.0


def gauss_lobatto(n: int):
    """Gauss-Lobatto nodes/weights on [-1, 1] (reference
    Scatter_0.gauss_lobatto:2241)."""
    from numpy.polynomial.legendre import Legendre

    if n < 2:
        raise ValueError("Gauss-Lobatto requires n >= 2")
    p = Legendre.basis(n - 1)
    xi = p.deriv().roots()
    wi = 2.0 / (n * (n - 1) * p(xi) ** 2)
    x = np.concatenate(([-1.0], xi, [1.0]))
    w = np.concatenate(([2.0 / (n * (n - 1))], wi, [2.0 / (n * (n - 1))]))
    order = np.argsort(x)
    return x[order], w[order]


def _arg2pi(x, y):
    """Argument of (x, y) in [0, 2pi) (reference Measurement_0.arctan:4365)."""
    a = np.arctan2(y, x)
    return a % (2.0 * np.pi)


def _rot_z(v, phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([c * v[0] - s * v[1], s * v[0] + c * v[1], v[2]])


def _rot_y(v, phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]])


def point_angles_exoplanet(phase: float, rho: float, alpha: float):
    """(solar zenith [rad], azimuth [rad], lat [deg], lon [deg]) of a disc
    point at fractional radius rho, argument alpha (deg, anticlockwise from
    3 o'clock), for orbital phase deg (0 = primary transit). Reference
    generate_angles_exoplanet (Measurement_0.py:4461)."""
    phase = phase % 360.0
    phi_star = (90.0 + phase) * DTR
    v_star = np.array([np.cos(phi_star), np.sin(phi_star), 0.0])

    theta_p = np.arccos(rho * np.sin(alpha * DTR))
    if np.sin(theta_p) != 0.0:
        cos_phi = rho * np.cos(alpha * DTR) / abs(np.sin(theta_p))
        phi_p = (-np.arccos(np.clip(cos_phi, -1.0, 1.0))) % (2.0 * np.pi)
    else:
        phi_p = 0.0
    v_point = np.array([
        np.sin(theta_p) * np.cos(phi_p),
        np.sin(theta_p) * np.sin(phi_p),
        np.cos(theta_p),
    ])

    zen = np.around(np.arccos(np.clip(np.dot(v_star, v_point), -1, 1)), 10)
    lat = np.around(90.0 - theta_p / DTR, 10)
    lon = (phi_p / DTR - (phi_star / DTR + 180.0)) % 360.0

    v_obs = np.array([0.0, -1.0, 0.0])
    v_star_loc = _rot_y(_rot_z(v_star, -phi_p), -theta_p)
    v_obs_loc = _rot_y(_rot_z(v_obs, -phi_p), -theta_p)
    azi = abs(_arg2pi(v_obs_loc[0], v_obs_loc[1])
              - _arg2pi(v_star_loc[0], v_star_loc[1]))
    if azi > np.pi:
        azi = 2.0 * np.pi - azi
    azi = np.pi - azi  # convention: azi = 0 is forward scattering
    return zen, azi, lat, lon


def disc_quadrature(nmu: int = 5, phase: float = 0.0):
    """Averaging points for a disc-averaged spectrum.

    Returns dict of (NAV,) arrays: flat, flon, sol_ang, emiss_ang, azi_ang
    (deg) and normalised weights wgeom. Reference calc_avepoints_exoplanet
    (Measurement_0.py:1680-1840).
    """
    if nmu < 2:
        raise ValueError("need at least 2 quadrature rings")
    phase = phase % 360.0
    del_r = 1.0 / nmu

    mu_all, wt_all = gauss_lobatto(2 * nmu)
    mu, wtmu = mu_all[nmu:], wt_all[nmu:]

    # day/night terminator in disc coordinates
    z_term = np.linspace(-1.0, 1.0, 201)
    theta_term = (
        2.0 * np.pi - np.arccos(z_term)
        if 0.0 <= phase <= 180.0
        else np.arccos(z_term)
    )
    x_term = np.sin(theta_term) * np.around(np.cos(phase * DTR), 14)
    r_term = np.hypot(x_term, z_term)
    rmin = r_term.min()

    rows = []
    for imu in range(nmu):
        r_quad = np.sqrt(1.0 - mu[imu] ** 2)
        half_circ = np.pi * r_quad

        if r_quad > rmin:  # ring crosses the terminator: pin a sample there
            keep = np.where(r_term <= r_quad)[0]
            xi, zi = x_term[[keep[0], keep[-1]]], z_term[[keep[0], keep[-1]]]
            k = 1 if zi[1] > 0 else 0
            alpha_x = _arg2pi(xi[k], zi[k]) / DTR
            n1 = max(int(0.5 + half_circ * (alpha_x / 180.0) / del_r), 2)
            n2 = max(int(0.5 + half_circ * ((180.0 - alpha_x) / 180.0) / del_r), 2)
            a1 = alpha_x / (n1 - 1) * np.arange(n1)
            a2 = alpha_x + (180.0 - alpha_x) / (n2 - 1) * np.arange(n2)
            alphas = np.concatenate([a1, a2[1:]])
        elif half_circ > 0.0:
            nalpha = int(0.5 + half_circ / del_r)
            alphas = (
                180.0 * np.arange(nalpha) / (nalpha - 1)
                if nalpha > 1
                else np.zeros(1)
            )
        else:
            alphas = np.zeros(1)

        nalpha = alphas.size
        for ia, alpha in enumerate(alphas):
            zen, azi, lat, lon = point_angles_exoplanet(phase, r_quad, alpha)
            if nalpha > 1:
                if ia == 0:
                    wt_trap = (alphas[1] - alphas[0]) / 2.0
                elif ia == nalpha - 1:
                    wt_trap = (alphas[-1] - alphas[-2]) / 2.0
                else:
                    wt_trap = (alphas[ia + 1] - alphas[ia - 1]) / 2.0
                wt = 2.0 * mu[imu] * wtmu[imu] * wt_trap / 180.0
            else:
                azi = np.pi  # single on-axis point: azimuth arbitrary
                wt = 2.0 * mu[imu] * wtmu[imu]
            rows.append((lat, lon % 360.0, zen / DTR,
                         np.arccos(mu[imu]) / DTR, azi / DTR, wt))

    arr = np.asarray(rows)
    arr[:, 5] /= arr[:, 5].sum()
    return {
        "flat": arr[:, 0], "flon": arr[:, 1], "sol_ang": arr[:, 2],
        "emiss_ang": arr[:, 3], "azi_ang": arr[:, 4], "wgeom": arr[:, 5],
    }
