"""Retrieval output writers and readers: legacy .mre / .cov / .raw / .itr
formats.

Port of the JAX package's ``retrieval/output.py`` (host code on the numpy
arrays of the set-up and the result). Formats re-implemented from
observation of the reference writers (OptimalEstimation_0.py:
write_mre:722, write_cov:873, write_raw:1043, the .itr records
:1388-1396). The .raw layout is compatible with the reference's read_pre,
enabling LIN retrieval chaining in either direction. The HDF5 dump comes
with ``io/hdf5.py``.
"""

from __future__ import annotations

import numpy as np

from archnemesis_tpu_torch.enums import SpectraUnit, WaveUnit


def _varparam(entry):
    out = np.zeros(5)
    for i, v in enumerate(entry.extra[:5]):
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def _mre_units(ispace, iform):
    if WaveUnit(ispace) == WaveUnit.Wavenumber_cm:
        table = {
            SpectraUnit.Radiance: ("Radiances expressed as nW cm-2 sr-1 (cm-1)-1", 1.0e9),
            SpectraUnit.FluxRatio: ("F_plan/F_star Ratio of planet", 1.0),
            SpectraUnit.TransitDepth: ("Transit depth: 100*Planet_area/Stellar_area", 1.0),
            SpectraUnit.Integrated_spectral_power: ("Spectral Radiation of planet: W (cm-1)-1", 1.0e18),
            SpectraUnit.Atmospheric_transmission: ("Solar flux: W cm-2 (cm-1)-1", 1.0),
            SpectraUnit.Normalised_radiance: ("Transmission", 1.0),
        }
    else:
        table = {
            SpectraUnit.Radiance: ("Radiances expressed as uW cm-2 sr-1 um-1", 1.0e6),
            SpectraUnit.FluxRatio: ("F_plan/F_star Ratio of planet", 1.0),
            SpectraUnit.TransitDepth: ("Transit depth: 100*Planet_area/Stellar_area", 1.0),
            SpectraUnit.Integrated_spectral_power: ("Spectral Radiation of planet: W um-1", 1.0e18),
            SpectraUnit.Atmospheric_transmission: ("Solar flux: W cm-2 um-1", 1.0),
            SpectraUnit.Normalised_radiance: ("Transmission", 1.0),
        }
    return table.get(SpectraUnit(iform), table[SpectraUnit.Radiance])


def write_mre(path, setup, res):
    """Write the .mre retrieval summary (reference write_mre
    OptimalEstimation_0.py:722)."""
    sv = setup.sv
    geom = setup.deck.geometry
    st = setup.deck.settings
    str4, xfac = _mre_units(st.ispace, st.iform)
    ny = setup.y.shape[0]

    with open(path, "w") as f:
        f.write("\t1\t! Total number of retrievals\n")
        f.write(
            "\t %i %i %i %i %i \t %s \n"
            % (0, geom.ngeom, ny, sv.nx, ny, "! ispec,ngeom,ny,nx,ny")
        )
        f.write(
            "\t %5.7f \t %5.7f \t %s \n"
            % (geom.latitude, geom.longitude, "Latitude, Longitude")
        )
        f.write(str4 + "\n")
        f.write("\t i lambda R_meas error %err R_fit %Diff \n")
        ioff = 0
        se_diag = np.diag(setup.se)
        for ig in range(geom.ngeom):
            for ic in range(geom.nconv[ig]):
                i = ioff + ic
                err1 = np.sqrt(se_diag[i])
                y = setup.y[i]
                xerr1 = abs(100.0 * err1 / y) if y != 0 else -1.0
                relerr = abs(100.0 * (y - res.yn[i]) / y) if y != 0 else 0.0
                f.write(
                    "\t %4i %14.8f %15.8e %15.8e %7.2f %15.8e %9.5f \n"
                    % (i + 1, geom.vconv[ic, ig], y * xfac, err1 * xfac,
                       xerr1, res.yn[i] * xfac, relerr)
                )
            ioff += geom.nconv[ig]

        f.write("\n")
        f.write(f"nvar=    {len(sv.entries)}\n")
        for iv, e in enumerate(sv.entries):
            f.write(f"Variable {iv + 1}\n")
            f.write("\t %i \t %i \t %i\n" % e.varident)
            vp = _varparam(e)
            f.write(
                "%10.8e \t %10.8e \t %10.8e \t %10.8e \t %10.8e\n"
                % tuple(vp)
            )
            f.write("\t i ix xa sa_err xn xn_err\n")
            for ip in range(e.nx):
                ix = e.ix + ip
                xa1 = sv.xa[ix]
                ea1 = np.sqrt(abs(sv.sa[ix, ix]))
                xn1 = res.xn[ix]
                en1 = np.sqrt(abs(res.st[ix, ix]))
                if sv.lx[ix] == 1:
                    xa1 = np.exp(xa1)
                    ea1 = xa1 * ea1
                    xn1 = np.exp(xn1)
                    en1 = xn1 * en1
                f.write(
                    "\t %4i %4i %12.5e %12.5e %12.5e %12.5e \n"
                    % (ip + 1, ix + 1, xa1, ea1, xn1, en1)
                )


def write_cov(path, setup, res):
    """Write the .cov matrices file (reference write_cov
    OptimalEstimation_0.py:873)."""
    sv = setup.sv
    nx = sv.nx
    ny = setup.y.shape[0]
    with open(path, "w") as f:
        f.write("%i %i\n" % (1, len(sv.entries)))
        for e in sv.entries:
            f.write("%i \t %i \t %i\n" % e.varident)
            f.write(
                "%10.8e \t %10.8e \t %10.8e \t %10.8e \t %10.8e\n"
                % tuple(_varparam(e))
            )
        f.write("%i %i\n" % (nx, ny))
        sm, sn, st, sa = res.sm, res.sn, res.st, sv.sa
        for i in range(nx):
            for m in (sa, sm, sn, st):
                for j in range(nx):
                    f.write("%10.8e\n" % m[i, j])
        for i in range(nx):
            for j in range(nx):
                f.write("%10.8e\n" % res.aa[i, j])
        for i in range(nx):
            for j in range(ny):
                f.write("%10.8e\n" % res.dd[i, j])
        for i in range(ny):
            for j in range(nx):
                f.write("%10.8e\n" % res.kk[i, j])
        se_diag = np.diag(setup.se)
        for i in range(ny):
            f.write("%10.8e\n" % se_diag[i])


def write_raw(path, setup, res, atm):
    """Write the .raw fitted-state file (reference write_raw
    OptimalEstimation_0.py:1043) — rename to .pre for LIN chaining."""
    sv = setup.sv
    with open(path, "w") as f:
        f.write("1\t! Total number of retrievals\n")
        f.write("0 \t ! ispec \n")
        f.write(
            "%5.7f \t %5.7f \t ! Latitude, Longitude \n"
            % (float(atm.latitude), 0.0)
        )
        f.write(
            "%i \t %i \t %i \t %i \t %i \t ! npro,ngas,ndust,nlocations,nvar \n"
            % (atm.np_, atm.nvmr, atm.ndust, 1, len(sv.entries))
        )
        for iv, e in enumerate(sv.entries):
            f.write(f"{iv + 1}   ! ivar \n")
            f.write("%i \t %i \t %i\n" % e.varident)
            f.write(
                "%10.8e \t %10.8e \t %10.8e \t %10.8e \t %10.8e\n"
                % tuple(_varparam(e))
            )
        f.write("%i \t ! nx \n" % sv.nx)
        for i in range(sv.nx):
            f.write(
                "%10.8e \t %i \t %i \n"
                % (res.xn[i], sv.lx[i], sv.inum[i])
            )
        for i in range(sv.nx):
            for j in range(sv.nx):
                f.write("%10.8e\n" % res.st[i, j])


def read_raw(path):
    """Read a .raw/.pre file back (counterpart of the reference read_pre
    Files.py:1623). Returns dict with varidents, per-entry nx unknown (the
    flat state is returned with lx/num flags and the ST covariance)."""
    varidents = []
    varparams = []
    with open(path) as f:
        lines = f.readlines()
    # header: 4 lines, then nvar blocks of 3 lines each
    hdr = lines[3].split()
    npro, ngas, ndust = int(hdr[0]), int(hdr[1]), int(hdr[2])
    nvar = int(hdr[4])
    li = 4
    for _ in range(nvar):
        varidents.append(tuple(int(v) for v in lines[li + 1].split()[:3]))
        varparams.append([float(v) for v in lines[li + 2].split()[:5]])
        li += 3
    nx = int(lines[li].split()[0])
    li += 1
    xn = np.zeros(nx)
    lx = np.zeros(nx, dtype=int)
    num = np.zeros(nx, dtype=int)
    for i in range(nx):
        t = lines[li + i].split()
        xn[i], lx[i], num[i] = float(t[0]), int(t[1]), int(t[2])
    li += nx
    st = np.zeros((nx, nx))
    flat = [float(lines[li + k].split()[0]) for k in range(nx * nx)]
    st[:, :] = np.asarray(flat).reshape(nx, nx)
    return dict(varidents=varidents, varparams=np.asarray(varparams),
                xn=xn, lx=lx, num=num, st=st, nx=nx,
                npro=npro, ngas=ngas, ndust=ndust)


def read_itr(path):
    """Read a .itr iteration log back and return the LAST record (reference
    OptimalEstimation_0.from_itr:55, which also selects the final record).
    Used to resume an interrupted retrieval from its checkpoint.

    Record layout mirrors write_itr: chisq/phi line, then XN1, XA, Y,
    SE diag, YN1, YN (NX/NY-sized columns) and KK column-major.
    """
    with open(path) as f:
        lines = f.read().split("\n")
    nx, ny, niter = (int(v) for v in lines[0].split())
    lines_per_record = 1 + 2 * nx + 4 * ny + nx * ny
    n_records = (len([ln for ln in lines if ln.strip()]) - 1) // lines_per_record
    li = 1 + (n_records - 1) * lines_per_record
    chisq, phi = (float(v) for v in lines[li].split())
    li += 1

    def col(n):
        nonlocal li
        v = np.array([float(lines[li + k]) for k in range(n)])
        li += n
        return v

    xn1 = col(nx)
    xa = col(nx)
    y = col(ny)
    se_diag = col(ny)
    yn1 = col(ny)
    yn = col(ny)
    kk = np.zeros((ny, nx))
    for i in range(nx):
        for j in range(ny):
            kk[j, i] = float(lines[li])
            li += 1
    return dict(
        nx=nx, ny=ny, niter=niter, n_records=n_records, chisq=chisq,
        phi=phi, xn1=xn1, xa=xa, y=y, se_diag=se_diag, yn1=yn1, yn=yn, kk=kk,
    )


def write_itr(path, setup, records):
    """Write the .itr iteration log (reference coreretOE
    OptimalEstimation_0.py:1310-1396): header NX NY NITER then per-record
    chisq/phi, XN1, XA, Y, SE diag, YN1, YN, KK (column-major)."""
    sv = setup.sv
    ny = setup.y.shape[0]
    se_diag = np.diag(setup.se)
    with open(path, "w") as f:
        f.write("\t %i \t %i \t %i\n" % (sv.nx, ny, len(records)))
        for rec in records:
            f.write(f'{rec["chisq"]:09.4E} {rec["phi"]:09.4E}\n')
            for v in rec["xn1"]:
                f.write(f"{v:09.4E}\n")
            for v in sv.xa:
                f.write(f"{v:09.4E}\n")
            for v in setup.y:
                f.write(f"{v:09.4E}\n")
            for v in se_diag:
                f.write(f"{v:09.4E}\n")
            for v in rec["yn1"]:
                f.write(f"{v:09.4E}\n")
            for v in rec["yn"]:
                f.write(f"{v:09.4E}\n")
            kk = rec["kk"]
            for i in range(sv.nx):
                for j in range(ny):
                    f.write(f"{kk[j, i]:09.4E}\n")


def read_mre(path):
    """Read back a .mre summary (reference Files.read_mre:594): the fitted
    spectrum block plus the per-variable retrieved parameters."""
    with open(path) as f:
        f.readline()
        t = f.readline().split()
        ispec, ngeom, ny, nx = int(t[0]), int(t[1]), int(t[2]), int(t[3])
        t = f.readline().split()
        lat, lon = float(t[0]), float(t[1])
        f.readline()  # units line
        f.readline()  # column header
        spec = np.array(
            [[float(x) for x in f.readline().split()] for _ in range(ny)]
        )
        # blank line then "nvar=    N"
        line = f.readline()
        while line.strip() == "":
            line = f.readline()
        nvar = int(line.split("=")[1])
        varident, varparam = [], []
        xa = np.zeros(nx)
        sa_err = np.zeros(nx)
        xn = np.zeros(nx)
        xn_err = np.zeros(nx)
        for _ in range(nvar):
            f.readline()  # "Variable N"
            varident.append([int(x) for x in f.readline().split()])
            varparam.append([float(x) for x in f.readline().split()])
            f.readline()  # column header
            while True:
                pos = f.tell()
                line = f.readline()
                t = line.split()
                if not t or not t[0].lstrip("-").isdigit():
                    f.seek(pos)
                    break
                ix = int(t[1]) - 1
                xa[ix], sa_err[ix], xn[ix], xn_err[ix] = (
                    float(t[2]), float(t[3]), float(t[4]), float(t[5])
                )
    return dict(
        ispec=ispec, ngeom=ngeom, ny=ny, nx=nx, lat=lat, lon=lon,
        vconv=spec[:, 1], y=spec[:, 2], yerr=spec[:, 3], yn=spec[:, 5],
        nvar=nvar, varident=np.asarray(varident),
        varparam=np.asarray(varparam),
        xa=xa, sa_err=sa_err, xn=xn, xn_err=xn_err,
    )


def read_cov(path):
    """Read back a .cov matrices file (reference Files.read_cov:760)."""
    with open(path) as f:
        t = f.readline().split()
        nvar = int(t[1])
        varident, varparam = [], []
        for _ in range(nvar):
            varident.append([int(x) for x in f.readline().split()])
            varparam.append([float(x) for x in f.readline().split()])
        t = f.readline().split()
        nx, ny = int(t[0]), int(t[1])

        def block(n):
            return np.array([float(f.readline()) for _ in range(n)])

        sa = np.zeros((nx, nx))
        sm = np.zeros((nx, nx))
        sn = np.zeros((nx, nx))
        st = np.zeros((nx, nx))
        for i in range(nx):
            sa[i] = block(nx)
            sm[i] = block(nx)
            sn[i] = block(nx)
            st[i] = block(nx)
        aa = np.array([block(nx) for _ in range(nx)])
        dd = np.array([block(ny) for _ in range(nx)])
        kk = np.array([block(nx) for _ in range(ny)])
        se = block(ny)
    return dict(
        nvar=nvar, varident=np.asarray(varident),
        varparam=np.asarray(varparam), nx=nx, ny=ny,
        sa=sa, sm=sm, sn=sn, st=st, aa=aa, dd=dd, kk=kk, se=se,
    )
