"""Single-point channel statistics.

Port of out1d_single_point_chan (reference output.f90:509-689,
first block): 27 plane-averaged quantities per z level —
  1-3   <u>, <v>, <w>
  4-6   <u^2>, <v^2>, <w^2>
  7     <u w> at cell edges
  8-13  <u^3>, <v^3>, <w^3>, <u^4>, <v^4>, <w^4>
  14-15 <p>, <p^2>
  16-21 <omega_x>, <omega_y>, <omega_z>, <omega_x^2>, <omega_y^2>, <omega_z^2>
  22-25 modelled (subgrid) stresses -2<nu_t S11>, -2<nu_t S22>, -2<nu_t S33>,
        -<nu_t (du/dz + dw/dx)> at edges
  26    <nu_t>
  27    <du/dz> (viscous shear-stress contribution, edges)

Written as fname.out (ascii: zc zf 27 columns dzc dzf) and fname.bin (raw),
matching the reference formats (output.f90:690-700).
"""
from __future__ import annotations

import numpy as np


def single_point_chan(fname, cfg, grid, u, v, w, p, visct, padded=None,
                      reduce=None, write=True):
    """u, v, w, p, visct: interior (nz, ny, nx) numpy arrays.  padded:
    the (up, vp, wp, ppad, sppad) ghost-filled arrays of
    Simulation.padded_state (the solver's BC semantics), required.  On a
    y-slab mesh the arrays are this rank's slabs, reduce maps the slab's
    plane means to the domain's (the mean over the ranks) and write is
    rank 0's."""
    u, v, w, p, visct = map(np.asarray, (u, v, w, p, visct))
    nz, ny, nx = u.shape
    dl = cfg.dl
    dzc = grid.dzc
    dzf = grid.dzf
    zc = grid.zc
    zf = grid.zf

    if padded is None:
        raise ValueError('single_point_chan: pass padded= '
                         '(Simulation.padded_state)')
    up, vp, wp, pp, sp = map(np.asarray, padded)
    C = lambda f, k=0, j=0, i=0: f[1 + k:1 + k + nz, 1 + j:1 + j + ny,
                                   1 + i:1 + i + nx]

    dzc_k = dzc[1:nz + 1][:, None, None]
    dzf_k = dzf[1:nz + 1][:, None, None]
    dzf_kp = dzf[2:nz + 2][:, None, None]

    mean = lambda f: f.mean(axis=(1, 2))
    out = np.zeros((27, nz))
    out[0] = mean(u)
    out[1] = mean(v)
    out[2] = mean(w)
    out[3] = mean(u ** 2)
    out[4] = mean(v ** 2)
    out[5] = mean(w ** 2)
    out[6] = mean(0.25 * (C(up, k=1) + C(up)) * (C(wp) + C(wp, i=1)))
    out[7] = mean(u ** 3)
    out[8] = mean(v ** 3)
    out[9] = mean(w ** 3)
    out[10] = mean(u ** 4)
    out[11] = mean(v ** 4)
    out[12] = mean(w ** 4)
    out[13] = mean(p)
    out[14] = mean(p ** 2)
    # vorticity components at edges (output.f90:612-618)
    om_x = (C(wp, j=1) - C(wp)) / dl[1] - (C(vp, k=1) - C(vp)) / dzc_k
    om_y = (C(up, k=1) - C(up)) / dzc_k - (C(wp, i=1) - C(wp)) / dl[0]
    om_z = (C(vp, i=1) - C(vp)) / dl[0] - (C(up, j=1) - C(up)) / dl[1]
    out[15] = mean(om_x)
    out[16] = mean(om_y)
    out[17] = mean(om_z)
    out[18] = mean(om_x ** 2)
    out[19] = mean(om_y ** 2)
    out[20] = mean(om_z ** 2)
    # modelled stress (output.f90:630-652)
    dudx_ip = (C(up, i=1) - C(up)) / dl[0]
    dudx_im = (C(up) - C(up, i=-1)) / dl[0]
    dvdy_jp = (C(vp, j=1) - C(vp)) / dl[1]
    dvdy_jm = (C(vp) - C(vp, j=-1)) / dl[1]
    dwdz_kp = (C(wp, k=1) - C(wp)) / dzf_kp
    dwdz_km = (C(wp) - C(wp, k=-1)) / dzf_k
    dudz = (C(up, k=1) - C(up)) / dzc_k
    dwdx = (C(wp, i=1) - C(wp)) / dl[0]
    s_ccc, s_pcc = C(sp), C(sp, i=1)
    s_cpc, s_ccp, s_pcp = C(sp, j=1), C(sp, k=1), C(sp, k=1, i=1)
    out[21] = mean(-0.5 * (s_pcc * 2 * dudx_ip + s_ccc * 2 * dudx_im))
    out[22] = mean(-0.5 * (s_cpc * 2 * dvdy_jp + s_ccc * 2 * dvdy_jm))
    out[23] = mean(-0.5 * (s_ccp * 2 * dwdz_kp + s_ccc * 2 * dwdz_km))
    out[24] = mean(-0.25 * (s_ccc + s_pcc + s_ccp + s_pcp) * (dudz + dwdx))
    out[25] = mean(visct)
    out[26] = mean(dudz)
    if reduce is not None:
        out = reduce(out)
    if not write:
        return out

    with open(str(fname) + '.out', 'w') as f:
        for k in range(nz):
            row = [zc[k + 1], zf[k + 1], *out[:, k], dzc[k + 1], dzf[k + 1]]
            f.write(' '.join(f'{v:24.16e}' for v in row) + '\n')
    out.astype(np.float64).T.tofile(str(fname) + '.bin')
    return out


def duct_stats_2d(fname, cfg, grid, u, v, w):
    """Streamwise(x)-averaged duct statistics on the (y, z) cross-section
    (out2d_duct, output.f90:406-507): mean velocities and second moments."""
    u, v, w = map(np.asarray, (u, v, w))
    nz, ny, nx = u.shape
    m = lambda f: f.mean(axis=2)           # (nz, ny)
    cols = {
        'um': m(u), 'vm': m(v), 'wm': m(w),
        'uu': m(u ** 2) - m(u) ** 2,
        'vv': m(v ** 2) - m(v) ** 2,
        'ww': m(w ** 2) - m(w) ** 2,
        'vw': m(v * w) - m(v) * m(w),
    }
    order = ['um', 'vm', 'wm', 'uu', 'vv', 'ww', 'vw']
    arr = np.stack([cols[k] for k in order])   # (7, nz, ny)
    arr.astype(np.float64).tofile(str(fname) + '.bin')
    yc = (np.arange(ny) + 0.5) * cfg.dl[1]
    zc = grid.zc[1:nz + 1]
    with open(str(fname) + '.out', 'w') as f:
        f.write('# y z ' + ' '.join(order) + '\n')
        for k in range(nz):
            for j in range(ny):
                row = [yc[j], zc[k]] + [arr[q, k, j] for q in range(len(order))]
                f.write(' '.join(f'{x:16.7e}' for x in row) + '\n')
    return arr


def reystr_budget_chan(fname, cfg, grid, u, v, w, p, padded=None,
                       reduce=None, write=True):
    """MKE and Reynolds-stress budget terms, 38 plane-averaged quantities per
    z level (out1d_single_point_chan second block, output.f90:703-1009):
    MKE work/transport terms, uu/vv/ww/uw transport, pressure-strain and
    dissipation contributions, plus the split dissipation components.
    Writes fname_reystr_budget.{out,bin} like the reference."""
    u, v, w, p = map(np.asarray, (u, v, w, p))
    nz, ny, nx = u.shape
    dl = cfg.dl
    dzc = grid.dzc
    dzf = grid.dzf

    if padded is None:
        raise ValueError('reystr_budget_chan: pass padded= '
                         '(Simulation.padded_state)')
    up, vp, wp, pp = map(np.asarray, padded[:4])
    C = lambda f, k=0, j=0, i=0: f[1 + k:1 + k + nz, 1 + j:1 + j + ny,
                                   1 + i:1 + i + nx]
    dzc_k = dzc[1:nz + 1][:, None, None]
    dzc_km = dzc[0:nz][:, None, None]
    dzf_k = dzf[1:nz + 1][:, None, None]
    dzf_kp = dzf[2:nz + 2][:, None, None]
    dx, dy = dl[0], dl[1]
    mean = lambda f: f.mean(axis=(1, 2))

    uc, ucp1 = C(up), C(up, k=1)
    ucm1, ukm = C(up, k=-1), C(up, i=-1)
    b = np.zeros((38, nz))
    # MKE terms (output.f90:756-773)
    b[0] = mean(uc)
    b[1] = mean(0.5 * (uc + ucp1))
    b[2] = mean((ucp1 - uc) / dzc_k)
    b[3] = mean((ucp1 ** 2 - uc ** 2) / dzc_k)
    b[4] = mean(0.25 * (ucp1 + uc) * (C(wp) + C(wp, i=1)))
    b[5] = mean(0.25 * (ukm + uc) * (C(wp) + C(wp, k=-1)))
    dudz_c = 0.25 * ((ucp1 - uc) / dzc_k + (uc - ucm1) / dzc_km
                     + (C(up, k=1, i=-1) - ukm) / dzc_k
                     + (ukm - C(up, k=-1, i=-1)) / dzc_km)
    b[6] = mean(dudz_c)
    # uu terms (output.f90:775-806)
    b[7] = mean(0.125 * (ucp1 + uc) ** 2 * (C(wp) + C(wp, i=1)))
    b[8] = mean(C(pp))
    b[9] = mean((uc - ukm) / dx * C(pp))
    b[10] = mean(((uc - ukm) / dx) ** 2
                 + 0.25 * (((C(up, j=1) - uc) / dy) ** 2
                           + ((uc - C(up, j=-1)) / dy) ** 2
                           + ((C(up, j=1, i=-1) - ukm) / dy) ** 2
                           + ((ukm - C(up, j=-1, i=-1)) / dy) ** 2)
                 + 0.25 * (((ucp1 - uc) / dzc_k) ** 2
                           + ((uc - ucm1) / dzc_km) ** 2
                           + ((C(up, k=1, i=-1) - ukm) / dzc_k) ** 2
                           + ((ukm - C(up, k=-1, i=-1)) / dzc_km) ** 2))
    # vv terms (output.f90:808-836)
    vc, vcp1, vjm = C(vp), C(vp, k=1), C(vp, j=-1)
    b[11] = mean((vcp1 ** 2 - vc ** 2) / dzc_k)
    b[12] = mean(0.125 * (vcp1 + vc) ** 2 * (C(wp) + C(wp, j=1)))
    b[13] = mean((vc - vjm) / dy * C(pp))
    b[14] = mean(0.25 * (((C(vp, i=1) - vc) / dx) ** 2
                         + ((vc - C(vp, i=-1)) / dx) ** 2
                         + ((C(vp, i=1, j=-1) - vjm) / dx) ** 2
                         + ((vjm - C(vp, i=-1, j=-1)) / dx) ** 2)
                 + ((vc - vjm) / dy) ** 2
                 + 0.25 * (((vcp1 - vc) / dzc_k) ** 2
                           + ((vc - C(vp, k=-1)) / dzc_km) ** 2
                           + ((C(vp, k=1, j=-1) - vjm) / dzc_k) ** 2
                           + ((vjm - C(vp, k=-1, j=-1)) / dzc_km) ** 2))
    # ww terms (output.f90:838-866)
    wc, wcp1, wcm1 = C(wp), C(wp, k=1), C(wp, k=-1)
    b[15] = mean(0.5 * ((wcp1 ** 2 - wc ** 2) / dzf_kp
                        + (wc ** 2 - wcm1 ** 2) / dzf_k))
    b[16] = mean(wc ** 3)
    b[17] = mean(wc * 0.5 * (C(pp, k=1) + C(pp)))
    b[18] = mean((wc - wcm1) / dzf_k * C(pp))
    b[19] = mean(0.25 * (((C(wp, i=1) - wc) / dx) ** 2
                         + ((wc - C(wp, i=-1)) / dx) ** 2
                         + ((C(wp, i=1, k=-1) - wcm1) / dx) ** 2
                         + ((wcm1 - C(wp, i=-1, k=-1)) / dx) ** 2)
                 + 0.25 * (((C(wp, j=1) - wc) / dy) ** 2
                           + ((wc - C(wp, j=-1)) / dy) ** 2
                           + ((C(wp, j=1, k=-1) - wcm1) / dy) ** 2
                           + ((wcm1 - C(wp, j=-1, k=-1)) / dy) ** 2)
                 + ((wc - wcm1) / dzf_k) ** 2)
    # uw terms (output.f90:868-925)
    b[20] = mean(0.5 * (wc ** 2 + wcm1 ** 2))
    b[21] = mean((0.25 * (wc + wcp1 + C(wp, k=1, i=1) + C(wp, i=1)) * ucp1
                  - 0.25 * (wc + wcm1 + C(wp, k=-1, i=1) + C(wp, i=1)) * uc)
                 / dzc_k)
    b[22] = mean(wc ** 2)
    b[23] = mean(0.125 * (ucp1 + uc) * (wc + C(wp, i=1)) ** 2)
    b[24] = mean(0.5 * (C(pp, k=1) + C(pp)))
    b[25] = mean(0.25 * (uc + ucp1 + C(up, k=1, i=-1) + ukm)
                 * 0.5 * (C(pp, k=1) + C(pp)))
    dwdx_c = 0.25 * ((C(wp, i=1) - wc) / dx + (wc - C(wp, i=-1)) / dx
                     + (C(wp, i=1, k=-1) - wcm1) / dx
                     + (wcm1 - C(wp, i=-1, k=-1)) / dx)
    b[26] = mean(dudz_c * C(pp) + dwdx_c * C(pp))
    dudy_c = 0.25 * ((C(up, j=1) - uc) / dy + (uc - C(up, j=-1)) / dy
                     + (C(up, j=1, i=-1) - ukm) / dy
                     + (ukm - C(up, j=-1, i=-1)) / dy)
    dwdy_c = 0.25 * ((C(wp, j=1) - wc) / dy + (wc - C(wp, j=-1)) / dy
                     + (C(wp, j=1, k=-1) - wcm1) / dy
                     + (wcm1 - C(wp, j=-1, k=-1)) / dy)
    b[27] = mean((uc - ukm) / dx * dwdx_c + dudy_c * dwdy_c
                 + dudz_c * (wc - wcm1) / dzf_k)
    # split dissipation contributions (output.f90:927-948)
    b[28] = mean((ucp1 - uc) / dzc_k)
    b[29] = mean(((uc - ukm) / dx) ** 2)
    b[30] = mean(((C(up, j=1) - uc) / dy) ** 2)
    b[31] = mean(((ucp1 - uc) / dzc_k) ** 2)
    b[32] = mean(((C(vp, i=1) - vc) / dx) ** 2)
    b[33] = mean(((vc - vjm) / dy) ** 2)
    b[34] = mean(((vcp1 - vc) / dzc_k) ** 2)
    b[35] = mean(((C(wp, i=1) - wc) / dx) ** 2)
    b[36] = mean(((C(wp, j=1) - wc) / dy) ** 2)
    b[37] = mean(((wc - wcm1) / dzf_k) ** 2)
    if reduce is not None:
        b = reduce(b)
    if not write:
        return b

    zc, zf = grid.zc, grid.zf
    with open(str(fname) + '_reystr_budget.out', 'w') as f:
        for k in range(nz):
            row = [zc[k + 1], zf[k + 1], *b[:, k], dzc[k + 1], dzf[k + 1]]
            f.write(' '.join(f'{v:24.16e}' for v in row) + '\n')
    b.astype(np.float64).T.tofile(str(fname) + '_reystr_budget.bin')
    return b
