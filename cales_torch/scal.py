"""Passive-scalar transport: the plain PyTorch counterpart of
cales_tpu/scal.py (reference scal.f90:14-51, the advection-diffusion RHS,
and rk.f90:123-195, rk_scal: the low-storage RK3 update with the bulk
forcing).

On the time loop's path the scalar advances inside the momentum kernel
(ops/kernels.mom_rk with sca, scae, rso: csrc/mom_rk.cu's SCAL variant);
these functions are the library form the tests hold against the JAX
package's, and what mom_rk's plain twin computes through
ops/stencil.scalar_rhs_core.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .config import RK_COEFF
# scalar_rhs(up, vp, wp, sp, alpha, dxi, dyi, dzci, dzfi): the RHS on padded
# fields (scal.f90:14-51), alpha the molecular diffusivity visc/pr
from .ops.stencil import bulk_mean, scalar_rhs


class ScalarState(NamedTuple):
    s: Any            # interior (nz, ny, nx)
    dsdtrk_old: Any   # previous-substep RHS


def rk_scal(sstate: ScalarState, up, vp, wp, sp, alpha, dt, irk, dxi, dyi,
            dzci, dzfi, ssource=0.0, is_forced=False, scalf=0.0,
            gvr_f=None):
    """One RK3 substep of the scalar (rk.f90:123-195); sp is the padded
    scalar of sstate.s.  Returns (the new state, the forcing f)."""
    f1 = RK_COEFF[irk][0] * dt
    f2 = RK_COEFF[irk][1] * dt
    f12 = f1 + f2
    dsdt = scalar_rhs(up, vp, wp, sp, alpha, dxi, dyi, dzci, dzfi)
    s = sstate.s + f1 * dsdt + f2 * sstate.dsdtrk_old + f12 * ssource
    f = torch.zeros((), dtype=s.dtype, device=s.device)
    if is_forced:
        f = scalf - bulk_mean(s, gvr_f)
        s = s + f
    return ScalarState(s=s, dsdtrk_old=dsdt), f
