"""Carry solver state between the JAX package and the port.

The solver's counterpart of carrying weights across: a cales_tpu
``timeloop.State``, turned into a dict of numpy arrays (``np.asarray`` on
each leaf), becomes a cales_torch ``State`` on a device, and back.  Used by
the parity tests and by restarts from a JAX run.
"""
from __future__ import annotations

import numpy as np
import torch

from .timeloop import State

_FIELDS = ('u', 'v', 'w', 'p', 'visct')
_SCALAR = ('s', 'dsdt_old')


def state_from_jax_numpy(d: dict, device, dtype) -> State:
    """d: {'u', 'v', 'w', 'p', 'visct': (nz, ny, nx); 'vlo', 'rhs_old':
    3-tuples; 'zq': 3-tuple of (3, ny, nx) or None; 'time'; 'istep'} with
    numpy leaves.  vlo carries the kept wall-face planes as they are: w's
    lower z face, with y walls v's lower y face, and with x walls u's
    lower x face (the inflow face), which the next substep's fills read.
    A None zq (the JAX expression path keeps none) is rebuilt by the first
    substep from vlo, and so are the y-row and x stacks (State.yq, xq),
    which the JAX package does not carry.  A passive scalar rides 's' and
    'dsdt_old' (None or absent without one)."""
    dev = torch.device(device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)
    zq = d.get('zq')
    return State(
        **{k: t(d[k]) for k in _FIELDS},
        vlo=tuple(t(a) for a in d['vlo']),
        rhs_old=tuple(t(a) for a in d['rhs_old']),
        time=float(np.asarray(d['time'])),
        istep=int(np.asarray(d['istep'])),
        zq=None if zq is None else tuple(t(a) for a in zq),
        **{k: None if d.get(k) is None else t(d[k]) for k in _SCALAR})


def state_to_numpy(state: State) -> dict:
    """The inverse of state_from_jax_numpy: numpy leaves on the host."""
    n = lambda a: a.detach().cpu().numpy()  # noqa: E731
    return dict(
        **{k: n(getattr(state, k)) for k in _FIELDS},
        vlo=tuple(n(a) for a in state.vlo),
        rhs_old=tuple(n(a) for a in state.rhs_old),
        time=float(state.time), istep=int(state.istep),
        zq=None if state.zq is None else tuple(n(a) for a in state.zq),
        **{k: None if getattr(state, k) is None else n(getattr(state, k))
           for k in _SCALAR})
