"""Fortran-namelist (`input.nml`) reader producing a Config.

Compatibility layer with the reference's input format
(reference param.f90:88-151: namelists &dns and &les; see
examples under the reference's examples/).  A user of the reference can point
this framework at the same input.nml.
"""
from __future__ import annotations

import re

import numpy as np

from .config import Config


def _tokenize(rhs: str):
    """Split a namelist RHS into tokens, handling repeat counts (n*v),
    quoted strings, logicals and numbers."""
    rhs = rhs.split('!')[0].strip().rstrip(',')
    toks = re.findall(r"'[^']*'|\"[^\"]*\"|[^\s,]+", rhs)
    out = []
    for t in toks:
        m = re.fullmatch(r'(\d+)\*(.+)', t)
        if m:
            out.extend([_scalar(m.group(2))] * int(m.group(1)))
        else:
            out.append(_scalar(t))
    return out


def _scalar(t: str):
    t = t.strip()
    if t.startswith(("'", '"')):
        return t[1:-1]
    tl = t.lower().rstrip(',')
    if tl in ('.true.', 't', 'true'):
        return True
    if tl in ('.false.', 'f', 'false'):
        return False
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t.replace('d', 'e').replace('D', 'e'))
    except ValueError:
        return t


def parse_namelists(text: str) -> dict:
    """Parse all namelists into {group: {var: [values]}}."""
    groups = {}
    cur = None
    buf = []
    for raw in text.splitlines():
        line = raw.split('!')[0].strip()
        if not line:
            continue
        if line.startswith('&'):
            cur = line[1:].strip().lower()
            groups[cur] = {}
            buf = []
            continue
        if line.startswith('/') or line.startswith('\\'):
            cur = None
            continue
        if cur is None:
            continue
        # may contain several assignments; split on top-level '=' boundaries
        for m in re.finditer(r'([A-Za-z_]\w*(?:\([^)]*\))?)\s*=\s*([^=]*?)(?=(?:,?\s*[A-Za-z_]\w*(?:\([^)]*\))?\s*=)|$)',
                             line):
            var = m.group(1).lower().replace(' ', '')
            groups[cur][var] = _tokenize(m.group(2))
    return groups


def gather(d: dict, base: str):
    """Collect a (possibly per-slice indexed) namelist array into one flat
    list in Fortran storage order, e.g. cbcvel(0:1,1:3,1)/(...,2)/(...,3)."""
    if base in d:
        return d[base]
    items = []
    for k, v in d.items():
        m = re.fullmatch(re.escape(base) + r'\(([^)]*)\)', k)
        if m:
            items.append((m.group(1), v))
    if not items:
        return None

    def keyfn(item):
        last = item[0].split(',')[-1]
        try:
            return int(last)
        except ValueError:
            return 0

    items.sort(key=keyfn)
    out = []
    for _, v in items:
        out.extend(v)
    return out


def config_from_nml(path: str, **overrides) -> Config:
    """Build a Config from a reference-style input.nml."""
    with open(path) as f:
        g = parse_namelists(f.read())
    dns = g.get('dns', {})
    les = g.get('les', {})

    def get(d, key, default=None, n=None):
        v = gather(d, key)
        if v is None:
            return default
        if n == 1:
            return v[0]
        return v

    kw = {}
    kw['ng'] = tuple(get(dns, 'ng', (32, 32, 32)))
    kw['l'] = tuple(get(dns, 'l', (1.0, 1.0, 1.0)))
    kw['gtype'] = get(dns, 'gtype', 1, 1)
    kw['gr'] = float(get(dns, 'gr', 0.0, 1))
    kw['cfl'] = float(get(dns, 'cfl', 0.95, 1))
    kw['dtmax'] = float(get(dns, 'dtmax', 1e9, 1))
    if 'dt_f' in dns:
        kw['dt_f'] = float(get(dns, 'dt_f', -1.0, 1))
    kw['visci'] = float(get(dns, 'visci', 1.0, 1))
    kw['inivel'] = str(get(dns, 'inivel', 'zer', 1))
    kw['is_wallturb'] = bool(get(dns, 'is_wallturb', False, 1))
    kw['nstep'] = int(get(dns, 'nstep', 100, 1))
    kw['time_max'] = float(get(dns, 'time_max', 100.0, 1))
    kw['tw_max'] = float(get(dns, 'tw_max', 0.1, 1))
    kw['stop_type'] = tuple(bool(b) for b in get(dns, 'stop_type', (True, False, False)))
    kw['restart'] = bool(get(dns, 'restart', False, 1))
    kw['is_overwrite_save'] = bool(get(dns, 'is_overwrite_save', True, 1))
    kw['nsaves_max'] = int(get(dns, 'nsaves_max', 0, 1))
    for k in ('icheck', 'iout0d', 'iout1d', 'iout2d', 'iout3d', 'isave'):
        v = gather(dns, k)
        if v:
            kw[k] = int(v[0])
    # BC arrays: namelist order cbcvel(0:1,1:3,1:3) -> flattened Fortran order
    # (ibound fastest, then idir, then ivel)
    flat = gather(dns, 'cbcvel')
    if flat:
        kw['cbcvel'] = tuple(tuple(tuple(
            flat[ib + 2 * (idir + 3 * ivel)] for ivel in range(3))
            for idir in range(3)) for ib in range(2))
    flat = gather(dns, 'bcvel')
    if flat:
        kw['bcvel'] = tuple(tuple(tuple(
            float(flat[ib + 2 * (idir + 3 * ivel)]) for ivel in range(3))
            for idir in range(3)) for ib in range(2))
    flat = gather(dns, 'cbcpre')
    if flat:
        kw['cbcpre'] = tuple(tuple(flat[ib + 2 * idir] for idir in range(3))
                             for ib in range(2))
    flat = gather(dns, 'bcpre')
    if flat:
        kw['bcpre'] = tuple(tuple(float(flat[ib + 2 * idir]) for idir in range(3))
                            for ib in range(2))
    flat = gather(dns, 'cbcsgs')
    if flat:
        kw['cbcsgs'] = tuple(tuple(flat[ib + 2 * idir] for idir in range(3))
                             for ib in range(2))
    flat = gather(dns, 'bcsgs')
    if flat:
        kw['bcsgs'] = tuple(tuple(float(flat[ib + 2 * idir]) for idir in range(3))
                            for ib in range(2))
    v = gather(dns, 'bforce')
    if v:
        kw['bforce'] = tuple(float(x) for x in v)
    v = gather(dns, 'is_forced')
    if v:
        kw['is_forced'] = tuple(bool(x) for x in v)
    v = gather(dns, 'velf')
    if v:
        kw['velf'] = tuple(float(x) for x in v)
    v = gather(dns, 'dims')
    if v and all(int(x) > 0 for x in v):
        kw['dims'] = tuple(int(x) for x in v)
    # &les
    if 'sgstype' in les:
        kw['sgstype'] = str(les['sgstype'][0])
    flat = gather(les, 'lwm')
    if flat:
        kw['lwm'] = tuple(tuple(int(flat[ib + 2 * idir]) for idir in range(3))
                          for ib in range(2))
    if 'hwm' in les:
        kw['hwm'] = float(les['hwm'][0])
    kw.update(overrides)
    return Config(**kw)
