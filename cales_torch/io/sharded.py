"""Per-rank checkpoint I/O on a device mesh (y slabs or pencils).

Counterpart of cales_tpu/io/sharded.py (the reference's MPI-IO collective
subarray writes, load.f90:155-187): every rank writes its (nz, ny/gy,
nx/gx) blocks of u, v, w, p (its y slabs, or on a pencil mesh its
pencils) at their strided (y, x) offsets of the same ``fld.bin`` file
through a memory map, and rank 0 creates the file and writes the (time,
istep) footer.  The bytes are those of io/checkpoint.save_checkpoint on the
gathered fields (with the passive scalar's one field, of save_scalar's
``scal.bin`` sidecar); no rank holds more than its block.  The barriers are
torch.distributed's (parallel/mesh.SlabMesh.barrier).
"""
from __future__ import annotations

import os

import numpy as np


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, 'detach') else np.asarray(a)


def save_checkpoint_sharded(path, fields, mesh, time: float, istep: int):
    """fields: this rank's blocks (tensors or numpy) of the file's fields in
    their order: (u, v, w, p) for fld.bin, (s,) for scal.bin."""
    nx, ny, nz = mesh.ng
    n = nx * ny * nz
    arrs = [_np(a) for a in fields]
    nf = len(arrs)
    dtype = arrs[0].dtype
    if mesh.rank == 0:
        # create and size the file before any rank maps it
        with open(path, 'wb') as f:
            f.truncate((nf * n + 2) * dtype.itemsize)
    mesh.barrier()
    mm = np.memmap(path, dtype=dtype, mode='r+', shape=(nf * n + 2,))
    ys = slice(mesh.y0, mesh.y0 + mesh.nyl)
    xs = slice(mesh.x0, mesh.x0 + mesh.nxp)
    for m, a in enumerate(arrs):
        mm[m * n:(m + 1) * n].reshape(nz, ny, nx)[:, ys, xs] = a
    if mesh.rank == 0:
        mm[nf * n] = dtype.type(time)
        mm[nf * n + 1] = dtype.type(float(istep))
    mm.flush()
    del mm
    # every slab on disk before any rank reports the checkpoint written
    mesh.barrier()


def load_checkpoint_sharded(path, ng, dtype, mesh, nfields=4):
    """This rank's blocks of a checkpoint of nfields fields (4: fld.bin, 1:
    the scalar's scal.bin), with the size check of
    io/checkpoint.load_checkpoint.  Returns (*fields, time, istep)."""
    nx, ny, nz = ng
    n = nx * ny * nz
    expected = (nfields * n + 2) * np.dtype(dtype).itemsize
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            f'checkpoint size mismatch: {actual} bytes, expected {expected} '
            f'for ng={ng} dtype={dtype} (load.f90:44-52 parity check)')
    mm = np.memmap(path, dtype=np.dtype(dtype), mode='r',
                   shape=(nfields * n + 2,))
    ys = slice(mesh.y0, mesh.y0 + mesh.nyl)
    xs = slice(mesh.x0, mesh.x0 + mesh.nxp)
    out = [np.array(mm[m * n:(m + 1) * n].reshape(nz, ny, nx)[:, ys, xs])
           for m in range(nfields)]
    time = float(mm[nfields * n])
    istep = int(round(float(mm[nfields * n + 1])))
    del mm
    return (*out, time, istep)
