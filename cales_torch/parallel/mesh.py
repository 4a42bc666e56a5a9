"""The y-slab mesh: dims = (gy, 1), one rank a y slab.

Counterpart of cales_tpu/parallel/mesh.py for the JAX package's
kernel-sharded route with gx = 1 (cales_tpu/timeloop.py `_kernel_sharded`
and `use_pallas_solve_sharded`).  Rank r holds the y rows [r ny/gy,
(r+1) ny/gy) of every (nz, ny, nx) field; z and x stay whole on every
rank, as the reference's pencils keep the tridiagonal direction local.

  halo_y            the y rows the stencil kernels read across a slab edge:
                    row -1 from the rank below and row ny/gy from the rank
                    above (two rows a side for the dsmag kernel), of each
                    field and of its z-edge stack (the JAX package's
                    _halo_strips packs both; its 8-row strips are Mosaic's
                    granularity, the port moves the rows it reads);
  transpose_y_to_x  the Poisson solve's forward pencil transpose: split x,
  transpose_x_to_y  gather y, and back, on all_to_all_single: the x
                    columns of the 'mat' route, or on the 'fft' route the
                    real view of the half spectrum's kx lanes (kx_lanes a
                    rank; complex data travels as plain reals, so gloo and
                    NCCL carry it alike);
  all_reduce        sums and maxima over the whole domain.

The transport (parallel/comm.py) is the caller's explicit choice.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import comm as commmod


class SlabMesh:
    """The mesh of one rank: `comm` its collectives, `ng` = (nx, ny, nz) the
    global grid, dims = (gy, gx) as the namelist's dims(1:2).  Which dims
    and grids run is timeloop.unsupported()'s to say (gx = 1, nx and ny
    divisible by gy); the mesh checks the world size only."""

    def __init__(self, comm: commmod.Comm, dims, ng):
        gy, gx = int(dims[0]), int(dims[1])
        if comm.size != gy * gx:
            raise ValueError(f'dims = ({gy}, {gx}) needs {gy * gx} ranks, the '
                             f'process group has {comm.size}')
        nx, ny, nz = ng
        if ny % gy or nx % gy:
            raise ValueError(f'dims = ({gy}, {gx}): ny = {ny} and nx = {nx} '
                             f'must divide by gy = {gy}')
        self.comm = comm
        self.gy = gy
        self.rank = comm.rank
        self.ng = tuple(ng)
        self.nyl = ny // gy
        self.nxl = nx // gy
        self.y0 = self.rank * self.nyl

    def describe(self) -> str:
        return (f'y slabs dims = ({self.gy}, 1), rank {self.rank}: y rows '
                f'[{self.y0}, {self.y0 + self.nyl}) of {self.ng[1]}; '
                f'transport {self.comm.describe()}')

    # -- placement -------------------------------------------------------
    def local(self, a):
        """This rank's slab (nz, ny/gy, nx) of a global (nz, ny, nx) array
        (numpy or tensor); a slab-shaped one is returned as it is."""
        if a.shape[1] == self.nyl and self.nyl != self.ng[1]:
            return a
        if a.shape[1] != self.ng[1]:
            raise ValueError(f'field of y extent {a.shape[1]}: want '
                             f'{self.ng[1]} (global) or {self.nyl} (slab)')
        sl = a[:, self.y0:self.y0 + self.nyl]
        return np.ascontiguousarray(sl) if isinstance(a, np.ndarray) \
            else sl.contiguous()

    def gather(self, t):
        """The global (nz, ny, nx) numpy array of a slab-sharded field, on
        every rank."""
        parts = self.comm.all_gather(t)
        return np.concatenate([p.numpy() for p in parts], axis=1)

    # -- halos -------------------------------------------------------------
    def halo_y(self, pairs, depth=1):
        """pairs: [(field (n, nyl, nx), z-edge stack (3, nyl, nx) or None),
        ...].  Returns [(rows (n, 2 depth, nx), corners (3, 2 depth, nx) or
        None), ...]: rows holds rows -depth .. -1 (the lower neighbour's
        last rows) and nyl .. nyl + depth - 1 (the upper neighbour's first
        rows), corners their z-edge stack entries, in the stack's order.
        One neighbour exchange for all the pairs.  Depth 1 serves the
        stencil kernels, depth 2 the dsmag kernel (its velocity tile's y
        halo); a neighbour's slab must be that deep (no rank two away is
        reached).  Any array whose dim 1 is y may ride the same exchange
        (an x stack's columns and corners, transposed to (n, nyl, 3)): the
        trailing dims need not be nx."""
        d = int(depth)
        if not 1 <= d <= self.nyl:
            raise ValueError(f'halo_y: depth {d} on slabs of {self.nyl} rows')
        parts = [q for pair in pairs for q in pair if q is not None]
        shapes = [(q.shape[0], d, *q.shape[2:]) for q in parts]
        sizes = [math.prod(sh) for sh in shapes]
        first = torch.cat([q[:, :d].reshape(-1) for q in parts])
        last = torch.cat([q[:, self.nyl - d:].reshape(-1) for q in parts])
        from_lo, from_hi = self.comm.exchange(to_lo=first, to_hi=last)
        rows = iter(torch.cat([lo.view(sh), hi.view(sh)], dim=1)
                    for lo, hi, sh in zip(torch.split(from_lo, sizes),
                                          torch.split(from_hi, sizes),
                                          shapes))
        return [(next(rows), None if e is None else next(rows))
                for _, e in pairs]

    # -- pencil transposes of the Poisson solve ----------------------------
    def kx_lanes(self, nxh: int) -> int:
        """The lanes a rank holds of a half spectrum of nxh = nx/2 + 1
        complex lanes on the 'fft' route: ceil(nxh / gy), the last rank's
        tail dead padding, so that every block of the all-to-all is of one
        size (nxh, odd, divides by no even gy)."""
        return -(-int(nxh) // self.gy)

    def transpose_y_to_x(self, blocks):
        """blocks (gy, nz, nyl, nxl), block q this slab's x columns
        [q nxl, (q+1) nxl) (solve_kernels.apply_x(split=gy) writes them so;
        on the 'fft' route the real view of rank q's kx lanes, nxl = 2
        kx_lanes) -> (nz, ny, nxl): this rank's x columns over all y.  One
        all-to-all and one copy."""
        recv = self.comm.all_to_all(blocks)
        g, nz, nyl, nxl = recv.shape
        return recv.permute(1, 0, 2, 3).reshape(nz, g * nyl, nxl)

    def transpose_x_to_y(self, a):
        """a (nz, ny, nxl), this rank's x columns (or lanes) -> (gy, nz,
        nyl, nxl): block q rank q's x columns on this slab's y rows, the
        chunked input solve_kernels.apply_x takes.  One copy and one
        all-to-all."""
        nz, ny, nxl = a.shape
        send = a.reshape(nz, self.gy, ny // self.gy, nxl).permute(
            1, 0, 2, 3).contiguous()
        return self.comm.all_to_all(send)

    # -- reductions ----------------------------------------------------------
    def all_reduce(self, t, op: str = 'sum'):
        return self.comm.all_reduce(t, op)

    def reduce_scalar(self, x, op: str):
        """A python float reduced over the ranks."""
        t = torch.tensor([float(x)], dtype=torch.float64,
                         device=self.comm.device)
        return float(self.comm.all_reduce(t, op)[0])

    def mean_of_ranks(self, a):
        """The mean over the ranks of a numpy array (a slab's plane means
        -> the domain's: the slabs are of one size)."""
        t = torch.as_tensor(np.ascontiguousarray(a), device=self.comm.device)
        return self.comm.all_reduce(t).cpu().numpy() / self.gy

    def barrier(self):
        self.comm.barrier()


def from_env(dims, ng, device: str, transport: str):
    """Start the process group from the environment of
    `python -m torch.distributed.run` and build this rank's mesh; returns
    (mesh, device).  Raises when the world size is not gy * gx or the
    transport cannot serve the ranks: there is no single-device retry."""
    rank, world, local, local_world = commmod.env_rank()
    gy, gx = int(dims[0]), int(dims[1])
    if world != gy * gx:
        raise ValueError(f'dims = ({gy}, {gx}) needs {gy * gx} ranks, '
                         f'WORLD_SIZE is {world}')
    dev = commmod.rank_device(device, transport, local, local_world)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    commmod.init_process_group(transport, rank, world)
    comm = commmod.Comm(transport, dev)
    return SlabMesh(comm, (gy, gx), ng), dev
