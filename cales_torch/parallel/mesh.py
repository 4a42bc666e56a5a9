"""The device mesh: dims = (gy, gx), one rank a y slab (gx = 1) or a
pencil (gx > 1).

Counterpart of cales_tpu/parallel/mesh.py, a ('gy', 'gx') mesh whose
devices are ordered as a (gy, gx) reshape (cales_tpu/parallel/mesh.py:35):
rank r = iy gx + ix holds the y rows [iy ny/gy, (iy+1) ny/gy) and the x
columns [ix nx/gx, (ix+1) nx/gx) of every (nz, ny, nx) field, the JAX
package's kernel-sharded route (cales_tpu/timeloop.py `_kernel_sharded`,
`_gx_sharded` and `use_pallas_solve_sharded`); z stays whole on every
rank, as the reference's pencils keep the tridiagonal direction local.
With gx = 1 x stays whole too: the y slabs.

  halo_y            the y rows the stencil kernels read across a y edge:
                    row -1 from the rank below and row ny/gy from the rank
                    above (two rows a side for the dsmag kernel), of each
                    field and of its z-edge stack (the JAX package's
                    _halo_strips packs both; its 8-row strips are Mosaic's
                    granularity, the port moves the rows it reads); the y
                    neighbours are (iy -+ 1 mod gy, ix), with gy = 1 the
                    local wrap;
  halo_x            on a pencil the x columns -1 and nx/gx from the x
                    neighbours (iy, ix -+ 1 mod gx) in the form of an x
                    stack (the JAX package's _xe_pack bundles), whose rows
                    -1 and ny/gy then ride halo_y: the (x +-1, y +-1)
                    corners arrive by two hops; two columns a side for the
                    dsmag kernel, whose rows -2, -1, ny/gy and ny/gy + 1
                    ride halo_y at depth 2 (the (x +-1..2, y +-1..2)
                    corners, cales_tpu/timeloop.py:1003-1005);
  transpose_y_to_x  the Poisson solve's forward pencil transpose on the y
  transpose_x_to_y  slabs: split x, gather y, and back, on
                    all_to_all_single: the x columns of the 'mat' route,
                    or on the 'fft' route the real view of the half
                    spectrum's kx lanes (kx_lanes a rank; complex data
                    travels as plain reals, so gloo and NCCL carry it
                    alike);
  pencil_to_slab    on a pencil mesh the re-slab around the Poisson solve:
  slab_to_pencil    one all-to-all inside the mesh row (the gx ranks of one
                    iy) turns the pencil into the y slab of the world's
                    P = gy gx slabs (`slab`, rank r its rows [r ny/P,
                    (r+1) ny/P)), whose transposes the slab route runs
                    unchanged, and back;
  all_reduce        sums and maxima over the whole domain;
  row_sum, column_sum  sums over a mesh row (`row`: the gx ranks of one
                    iy) or a mesh column (`col`: the gy ranks of one ix).

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
    and grids run is timeloop.unsupported()'s to say (nx and ny divisible
    by gy, and by gy gx on a pencil mesh); the mesh checks the world size
    and the divisions it needs.

      nyl, y0   this rank's y rows [y0, y0 + nyl), nyl = ny / gy
      nxp, x0   its x columns [x0, x0 + nxp), nxp = nx / gx (nx on a slab)
      nxl       the x columns a rank holds between the Poisson solve's
                transposes: nx / gy on a slab, nx / (gy gx) on the world
                slab of a pencil mesh
      slab      with gx > 1 the world's y slabs, dims (gy gx, 1), on the
                same transport: the Poisson solve's mesh after the
                re-slab
      row, col  with gx > 1 the process groups (comm.Comm.group) of this
                rank's mesh row (the gx ranks of its iy) and mesh column
                (the gy ranks of its ix; one rank with gy = 1), for
                row_sum and column_sum; None on a slab, whose column is
                the world"""

    def __init__(self, comm: commmod.Comm, dims, ng):
        gy, gx = int(dims[0]), int(dims[1])
        if comm.size != gy * gx:
            raise ValueError(f'dims = ({gy}, {gx}) needs {gy * gx} ranks, the '
                             f'process group has {comm.size}')
        nx, ny, nz = ng
        if gx == 1 and (ny % gy or nx % gy):
            raise ValueError(f'dims = ({gy}, {gx}): ny = {ny} and nx = {nx} '
                             f'must divide by gy = {gy}')
        if gx > 1 and (ny % (gy * gx) or nx % (gy * gx)):
            raise ValueError(f'dims = ({gy}, {gx}): ny = {ny} and nx = {nx} '
                             f'must divide by gy gx = {gy * gx} (the Poisson '
                             'solve\'s re-slab)')
        self.comm = comm
        self.gy, self.gx = gy, gx
        self.rank = comm.rank
        self.iy, self.ix = divmod(self.rank, gx)
        self.ng = tuple(ng)
        self.nyl = ny // gy
        self.nxp = nx // gx
        self.nxl = nx // (gy * gx)
        self.y0 = self.iy * self.nyl
        self.x0 = self.ix * self.nxp
        # the neighbours along y (same ix) and along x (same iy), periodic
        self.ylo = ((self.iy - 1) % gy) * gx + self.ix
        self.yhi = ((self.iy + 1) % gy) * gx + self.ix
        self.xlo = self.iy * gx + (self.ix - 1) % gx
        self.xhi = self.iy * gx + (self.ix + 1) % gx
        self.slab = self.row = self.col = None
        if gx > 1:
            # every rank makes every row's group, then every column's, in
            # one order
            rows = [comm.group([q * gx + i for i in range(gx)])
                    for q in range(gy)]
            cols = [comm.group([q * gx + i for q in range(gy)])
                    for i in range(gx)]
            self.row, self.col = rows[self.iy], cols[self.ix]
            self.slab = SlabMesh(comm, (gy * gx, 1), ng)

    def describe(self) -> str:
        if self.gx == 1:
            return (f'y slabs dims = ({self.gy}, 1), rank {self.rank}: y rows '
                    f'[{self.y0}, {self.y0 + self.nyl}) of {self.ng[1]}; '
                    f'transport {self.comm.describe()}')
        return (f'pencils dims = ({self.gy}, {self.gx}), rank {self.rank} = '
                f'(iy {self.iy}, ix {self.ix}): y rows [{self.y0}, '
                f'{self.y0 + self.nyl}) of {self.ng[1]}, x columns '
                f'[{self.x0}, {self.x0 + self.nxp}) of {self.ng[0]}; '
                f'transport {self.comm.describe()}')

    # -- placement -------------------------------------------------------
    def local(self, a):
        """This rank's block (n, ny/gy, nx/gx) of a global (n, ny, nx) array
        (numpy or tensor; a field or a z-edge stack); one of the block's
        shape is returned as it is."""
        nx, ny = self.ng[0], self.ng[1]
        if (tuple(a.shape[1:3]) == (self.nyl, self.nxp)
                and (self.nyl, self.nxp) != (ny, nx)):
            return a
        if tuple(a.shape[1:3]) != (ny, nx):
            raise ValueError(f'field of (y, x) extent {tuple(a.shape[1:3])}: '
                             f'want {(ny, nx)} (global) or '
                             f'{(self.nyl, self.nxp)} (this rank\'s)')
        sl = a[:, self.y0:self.y0 + self.nyl, self.x0:self.x0 + self.nxp]
        return np.ascontiguousarray(sl) if isinstance(a, np.ndarray) \
            else sl.contiguous()

    def gather(self, t):
        """The global (nz, ny, nx) numpy array of a sharded field, on every
        rank."""
        parts = [p.numpy() for p in self.comm.all_gather(t)]
        g = self.gx
        return np.concatenate([np.concatenate(parts[q * g:(q + 1) * g],
                                              axis=2)
                               for q in range(self.gy)], axis=1)

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
        from_lo, from_hi = self.comm.exchange(to_lo=first, to_hi=last,
                                              lo=self.ylo, hi=self.yhi)
        rows = iter(torch.cat([lo.view(sh), hi.view(sh)], dim=1)
                    for lo, hi, sh in zip(torch.split(from_lo, sizes),
                                          torch.split(from_hi, sizes),
                                          shapes))
        return [(next(rows), None if e is None else next(rows))
                for _, e in pairs]

    def halo_x(self, pairs, depth=1):
        """pairs: [(field (n, nyl, nxp), z-edge stack (3, nyl, nxp) or
        None), ...] of a pencil.  One exchange with the x neighbours for
        all the pairs.  Depth 1 (the stencil kernels) returns [(cols
        (n, 3, nyl), corners (3, 3, nyl) or None), ...]: each field's x
        halo in the form of an x stack (kernels.xpad): column 0 the lower x
        neighbour's last column (x = -1), column 2 the upper neighbour's
        first (x = nxp), column 1 the field's own last column (no rewrite
        slot: the halo mode never reads it), corners the same columns of
        its z-edge stack.  Depth 2 (the dsmag kernel's velocity tile)
        returns (cols (n, 4, nyl), corners (3, 4, nyl)): the columns -2,
        -1 (the lower neighbour's last two), nxp and nxp + 1 (the upper
        neighbour's first two), in that order.  Their rows -depth .. -1
        and nyl .. nyl + depth - 1 are the y exchange's
        (timeloop._xstacks_on_slab); with gx = 1 the columns are the local
        wrap."""
        d = int(depth)
        if d not in (1, 2) or d > self.nxp:
            raise ValueError(f'halo_x: depth {d} on pencils of {self.nxp} '
                             'columns')
        parts = [q for pair in pairs for q in pair if q is not None]
        shapes = [(q.shape[0], d, q.shape[1]) for q in parts]
        sizes = [math.prod(sh) for sh in shapes]
        first = torch.cat([q[..., :d].transpose(1, 2).reshape(-1)
                           for q in parts])
        last = torch.cat([q[..., -d:].transpose(1, 2).reshape(-1)
                          for q in parts])
        from_lo, from_hi = self.comm.exchange(to_lo=first, to_hi=last,
                                              lo=self.xlo, hi=self.xhi)

        def cols(q, lo, hi):
            mid = [q[..., -1][:, None]] if d == 1 else []
            return torch.cat([lo, *mid, hi], dim=1)
        it = iter(cols(q, lo.view(sh), hi.view(sh))
                  for q, lo, hi, sh in zip(parts,
                                           torch.split(from_lo, sizes),
                                           torch.split(from_hi, sizes),
                                           shapes))
        return [(next(it), None if e is None else next(it))
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

    def pencil_to_slab(self, a):
        """a (nz, nyl, nxp), this rank's pencil -> (nz, ny/P, nx), its y slab
        of the world's P = gy gx (rows [rank ny/P, (rank+1) ny/P): rank =
        iy gx + ix, so the slabs of a mesh row are its pencils' rows in x
        order).  One all-to-all inside the mesh row: block q the rows of
        the row's q-th slab, received as the q-th pencil's columns."""
        nz, g, nxp = a.shape[0], self.gx, self.nxp
        nys = self.nyl // g
        send = a.reshape(nz, g, nys, nxp).permute(1, 0, 2, 3).contiguous()
        recv = self.comm.all_to_all(send, group=self.row)
        return recv.permute(1, 2, 0, 3).reshape(nz, nys, g * nxp)

    def slab_to_pencil(self, a):
        """pencil_to_slab's inverse: (nz, ny/P, nx) -> (nz, nyl, nxp)."""
        nz, nys, g, nxp = a.shape[0], a.shape[1], self.gx, self.nxp
        send = a.reshape(nz, nys, g, nxp).permute(2, 0, 1, 3).contiguous()
        recv = self.comm.all_to_all(send, group=self.row)
        return recv.permute(1, 0, 2, 3).reshape(nz, g * nys, nxp)

    # -- reductions ----------------------------------------------------------
    def all_reduce(self, t, op: str = 'sum'):
        return self.comm.all_reduce(t, op)

    def column_sum(self, t):
        """The sum of t over this rank's mesh column (the ranks that share
        its x columns): the world on a slab."""
        return self.comm.all_reduce(t, group=self.col)

    def row_sum(self, t):
        """The sum of t over this rank's mesh row (the ranks that share its
        y rows): t itself on a slab."""
        return t if self.row is None else self.comm.all_reduce(
            t, group=self.row)

    def reduce_scalar(self, x, op: str):
        """A python float reduced over the ranks."""
        t = torch.tensor([float(x)], dtype=torch.float64,
                         device=self.comm.device)
        return float(self.comm.all_reduce(t, op)[0])

    def mean_of_ranks(self, a):
        """The mean over the ranks of a numpy array (a slab's or pencil's
        plane means -> the domain's: the blocks are of one size)."""
        t = torch.as_tensor(np.ascontiguousarray(a), device=self.comm.device)
        return self.comm.all_reduce(t).cpu().numpy() / self.comm.size

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
