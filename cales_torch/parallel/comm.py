"""The transport of the device mesh: torch.distributed collectives over an
explicit backend.

  'nccl'  one card a rank, the collectives on the tensors where they lie;
  'gloo'  CPU tensors as they are; CUDA tensors staged through pinned host
          buffers (device -> host, the collective on the host, host ->
          device).  This is how several ranks share one card, which NCCL
          refuses ("Duplicate GPU detected").  It is slow, and it is chosen
          by the caller, never switched on after a failure.

The process group is started by init_process_group with its address, world
size and rank given (a ``tcp://`` or ``file://`` init method, or the
environment that ``python -m torch.distributed.run`` sets).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

TRANSPORTS = ('nccl', 'gloo')
_OPS = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX,
        'min': dist.ReduceOp.MIN}


def init_process_group(transport: str, rank: int, world_size: int,
                       init_method: str = 'env://'):
    """Start the default process group on `transport`."""
    if transport not in TRANSPORTS:
        raise ValueError(f'transport {transport!r} (one of {TRANSPORTS})')
    dist.init_process_group(backend=transport, init_method=init_method,
                            rank=rank, world_size=world_size)


def rank_device(device: str, transport: str, local_rank: int,
                local_world: int) -> torch.device:
    """The device of this rank, or a ValueError when `transport` cannot
    serve the ranks on it: NCCL needs a card a rank on this host and CUDA
    tensors; gloo serves CPU tensors, and CUDA ones staged through the host
    (several ranks may share a card)."""
    dev = torch.device(device)
    if transport not in TRANSPORTS:
        raise ValueError(f'transport {transport!r} (one of {TRANSPORTS})')
    if dev.type == 'cpu':
        if transport != 'gloo':
            raise ValueError(f"transport {transport!r} with CPU tensors: "
                             "use 'gloo'")
        return dev
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    if not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but torch.cuda.'
                           'is_available() is False')
    ncard = torch.cuda.device_count()
    if transport == 'nccl':
        if ncard < local_world:
            raise ValueError(
                f"transport 'nccl' puts one rank on a card: this host has "
                f'{ncard} card(s) for {local_world} ranks (pass transport '
                "'gloo' to share cards, staged through pinned host buffers)")
        return torch.device('cuda', local_rank)
    return torch.device('cuda', local_rank % ncard)


class Comm:
    """The collectives of one rank on `device` over the default process
    group's transport."""

    def __init__(self, transport: str, device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError('torch.distributed is not initialised '
                               '(comm.init_process_group)')
        backend = dist.get_backend()
        if backend != transport:
            raise ValueError(f'process group on {backend!r}, transport '
                             f'{transport!r}')
        self.transport = transport
        self.device = torch.device(device)
        if transport == 'nccl' and self.device.type != 'cuda':
            raise ValueError("transport 'nccl' carries CUDA tensors only")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        # CUDA tensors over gloo go through pinned host buffers
        self.staged = transport == 'gloo' and self.device.type == 'cuda'
        # the process groups of rank subsets (a mesh row), by their ranks
        self._groups = {}

    def describe(self) -> str:
        if self.staged:
            return (f"gloo, CUDA tensors staged through pinned host buffers "
                    f"({self.size} ranks)")
        return f'{self.transport} ({self.size} ranks)'

    # -- staging ---------------------------------------------------------
    def _to_host(self, t):
        if not self.staged:
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def _back(self, h, like):
        if not self.staged:
            return h
        return h.to(like.device)

    # -- collectives -----------------------------------------------------
    def all_reduce(self, t, op: str = 'sum', group=None):
        """The reduction of t over the ranks ('sum', 'max' or 'min'), or
        over the ranks of `group` (a Comm.group), as a new tensor on t's
        device.  A group of one rank is t itself, no message."""
        if group is not None and group[1] == 1:
            return t.detach().clone()
        h = self._to_host(t) if self.staged else t.detach().clone()
        dist.all_reduce(h, op=_OPS[op],
                        group=None if group is None else group[0])
        return self._back(h, t)

    def group(self, ranks):
        """The process group of `ranks` (dist.new_group, made once): every
        rank of the world must ask for the same groups in the same order,
        its own or not.  A group of one rank makes no process group: its
        collectives are local."""
        key = tuple(int(r) for r in ranks)
        if key not in self._groups:
            self._groups[key] = (None if len(key) == 1
                                 else dist.new_group(list(key)), len(key))
        return self._groups[key]

    def all_to_all(self, send, group=None):
        """all_to_all_single along dim 0: block q of `send` goes to rank q
        (of `group`, a Comm.group, when given: its q-th rank), block q of
        the result came from rank q.  Every block is of one size."""
        pg, size = (None, self.size) if group is None else group
        if send.shape[0] != size:
            raise ValueError(f'all_to_all: dim 0 is {send.shape[0]}, want '
                             f'{size} blocks')
        h = self._to_host(send)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=pg)
        return self._back(out, send)

    def exchange(self, to_lo, to_hi, lo, hi):
        """Neighbour exchange on a periodic ring of ranks (a mesh axis):
        to_lo goes to rank lo and to_hi to rank hi; returns (from_lo,
        from_hi), what lo sent up and hi sent down.  A ring of one (lo and
        hi this rank) is the local wrap, no message."""
        if lo == hi == self.rank:
            return to_hi, to_lo
        a, b = self._to_host(to_lo), self._to_host(to_hi)
        from_lo, from_hi = torch.empty_like(b), torch.empty_like(a)
        # the tags tell the two messages of a two-rank ring apart; NCCL
        # matches them in the order issued, which is the same on both sides
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, b, hi, tag=0),
            dist.P2POp(dist.irecv, from_lo, lo, tag=0),
            dist.P2POp(dist.isend, a, lo, tag=1),
            dist.P2POp(dist.irecv, from_hi, hi, tag=1)])
        for r in reqs:
            r.wait()
        return self._back(from_lo, to_hi), self._back(from_hi, to_lo)

    def all_gather(self, t):
        """[t of rank 0, t of rank 1, ...] on the host."""
        h = self._to_host(t)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h)
        return [p.cpu() for p in parts]

    def barrier(self):
        if self.transport == 'nccl':
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def env_rank() -> tuple[int, int, int, int]:
    """(rank, world_size, local_rank, local_world_size) from the environment
    that torch.distributed.run sets; a RuntimeError when it is absent."""
    try:
        rank = int(os.environ['RANK'])
        world = int(os.environ['WORLD_SIZE'])
    except KeyError as e:
        raise RuntimeError(
            'a device mesh (dims) needs one process a rank: launch with '
            '`python -m torch.distributed.run --nproc_per_node <gy gx> -m '
            f'cales_torch ...` (missing {e.args[0]} in the environment)'
        ) from None
    local = int(os.environ.get('LOCAL_RANK', rank))
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    return rank, world, local, local_world
