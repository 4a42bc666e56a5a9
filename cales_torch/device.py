"""Device and dtype helpers.

The port runs on one explicit ``torch.device``: ``cuda`` launches the
hand-written kernels, ``cpu`` runs their plain PyTorch twins.  Nothing here
falls back from one to the other: asking for ``cuda`` without a card raises.
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {'float32': torch.float32, 'float64': torch.float64}


def set_full_fp32():
    """Keep every float32 matmul and convolution in full fp32: the z
    eigen-matmul of the Poisson solve loses the divergence-free projection
    to about three digits under TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(name: str | torch.device) -> torch.device:
    """The torch.device for a user-facing name ('cuda', 'cuda:1', 'cpu').
    Raises when CUDA is asked for and absent."""
    dev = torch.device(name)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'device cuda requested but torch.cuda.is_available() is '
                'False; pass device cpu to run the plain PyTorch twins')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {dev}')
    set_full_fp32()
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a Config dtype string or numpy dtype."""
    key = np.dtype(dtype).name
    if key not in _TORCH_DTYPES:
        raise ValueError(f'unsupported dtype {dtype!r} (float32 or float64)')
    return _TORCH_DTYPES[key]
