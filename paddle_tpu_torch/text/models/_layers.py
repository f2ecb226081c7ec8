"""What the port's models share: building their layers on a device from
a seed, in a dtype.

The models are `nn.Layer`s made of the `nn` layers (`Linear` with
Paddle's [in, out] weight, `Embedding`, `RMSNorm`, `LayerNorm`,
`Dropout`), so their `state_dict` is the reference's. Their forwards call
those layers on torch tensors and get torch tensors back (the op
boundary: a layer's Parameters do not make its result a Tensor).
"""
from __future__ import annotations

import contextlib

import torch

from ...core import rng
from ...core.device import placed
from ...ops._cuda_common import resolve_device


@contextlib.contextmanager
def built_on(device):
    """Layers made inside take their parameters on `device` ("cuda"
    unless the caller asks for another; no card -> RuntimeError), their
    random initial values drawn from generators seeded from torch's
    default generator, so `torch.manual_seed` (or `paddle.seed`) before
    a constructor repeats its weights. Yields the torch device."""
    dev = resolve_device(device)
    seed = int(torch.randint(0, 2 ** 62, ()).item())
    with placed(dev), rng.fork(seed):
        yield dev


def cast_floating(layer, dtype):
    """The layer's floating parameters and buffers in `dtype` (they are
    made in f32)."""
    if dtype is not None and dtype != torch.float32:
        layer._to_dtype(dtype)
    return layer
