"""The Tensor API's random state: one explicit `torch.Generator` per
device.

Port of paddle_tpu/core/rng.py. The reference threads one jax PRNG key
through every random op; the port keeps one generator per device, made at
first use and seeded with the last `seed(n)` (0 before any), so a seed
repeats every random op's values on that device. `seed` also seeds
torch's default generators, which the port's dropout draws from, as the
reference's `seed` governs its dropout too. The values cannot equal
jax's.
"""
from __future__ import annotations

import torch

_seed = 0
_gens: dict = {}


def seed(value: int):
    """Reseed every device's generator (made anew at next use) and
    torch's default generators."""
    global _seed
    _seed = int(value)
    _gens.clear()
    torch.manual_seed(_seed)
    return _seed


def generator(device) -> torch.Generator:
    """The generator of `device` (a torch device), made at first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    g = _gens.get(device)
    if g is None:
        g = torch.Generator(device=device)
        g.manual_seed(_seed)
        _gens[device] = g
    return g


def get_rng_state(device=None):
    """[the state of the current device's generator] (the reference's
    list of one key)."""
    from .device import current_device

    return [generator(device or current_device()).get_state()]


def set_rng_state(state, device=None):
    from .device import current_device

    generator(device or current_device()).set_state(state[0])
