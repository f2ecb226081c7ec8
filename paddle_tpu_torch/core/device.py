"""Places and the current device.

Port of paddle_tpu/core/device.py. A `Place` names a torch device. The
default device is the card (`cuda:0`): `to_tensor` and the creation ops
with no `place` put their tensors there, and raise `RuntimeError` when
there is no card, as the port's other entry points do
(`ops._cuda_common.resolve_device`). `set_device("cpu")` (or a `place`
argument) is how a caller asks for the CPU; there is no silent fallback.
"""
from __future__ import annotations

import contextlib

import torch

from ..ops._cuda_common import resolve_device


class Place:
    """A device place over one torch device."""

    def __init__(self, device=None):
        self._device = None if device is None else torch.device(device)

    @property
    def device(self) -> torch.device:
        """The torch device (resolved to the card at first use when the
        place names none)."""
        if self._device is None:
            self._device = resolve_device("cuda:0")
        return self._device

    def is_cpu_place(self):
        return self.device.type == "cpu"

    def is_gpu_place(self):
        return self.device.type == "cuda"

    def is_cuda_pinned_place(self):
        return False

    def __eq__(self, other):
        return isinstance(other, Place) and self.device == other.device

    def __hash__(self):
        return hash(self.device)

    def __repr__(self):
        d = self.device
        return f"Place({'gpu' if d.type == 'cuda' else d.type}:" \
               f"{d.index or 0})"


class CPUPlace(Place):
    def __init__(self, idx: int = 0):
        super().__init__("cpu")


class CUDAPlace(Place):
    def __init__(self, idx: int = 0):
        super().__init__(f"cuda:{int(idx)}")


class CUDAPinnedPlace(Place):
    """Page-locked host memory: a host place (`to(place)` pins)."""

    def __init__(self):
        super().__init__("cpu")

    def is_cuda_pinned_place(self):
        return True

    def __repr__(self):
        return "Place(cuda_pinned)"


_current: Place | None = None


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return Place(device)
    if not isinstance(device, str):
        raise ValueError(f"unsupported device spec {device!r}")
    name, _, idx = device.partition(":")
    if name == "cpu":
        return CPUPlace()
    if name in ("gpu", "cuda"):
        return CUDAPlace(int(idx or 0))
    raise ValueError(f"unsupported device {device!r}")


def set_device(device) -> Place:
    """Make `device` ("cpu", "gpu", "gpu:0", "cuda:0" or a Place) the one
    the Tensor API creates on."""
    global _current
    place = _parse(device)
    if place.device.type == "cuda":
        resolve_device(place.device)
    _current = place
    return place


@contextlib.contextmanager
def placed(device):
    """The Tensor API creates on `device` (a torch device, taken as it
    is) inside; the current device comes back after."""
    global _current
    prev = _current
    _current = Place(device)
    try:
        yield
    finally:
        _current = prev


def get_device() -> str:
    d = current_place().device
    return "cpu:0" if d.type == "cpu" else f"gpu:{d.index or 0}"


def current_place() -> Place:
    return _current or Place()


def current_device() -> torch.device:
    """The torch device the Tensor API creates on (the card unless
    `set_device` chose another); raises without a card."""
    return (_current or Place()).device


def device_of(place) -> torch.device:
    """A `place` argument (Place, torch device, name or None) as a torch
    device; None is the current device."""
    if place is None:
        return current_device()
    return _parse(place).device


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()
