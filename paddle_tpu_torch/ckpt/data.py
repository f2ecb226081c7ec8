"""Resumable data iteration: checkpointable position over a DataLoader.

Port of paddle_tpu/ckpt/data.py. A shuffled epoch's batch order is drawn from numpy's global RNG when the
loader's iterator starts (``io/sampler.py RandomSampler``).  Replaying
the REST of an interrupted epoch therefore needs exactly two things:
the numpy RNG state **as of that epoch's start** (so re-iterating draws
the identical permutation) and the number of batches already consumed.
:class:`ResumableLoader` records both, and its ``state_dict`` slots
straight into ``TrainState["data"]``.

Resume cost is one replay of the consumed prefix through the loader
(indices + collate, no model compute) — data order stays bitwise
identical to the uninterrupted run, which the crash-resume parity test
relies on.
"""
from __future__ import annotations

import numpy as np

from .train_state import pack_np_state, unpack_np_state


class ResumableLoader:
    """Wrap any iterable-of-batches (typically ``paddle.io.DataLoader``)
    with a checkpointable (epoch, batch, epoch-start-RNG) position."""

    def __init__(self, loader):
        self.loader = loader
        self.epoch = -1            # index of the epoch currently iterating
        self.batch = 0             # batches consumed in that epoch
        self._epoch_np_state = None
        self._pending = None       # set_state_dict before the next __iter__

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        if self._pending is not None:
            epoch, batch, np_state = self._pending
            self._pending = None
            self.epoch = int(epoch)
            self._epoch_np_state = np_state
            if np_state is not None:
                np.random.set_state(unpack_np_state(np_state))
            it = iter(self.loader)
            # consumed prefix: replay (same permutation) and discard
            for _ in range(int(batch)):
                next(it)
            self.batch = int(batch)
        else:
            self.epoch += 1
            self.batch = 0
            self._epoch_np_state = pack_np_state()
            it = iter(self.loader)
        for b in it:
            # count BEFORE yield: a state_dict() taken inside the loop
            # body sees this batch as consumed
            self.batch += 1
            yield b

    def state_dict(self) -> dict:
        st = {"epoch": int(self.epoch), "batch": int(self.batch)}
        if self._epoch_np_state is not None:
            st["np_state"] = dict(self._epoch_np_state)
        return st

    def set_state_dict(self, state):
        self._pending = (state.get("epoch", 0), state.get("batch", 0),
                         state.get("np_state"))
        return self
