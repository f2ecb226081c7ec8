"""paddle_tpu_torch.ckpt — crash-consistent checkpointing +
preemption-safe resume.

Port of paddle_tpu/ckpt, the same names, manifest and behaviour, so a
checkpoint written by either package restores in the other.

  * **core**        atomic, checksummed checkpoints: shards + manifest
    into a temp dir, fsync, atomic rename to ``step_N/``, ``latest``
    pointer last — restore verifies sha256s and FALLS BACK to the last
    good checkpoint with a named reason.
  * **async_saver** device→host copy synchronous, serialize+IO on a
    background thread with bounded in-flight saves, ``wait``/``abort``
    barriers, retry + exponential backoff.
  * **train_state** one capture covering params, optimizer slots, step,
    the RNG streams, LR schedule, data-iterator position — resume is
    bitwise.
  * **data**        :class:`ResumableLoader` position tracking.

``hapi.callbacks.CheckpointCallback`` drives this from ``Model.fit``
(periodic async saves + SIGTERM-triggered final synchronous save).
Sharded leaves wait for the distributed entry (``ShardedLeaf``,
``manifest_shardings`` raise NotImplementedError).
"""
from __future__ import annotations

from .async_saver import AsyncCheckpointer
from .core import (CheckpointError, CheckpointNotFoundError,
                   CheckpointSaveError, RestoreResult, ShardedLeaf,
                   atomic_write_bytes, atomic_write_stream, clean_debris,
                   gc_checkpoints, host_copy, latest_pointer,
                   list_checkpoints, manifest_shardings,
                   restore_checkpoint, save_checkpoint, step_dir_name,
                   verify_checkpoint)
from .data import ResumableLoader
from .train_state import (capture_train_state, pack_np_state,
                          restore_train_state, unpack_np_state)

__all__ = [
    "save_checkpoint", "restore_checkpoint", "verify_checkpoint",
    "list_checkpoints", "latest_pointer", "gc_checkpoints",
    "clean_debris", "atomic_write_bytes", "atomic_write_stream",
    "host_copy", "step_dir_name", "manifest_shardings", "ShardedLeaf",
    "RestoreResult", "CheckpointError", "CheckpointSaveError",
    "CheckpointNotFoundError",
    "AsyncCheckpointer",
    "capture_train_state", "restore_train_state",
    "pack_np_state", "unpack_np_state",
    "ResumableLoader",
]
