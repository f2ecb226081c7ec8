"""fleet.utils — activation recompute (gradient checkpointing).

Port of paddle_tpu/distributed/fleet/utils/__init__.py: `recompute` and
`_resolve_remat_policy`. The reference runs the block under `jax.vjp` of
`jax.checkpoint` (with a policy) or re-traces it at backward time; the
port's form is `torch.utils.checkpoint.checkpoint(use_reentrant=False)`,
whose backward re-runs the block's forward, and a policy is a
selective-checkpoint policy over the dispatcher ops the block runs
(`create_selective_checkpoint_contexts`). The block's second forward runs
under the first's AMP state (`amp.amp_state_guard`), as the reference's
PyLayer context saves it: torch's checkpoint restores only
`torch.autocast`'s state.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ....amp import amp_state, amp_state_guard
from ....core.tensor import Tensor

__all__ = ["recompute"]

#: 2-D matrix products with no batch dimension: the counterpart of
#: jax's dots_with_no_batch_dims_saveable (aten.bmm is a batched product)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _is_diff(t) -> bool:
    """Whether t (a torch tensor or the Tensor API's Tensor, a Parameter
    among them) is a floating tensor that requires grad."""
    if isinstance(t, Tensor):
        t = t._data
    return (isinstance(t, torch.Tensor) and t.requires_grad
            and (t.is_floating_point() or t.is_complex()))


def _save_only(ops):
    """A policy that keeps the outputs of `ops` and recomputes the rest."""

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _resolve_remat_policy(policy):
    """Map a policy spec to a selective-checkpoint policy function
    `(ctx, op, *args, **kwargs) -> CheckpointPolicy`. Strings name the
    reference's curated policies; a callable passes through as such a
    function (the port's form of a jax.checkpoint_policies callable).

    "flash_resident": the flash forward op's outputs (o and lse,
    `ops.flash_attention.FLASH_RESIDUAL_OPS`) stay resident; everything
    else (the q/k/v/o and MLP GEMMs, norms, rotary, residual adds) is
    recomputed in the backward, which so never runs the forward flash
    kernel again. "nothing": save nothing. "dots": save the outputs of
    the 2-D matrix products (aten.mm, aten.addmm; not aten.bmm)."""
    if callable(policy):
        return policy
    if policy == "flash_resident":
        from ....ops.flash_attention import FLASH_RESIDUAL_OPS

        return _save_only(FLASH_RESIDUAL_OPS)
    if policy == "nothing":
        return _save_only(())
    if policy == "dots":
        return _save_only(_DOT_OPS)
    raise ValueError(
        f"unknown recompute policy {policy!r}; expected 'flash_resident', "
        "'nothing', 'dots' or a selective-checkpoint policy callable")


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              policy=None, **kwargs):
    """Run `function(*args, **kwargs)` keeping none of its activations for
    the backward (or, with `policy`, only those the policy saves); the
    backward runs the forward again to get them back.

    With grad disabled, or when no argument, keyword argument or
    `function.parameters()` (torch tensors or the Tensor API's Tensors
    and Parameters) is a floating tensor that requires grad, it
    is `function(*args, **kwargs)` itself. Otherwise it is
    `torch.utils.checkpoint.checkpoint(use_reentrant=False)`.
    `use_reentrant` is accepted and ignored, as the reference ignores it.
    `preserve_rng_state` rewinds the default CPU and CUDA generators for
    the second forward, so dropout draws the same masks there (the port's
    `dropout` and `fused_dropout_add` with `generator=None`); an explicit
    `torch.Generator` passed into the region is not rewound. `policy` is a
    name or callable for `_resolve_remat_policy`."""
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    params = (list(function.parameters()) if hasattr(function, "parameters")
              else [])
    if not any(_is_diff(t) for t in (*args, *kwargs.values(), *params)):
        return function(*args, **kwargs)
    state = amp_state()

    def block(*a, **k):
        with amp_state_guard(state):
            return function(*a, **k)

    extra = {}
    if policy is not None:
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            _resolve_remat_policy(policy))
    return checkpoint(block, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra,
                      **kwargs)
