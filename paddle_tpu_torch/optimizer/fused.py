"""The fused multi-tensor path of Adam / AdamW and Momentum
(`use_multi_tensor=True`).

Port of paddle_tpu/optimizer/fused.py. The reference compiles one XLA
program over the whole (params, grads, moments) pytree, with global-norm
clipping inside it and the buffers donated. Here the update of every
parameter of one (parameter, state) dtype pair is one launch of the
hand-written pass (ops/fused_optimizer.py `fused_adam`,
`fused_momentum`): GPT under O2, whose LayerNorm weights stay f32, makes
two. A `ClipGradByGlobalNorm` gives the launches its scale, a one-element
tensor on the card, instead of a clipped copy of each gradient.

The path computes what the per-parameter path computes, bit for bit: the
same per-tensor learning rate and decay (the optimizer's `_hparams`) and
the same arithmetic. It refuses, as the reference's does, and the step
then takes the per-parameter path: a clip that is not global-norm, an L1
regularizer, a mix of parameters with and without master weights
(`refusal`).

The reference's `_guarded_update` commits an update's donated results in
a `finally`, so that an interrupt between the update and the commit
cannot leave the optimizer's state pointing at deleted buffers. Here the
launches write the parameters, moments and master weights in place, so
there is no result to commit and that contract holds by construction;
what is left is a step of several launches, and once the first is issued
the others follow in a `finally` (`_launch_all`).
"""
from __future__ import annotations

from ..nn.clip import ClipGradByGlobalNorm
from ..regularizer import decay_of

#: test seam: called after a step's first launch, before the others
#: (tests raise KeyboardInterrupt here to show the step still completes)
_interrupt_test_hook = None


def refusal(opt, pgs):
    """Why this step cannot take the fused path (a string), or None.
    `pgs` are the step's (param, grad, group) triples."""
    clip = opt._grad_clip
    if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
        return "a clip that is not global-norm"
    live = [(p, grp) for p, g, grp in pgs if g is not None]
    if any(decay_of(grp.get("weight_decay", opt._weight_decay))[1]
           for _, grp in live):
        return "an L1 regularizer"
    if len({opt._has_master(p) for p, _ in live}) > 1:
        return "parameters with and without master weights"
    return None


def _launch_all(calls):
    """Issue every launch of a step; after the first, the rest run in a
    `finally`."""
    if not calls:
        return
    calls[0]()
    try:
        if _interrupt_test_hook is not None:
            _interrupt_test_hook()
    finally:
        for call in calls[1:]:
            call()


def fused_step(opt, items, scale):
    """One update of every (param, grad, lr, weight_decay) in `items`:
    a launch per (device, parameter dtype, state dtype), each over its
    parameters in order, with the clip `scale` (or None)."""
    groups = {}
    for it in items:
        p = it[0]
        groups.setdefault((p.device, p.dtype, opt._acc_dtype(p)),
                          []).append(it)
    calls = []
    for grp in groups.values():
        hp = [opt._hparams(p, lr, wd) for p, _, lr, wd in grp]
        calls.append(opt._update_call(
            [it[0] for it in grp], [it[1] for it in grp],
            [h[0] for h in hp], [h[1] for h in hp], False, scale))
    _launch_all(calls)
