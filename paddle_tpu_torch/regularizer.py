"""Weight-decay regularizers: `L1Decay`, `L2Decay`.

Port of paddle_tpu/regularizer.py. An optimizer's `weight_decay` (or a
parameter group's) takes one of these or a float (L2). The penalty is
folded into the optimizer's update, not run as a separate pass: coupled
decay adds coeff * param (L2) or coeff * sign(param) (L1) to the
gradient; AdamW's decoupled decay shrinks the weight by lr * coeff (L2)
or subtracts lr * coeff * sign(weight) (L1).
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    _kind = "l2"

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """L1 weight decay: grad += coeff * sign(param)."""
    _kind = "l1"


class L2Decay(WeightDecayRegularizer):
    """L2 weight decay: grad += coeff * param."""
    _kind = "l2"


def decay_of(weight_decay) -> tuple:
    """(coefficient, is L1) of an optimizer's `weight_decay`: None, a
    float (L2) or a regularizer (the reference's objects too, which carry
    the same `_coeff` and `_kind`)."""
    if weight_decay is None:
        return 0.0, False
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay), False
    return (float(getattr(weight_decay, "_coeff", 0.0)),
            getattr(weight_decay, "_kind", "l2") == "l1")
