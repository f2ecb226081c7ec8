"""Optimizers with Paddle's update rules: `Optimizer`, `Adam`, `AdamW`.

Port of paddle_tpu/optimizer/__init__.py (`Optimizer`, `Adam`, `AdamW`)
as subclasses of `torch.optim.Optimizer`, with the reference's arithmetic
and storage rules, which differ from `torch.optim.AdamW`'s:

  * the update is computed in f32 (in the parameter's dtype for f32 and
    f64 parameters);
  * the moments are stored in their accumulator dtype — the parameter's
    dtype unless `multi_precision` — so a bf16-decorated model keeps bf16
    moments, rounded after each update, while the step uses the unrounded
    f32 values;
  * f32 master weights exist only under `multi_precision`, for bf16/f16
    parameters; the parameter is then the master rounded;
  * bias correction uses the optimizer's step count t (one count for all
    parameters); AdamW decays decoupled, new = p (1 - lr wd) - lr m^ /
    (sqrt(v^) + eps), honouring `apply_decay_param_fun` (called with the
    parameter's name) and `lr_ratio` (called with the parameter).

Scalars are rounded to f32 the way the reference's f32 arrays round them,
so a step repeats the reference's bits. `step()` and `clear_grad()` are the
Paddle names. Not ported yet: learning-rate schedulers and `grad_clip`
(ROADMAP Queue 1 item 1, the next training slice).
"""
from __future__ import annotations

import numpy as np
import torch

_LOW = (torch.float16, torch.bfloat16)


def _f32(x) -> float:
    """x rounded to f32, as a Python float."""
    return float(np.float32(x))


class Optimizer(torch.optim.Optimizer):
    """Base of the Paddle-rule optimizers. `parameters`: tensors, or
    (name, tensor) pairs such as `model.named_parameters()`. A parameter's
    name is what `apply_decay_param_fun` receives (its position in the
    list, "param_<i>", when none is given)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet (ROADMAP "
                "Queue 1 item 1, the next training slice); pass a number")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP Queue 1 item 1, "
                "the next training slice)")
        self._names = {}
        for i, item in enumerate(parameters):
            pname, p = item if isinstance(item, tuple) else (f"param_{i}",
                                                             item)
            self._names[p] = pname
        self._lr = float(learning_rate)
        self._weight_decay = weight_decay
        self._multi_precision = bool(multi_precision)
        self._step_count = 0
        super().__init__(list(self._names), {})

    def get_lr(self) -> float:
        return self._lr

    def _state_of(self, p):
        """The parameter's moments (in their accumulator dtype) and, under
        multi_precision for a bf16/f16 parameter, its f32 master weight,
        made at first use."""
        st = self.state[p]
        if not st:
            low = self._multi_precision and p.dtype in _LOW
            acc = torch.float32 if low else p.dtype
            st["moment1"] = torch.zeros_like(p, dtype=acc)
            st["moment2"] = torch.zeros_like(p, dtype=acc)
            if low:
                st["master"] = p.detach().float()
        return st

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("step() takes no closure (Paddle semantics)")
        self._step_count += 1
        lr = _f32(self._lr)
        for p in self._names:
            if p.grad is not None:
                self._apply_one(p, p.grad, lr, self._weight_decay)

    def _apply_one(self, p, g, lr_val, wd):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        self.zero_grad(set_to_none=not set_to_zero)


def _wd_coeff(wd) -> float:
    if wd is None:
        return 0.0
    if isinstance(wd, (int, float)):
        return float(wd)
    raise NotImplementedError(
        "regularizer objects as weight_decay are not ported yet (ROADMAP "
        "Queue 1 item 1, the next training slice); pass a float")


class Adam(Optimizer):
    """Adam with Paddle's rule; `weight_decay` is coupled L2 (added to the
    gradient)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        if amsgrad:
            raise NotImplementedError(
                "amsgrad is not ported yet (ROADMAP Queue 1 item 1, the "
                "next training slice)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._decoupled_wd = False

    def _apply_one(self, p, g, lr_val, wd):
        st = self._state_of(p)
        m, v = st["moment1"], st["moment2"]
        master = st.get("master")
        base = master if master is not None else p
        comp = torch.float32 if base.dtype in _LOW else base.dtype
        gd = g.to(comp)
        coeff = _wd_coeff(wd)
        if not self._decoupled_wd and coeff:
            gd = gd + base.to(comp) * coeff
        b1, b2 = self._beta1, self._beta2
        new_m = m.to(comp) * b1 + gd * (1 - b1)
        new_v = v.to(comp) * b2 + gd.square() * (1 - b2)
        # the moments stay in their accumulator dtype; the step uses the
        # unrounded values
        m.copy_(new_m)
        v.copy_(new_v)
        t = np.float32(self._step_count)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        step = (new_m / bc1) * lr_val / ((new_v / bc2).sqrt() + self._epsilon)
        newb = base.to(comp)
        if self._decoupled_wd:
            newb = newb * _f32(1.0 - _f32(lr_val * _f32(coeff)))
        new = newb - step
        if master is not None:
            master.copy_(new)
        p.copy_(new)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01), Paddle's rule."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         use_multi_tensor=use_multi_tensor, amsgrad=amsgrad)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _apply_one(self, p, g, lr_val, wd):
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(self._names[p]):
            wd = 0.0
        if self._lr_ratio is not None:
            lr_val = _f32(lr_val * _f32(self._lr_ratio(p)))
        super()._apply_one(p, g, lr_val, wd)
