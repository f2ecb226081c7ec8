"""Optimizers with Paddle's update rules, learning-rate schedulers
(`optimizer.lr`) and the fused multi-tensor path (`optimizer.fused`).

Port of paddle_tpu/optimizer/__init__.py as subclasses of
`torch.optim.Optimizer`: the base `Optimizer` (parameter groups, the
scheduler, `grad_clip`, regularizers, `state_dict` with structured names,
`minimize`), `Adam`, `AdamW` and `Momentum`, whose updates run on the
card as one hand-written pass over a list of parameters
(ops/fused_optimizer.py, csrc/fused_optimizer.cu), and `SGD`,
`Adagrad`, `DecayedAdagrad`, `Ftrl`, `RMSProp`, `Adadelta`, `Adamax`,
`NAdam`, `RAdam`, `Lamb`, `ASGD`, `Rprop` and `LBFGS`, per parameter in
plain torch (the reference composes them in XLA).

The reference's arithmetic and storage rules, which differ from
`torch.optim`'s:

  * the update is computed in f32 (in the parameter's dtype for f32 and
    f64 parameters); the other optimizers compute in f32 for bf16 and f16
    parameters as well (the reference's f32 learning rate promotes their
    expressions; its per-parameter Momentum rounds each op to bf16
    instead, its fused Momentum does not, and the port takes the fused
    arithmetic for both paths);
  * state is stored in its accumulator dtype — the parameter's dtype
    unless `multi_precision` — so a bf16-decorated model keeps bf16
    moments, rounded after each update, while the step uses the unrounded
    f32 values;
  * f32 master weights exist only under `multi_precision`, for bf16/f16
    parameters; the parameter is then the master rounded;
  * one step count t for all parameters (Adam's bias correction);
    `weight_decay` is a float (L2) or a regularizer (`regularizer.L1Decay`
    / `L2Decay`), per parameter group if a group gives one; Adam's is
    coupled (added to the gradient), AdamW's decoupled (p (1 - lr wd), or
    p - lr wd sign(p) for L1), honouring `apply_decay_param_fun` (called
    with the parameter's name) and `lr_ratio` (called with the
    parameter).

Scalars are rounded to f32 the way the reference's f32 arrays round them,
so a step repeats the reference's bits. `use_multi_tensor=True` makes
Adam, AdamW and Momentum update all their parameters in one launch per
dtype pair (`optimizer.fused`); otherwise each parameter is a launch of
the same pass on a list of one. `lazy_mode` is accepted as the reference
accepts it: there are no sparse gradients, so every row is updated.
`step()` and `clear_grad()` are the Paddle names; a `stop_gradient`
parameter is one with `requires_grad=False`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_optimizer import _f32, comp_dtype as _comp
from ..ops.fused_optimizer import fused_adam, fused_momentum
from ..regularizer import decay_of
from . import lr
from .fused import fused_step, refusal
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "DecayedAdagrad",
           "Ftrl", "RMSProp", "Adadelta", "Adam", "AdamW", "Adamax",
           "NAdam", "RAdam", "Lamb", "ASGD", "Rprop", "LBFGS", "lr"]

_LOW = (torch.float16, torch.bfloat16)


def _wd_grad(wd, base):
    """The coupled penalty gradient: coeff * base (L2) or coeff *
    sign(base) (L1); 0.0 without decay."""
    c, l1 = decay_of(wd)
    if c == 0.0:
        return 0.0
    return c * base.sign() if l1 else c * base


class Optimizer(torch.optim.Optimizer):
    """Base of the Paddle-rule optimizers. `parameters`: tensors, (name,
    tensor) pairs such as `model.named_parameters()`, or parameter groups
    (dicts with "params" and their own "learning_rate" factor and
    "weight_decay"). A parameter's name is what `apply_decay_param_fun`
    receives and what `state_dict` keys by (its position in the list,
    "param_<i>", when none is given). `learning_rate`: a number or an
    `LRScheduler`, read at each step."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError("learning_rate must be a number or an "
                            f"LRScheduler, got {type(learning_rate)}")
        plist = list(parameters)
        groups = plist if plist and isinstance(plist[0], dict) \
            else [{"params": plist}]
        self._names = {}
        torch_groups = []
        for grp in groups:
            ps = []
            for item in grp["params"]:
                pname, p = item if isinstance(item, tuple) \
                    else (f"param_{len(self._names)}", item)
                self._names[p] = pname
                ps.append(p)
            torch_groups.append(dict(grp, params=ps))
        self._parameters = list(self._names)
        self._lr = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._use_multi_tensor = False
        self._step_count = 0
        self._pending = {}     # set_state_dict entries not yet made state
        self._only = None      # minimize(parameters=...)
        super().__init__(torch_groups, {})

    # ------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return self._lr

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = value

    # ----------------------------------------------------------- state
    def _acc_dtype(self, p) -> torch.dtype:
        return torch.float32 if self._has_master(p) else p.dtype

    def _has_master(self, p) -> bool:
        return self._multi_precision and p.dtype in _LOW

    def _acc(self, kind, p, init=None, dtype=None):
        """The parameter's `kind` state, made at first use: zeros of its
        shape in its accumulator dtype, or `init()`, or what
        `set_state_dict` left for it."""
        st = self.state[p]
        if kind not in st:
            dt = dtype or self._acc_dtype(p)
            pend = self._pending.pop(f"{self._names[p]}_{kind}", None)
            if pend is not None:
                t = torch.as_tensor(pend).to(device=p.device, dtype=dt,
                                             copy=True).contiguous()
            elif init is None:
                t = torch.zeros(p.shape, dtype=dt, device=p.device)
            else:
                t = init()
            st[kind] = t
        return st[kind]

    def _master(self, p):
        """The f32 master weight of a bf16/f16 parameter under
        multi_precision (None otherwise), made at first use."""
        if not self._has_master(p):
            return None
        return self._acc("master", p,
                         init=lambda: p.detach().float().contiguous(),
                         dtype=torch.float32)

    def _structured_maps(self, structured_names):
        """(id(param) -> structured key, structured key -> name) for the
        parameters this optimizer owns; `structured_names` is {id(param):
        model-state-dict key}."""
        fwd, inv = {}, {}
        for p in self._parameters:
            sk = structured_names.get(id(p))
            if sk is not None:
                fwd[id(p)] = sk
                inv[sk] = self._names[p]
        return fwd, inv

    def _raw_to_structured(self, key, fwd):
        # longest name first: one name + "_" can prefix another
        for p in sorted(self._parameters, key=lambda q: -len(self._names[q])):
            sk, name = fwd.get(id(p)), self._names[p]
            if sk is not None and key.startswith(name + "_"):
                return f"{sk}@{key[len(name) + 1:]}"
        return key

    def state_dict(self, structured_names=None):
        """State entries key as ``{name}_{kind}`` (kinds: moment1,
        moment2, moment2_max, master, velocity, ...), or as
        ``{structured_key}@{kind}`` for the parameters `structured_names`
        ({id(param): model-state-dict key}) names; "step" is the step
        count and "LR_Scheduler" the scheduler's state."""
        fwd = self._structured_maps(structured_names)[0] \
            if structured_names else {}
        out = {self._raw_to_structured(k, fwd) if fwd else k: v
               for k, v in self._pending.items()}
        for p in self._parameters:
            for kind, t in self.state.get(p, {}).items():
                sk = fwd.get(id(p))
                out[f"{sk}@{kind}" if sk is not None
                    else f"{self._names[p]}_{kind}"] = t
        out["step"] = self._step_count
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state, structured_names=None):
        if structured_names:
            inv = self._structured_maps(structured_names)[1]
            translated = {}
            for k, v in state.items():
                if "@" in k:
                    sk, kind = k.rsplit("@", 1)
                    if sk in inv:
                        translated[f"{inv[sk]}_{kind}"] = v
                        continue
                translated[k] = v
            state = translated
        consumed = set()
        for p in self._parameters:
            for kind, t in self.state.get(p, {}).items():
                k = f"{self._names[p]}_{kind}"
                if k in state:
                    t.copy_(torch.as_tensor(state[k]))
                    consumed.add(k)
        # state not made yet: kept until the parameter's first step
        for k, v in state.items():
            if k not in consumed and k not in ("step", "LR_Scheduler"):
                self._pending[k] = v
        self._step_count = int(state.get("step", self._step_count))
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])

    set_dict = set_state_dict

    # ------------------------------------------------------------ step
    def _collect_params_grads(self):
        """(param, grad, group) of every parameter that takes gradients
        (and, under minimize(parameters=...), is listed)."""
        return [(p, p.grad, grp) for grp in self.param_groups
                for p in grp["params"]
                if p.requires_grad and (self._only is None
                                        or id(p) in self._only)]

    def _fused_ok(self, pgs) -> bool:
        return False

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("step() takes no closure (Paddle semantics; "
                             "LBFGS takes one)")
        pgs = self._collect_params_grads()
        fused = self._use_multi_tensor and self._fused_ok(pgs)
        scale = None
        if self._grad_clip is not None:
            if fused:
                grads = [g for _, g, _ in pgs if g is not None]
                scale = self._grad_clip.scale(grads) if grads else None
            else:
                clipped = self._grad_clip([(p, g) for p, g, _ in pgs])
                pgs = [(p, g2, grp) for (p, _, grp), (_, g2)
                       in zip(pgs, clipped)]
        self._step_count += 1
        lr_val = _f32(self.get_lr())
        items = [(p, g, _f32(_f32(grp["learning_rate"]) * lr_val)
                  if "learning_rate" in grp else lr_val,
                  grp.get("weight_decay", self._weight_decay))
                 for p, g, grp in pgs if g is not None]
        if fused:
            fused_step(self, items, scale)
        else:
            for item in items:
                self._apply_one(*item)

    def _apply_one(self, p, g, lr_val, wd):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        self.zero_grad(set_to_none=not set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """loss.backward(), then a step of the listed `parameters` (all
        when None)."""
        loss.backward()
        self._only = None if parameters is None \
            else {id(p) for p in parameters}
        try:
            self.step()
        finally:
            self._only = None
        return None, None


class _KernelOptimizer(Optimizer):
    """An optimizer whose update is a launch of the fused pass: per
    parameter (a list of one) or, with `use_multi_tensor`, one launch per
    dtype pair (`optimizer.fused`)."""

    def _hparams(self, p, lr_val, wd):
        """(learning rate, decay coefficient, is L1) of parameter p."""
        return (lr_val,) + decay_of(wd)

    def _fused_ok(self, pgs) -> bool:
        return refusal(self, pgs) is None

    def _apply_one(self, p, g, lr_val, wd):
        lr_p, coeff, l1 = self._hparams(p, lr_val, wd)
        self._update_call([p], [g], [lr_p], [coeff], l1, None)()


class Adam(_KernelOptimizer):
    """Adam with Paddle's rule; `weight_decay` is coupled (added to the
    gradient). `amsgrad` keeps moment2_max and divides by its square
    root."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = bool(amsgrad)
        self._lazy_mode = bool(lazy_mode)
        self._decoupled_wd = False
        self._use_multi_tensor = bool(use_multi_tensor)

    def _update_call(self, params, grads, lrs, coeffs, l1, scale):
        """The state of `params` (made now, at the first step), and a
        function that launches their update."""
        ms = [self._acc("moment1", p) for p in params]
        vs = [self._acc("moment2", p) for p in params]
        xs = [self._acc("moment2_max", p) for p in params] \
            if self._amsgrad else None
        masters = [self._master(p) for p in params]
        if all(m is None for m in masters):
            masters = None
        step = self._step_count
        return lambda: fused_adam(
            params, grads, ms, vs, xs, masters, lrs, coeffs,
            beta1=self._beta1, beta2=self._beta2, epsilon=self._epsilon,
            step=step, decoupled=self._decoupled_wd, l1=l1, scale=scale)


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

    def _hparams(self, p, lr_val, wd):
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(self._names[p]):
            wd = 0.0
        if self._lr_ratio is not None:
            lr_val = _f32(lr_val * _f32(self._lr_ratio(p)))
        return super()._hparams(p, lr_val, wd)


class RAdam(Adam):
    """The reference's RAdam is its Adam."""


class Momentum(_KernelOptimizer):
    """SGD with momentum (velocity = mu velocity + g), `use_nesterov`;
    `weight_decay` coupled."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = bool(use_nesterov)
        self._use_multi_tensor = bool(use_multi_tensor)

    def _update_call(self, params, grads, lrs, coeffs, l1, scale):
        vels = [self._acc("velocity", p) for p in params]
        masters = [self._master(p) for p in params]
        if all(m is None for m in masters):
            masters = None
        return lambda: fused_momentum(
            params, grads, vels, masters, lrs, coeffs,
            momentum=self._momentum, nesterov=self._nesterov, l1=l1,
            scale=scale)


# -------------------------------------------- per parameter, plain torch

class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _apply_one(self, p, g, lr_val, wd):
        master = self._master(p)
        base = master if master is not None else p.to(_comp(p.dtype))
        gd = g.to(base.dtype) + _wd_grad(wd, base)
        new = base - lr_val * gd
        if master is not None:
            master.copy_(new)
        p.copy_(new)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _apply_one(self, p, g, lr_val, wd):
        acc = self._acc("moment", p, init=lambda: torch.full(
            p.shape, self._init_acc, dtype=p.dtype, device=p.device))
        c = _comp(p.dtype)
        pc = p.to(c)
        gd = g.to(c) + _wd_grad(wd, pc)
        new_acc = acc.to(c) + gd.square()
        acc.copy_(new_acc)
        p.copy_(pc - lr_val * gd / (new_acc.sqrt() + self._epsilon))


class DecayedAdagrad(Optimizer):
    """Adagrad with an exponentially decayed accumulator: acc = decay acc
    + (1 - decay) g^2."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._decay = decay
        self._epsilon = epsilon

    def _apply_one(self, p, g, lr_val, wd):
        acc = self._acc("moment", p)
        c = _comp(p.dtype)
        pc = p.to(c)
        gd = g.to(c) + _wd_grad(wd, pc)
        new_acc = self._decay * acc.to(c) + (1 - self._decay) * gd.square()
        acc.copy_(new_acc)
        p.copy_(pc - lr_val * gd / (new_acc.sqrt() + self._epsilon))


class Ftrl(Optimizer):
    """FTRL-proximal: a per-coordinate adaptive step with L1 / L2
    proximal regularization."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _apply_one(self, p, g, lr_val, wd):
        sq = self._acc("squared", p)     # n: the sum of g^2
        lin = self._acc("linear", p)     # z
        c = _comp(p.dtype)
        pc, sqc = p.to(c), sq.to(c)
        gd = g.to(c) + _wd_grad(wd, pc)
        new_sq = sqc + gd.square()
        lp = self._lr_power
        sigma = (new_sq.pow(-lp) - sqc.pow(-lp)) / lr_val
        new_lin = lin.to(c) + gd - sigma * pc
        sq.copy_(new_sq)
        lin.copy_(new_lin)
        quad = new_sq.pow(-lp) / lr_val + 2.0 * self._l2
        pre = new_lin.clamp(-self._l1, self._l1) - new_lin
        p.copy_(torch.where(new_lin.abs() > self._l1, pre / quad,
                            torch.zeros_like(pc)))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _apply_one(self, p, g, lr_val, wd):
        ms = self._acc("mean_square", p)
        mom = self._acc("momentum", p)
        c = _comp(p.dtype)
        pc = p.to(c)
        gd = g.to(c) + _wd_grad(wd, pc)
        new_ms = self._rho * ms.to(c) + (1 - self._rho) * gd.square()
        ms.copy_(new_ms)
        denom = new_ms
        if self._centered:
            mg = self._acc("mean_grad", p)
            new_mg = self._rho * mg.to(c) + (1 - self._rho) * gd
            mg.copy_(new_mg)
            denom = new_ms - new_mg.square()
        upd = self._momentum * mom.to(c) \
            + lr_val * gd / (denom + self._epsilon).sqrt()
        mom.copy_(upd)
        p.copy_(pc - upd)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _apply_one(self, p, g, lr_val, wd):
        avg_sq = self._acc("avg_squared_grad", p)
        avg_upd = self._acc("avg_squared_update", p)
        c = _comp(p.dtype)
        pc = p.to(c)
        gd = g.to(c) + _wd_grad(wd, pc)
        new_sq = self._rho * avg_sq.to(c) + (1 - self._rho) * gd.square()
        upd = (avg_upd.to(c) + self._epsilon).sqrt() \
            / (new_sq + self._epsilon).sqrt() * gd
        new_upd = self._rho * avg_upd.to(c) + (1 - self._rho) * upd.square()
        avg_sq.copy_(new_sq)
        avg_upd.copy_(new_upd)
        p.copy_(pc - lr_val * upd)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _apply_one(self, p, g, lr_val, wd):
        m = self._acc("moment", p)
        u = self._acc("inf_norm", p)
        c = _comp(p.dtype)
        pc = p.to(c)
        gd = g.to(c) + _wd_grad(wd, pc)
        new_m = self._beta1 * m.to(c) + (1 - self._beta1) * gd
        new_u = torch.maximum(self._beta2 * u.to(c), gd.abs())
        m.copy_(new_m)
        u.copy_(new_u)
        t = np.float32(self._step_count)
        lr_t = float(np.float32(lr_val)
                     / (np.float32(1) - np.float32(self._beta1) ** t))
        p.copy_(pc - lr_t * new_m / (new_u + self._epsilon))


class NAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._momentum_decay = momentum_decay

    def _apply_one(self, p, g, lr_val, wd):
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        # the cumulative product of mu (a scalar per parameter)
        mu_prod = self._acc("mu_product", p, init=lambda: torch.ones(
            (), dtype=torch.float32, device=p.device), dtype=torch.float32)
        c = _comp(p.dtype)
        pc = p.to(c)
        gd = g.to(c) + _wd_grad(wd, pc)
        t = np.float32(self._step_count)
        b1, b2, md = self._beta1, self._beta2, self._momentum_decay
        f32 = np.float32
        mu_t = f32(b1) * (f32(1) - f32(0.5) * f32(0.96) ** (t * f32(md)))
        mu_t1 = f32(b1) * (f32(1) - f32(0.5) * f32(0.96)
                           ** ((t + f32(1)) * f32(md)))
        new_mu_prod = mu_prod * float(mu_t)
        mu_prod.copy_(new_mu_prod)
        new_m = b1 * m.to(c) + (1 - b1) * gd
        new_v = b2 * v.to(c) + (1 - b2) * gd.square()
        m.copy_(new_m)
        v.copy_(new_v)
        mhat = (float(mu_t1) * new_m / (1 - new_mu_prod * float(mu_t1))
                + float(f32(1) - mu_t) * gd / (1 - new_mu_prod))
        vhat = new_v / float(f32(1) - f32(b2) ** t)
        p.copy_(pc - lr_val * mhat / (vhat.sqrt() + self._epsilon))


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _apply_one(self, p, g, lr_val, wd):
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        gd = g.float()
        t = np.float32(self._step_count)
        b1, b2 = self._beta1, self._beta2
        new_m = b1 * m.float() + (1 - b1) * gd
        new_v = b2 * v.float() + (1 - b2) * gd.square()
        m.copy_(new_m)
        v.copy_(new_v)
        mhat = new_m / float(np.float32(1) - np.float32(b1) ** t)
        vhat = new_v / float(np.float32(1) - np.float32(b2) ** t)
        r = mhat / (vhat.sqrt() + self._epsilon)
        wd_c = 0.0 if (self._exclude_fn is not None
                       and self._exclude_fn(p)) else self._wd
        base = p.float()
        upd = r + wd_c * base
        wnorm = base.square().sum().sqrt()
        unorm = upd.square().sum().sqrt()
        trust = torch.where((wnorm > 0) & (unorm > 0), wnorm / unorm,
                            torch.ones_like(wnorm))
        p.copy_(base - lr_val * trust * upd)


class ASGD(Optimizer):
    """Averaged SGD: the update uses the running mean of the last
    `batch_num` gradients."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        if batch_num <= 0:
            raise ValueError("batch_num must be positive")
        self._n = int(batch_num)

    def _apply_one(self, p, g, lr_val, wd):
        c = _comp(p.dtype)
        pc = p.to(c)
        gd = g.to(c) + _wd_grad(wd, pc)
        d = self._acc("d", p)                      # running mean of grads
        step = self._acc("step", p, init=lambda: torch.zeros(
            (), dtype=torch.float32, device=p.device), dtype=torch.float32)
        if self._n > 1:
            ys = self._acc("ys", p, init=lambda: torch.zeros(
                (self._n,) + tuple(p.shape), dtype=p.dtype, device=p.device))
            slot = int(step.item()) % self._n
            new_d = d.to(c) + (gd - ys[slot].to(c)) / self._n
            ys[slot] = gd
        else:
            new_d = gd
        d.copy_(new_d)
        step.add_(1)
        p.copy_(pc - lr_val * new_d)


class Rprop(Optimizer):
    """Resilient backprop: sign-based per-element step sizes, grown on
    sign agreement and shrunk on sign flips (flipped entries skip the
    update that round)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas
        self._init_step = learning_rate

    def _apply_one(self, p, g, lr_val, wd):
        c = _comp(p.dtype)
        gd = g.to(c)
        prev = self._acc("prev_grad", p)
        steps = self._acc("steps", p, init=lambda: torch.full(
            p.shape, self._init_step, dtype=torch.float32, device=p.device),
            dtype=torch.float32)
        sign = (gd * prev.to(c)).sign()
        new_steps = torch.where(
            sign > 0, (steps * self._eta_pos).clamp(max=self._lr_max),
            torch.where(sign < 0,
                        (steps * self._eta_neg).clamp(min=self._lr_min),
                        steps))
        eff = torch.where(sign < 0, torch.zeros_like(gd), gd)
        p.copy_(p.to(c) - eff.sign() * new_steps)
        steps.copy_(new_steps)
        prev.copy_(eff)


class LBFGS(Optimizer):
    """Limited-memory BFGS: the two-loop recursion over an (s, y) history;
    `step(closure)` re-runs the closure, which returns the loss (the
    optimizer runs its backward). line_search_fn='strong_wolfe' is
    approximated with Armijo backtracking, as the reference does."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._max_eval = max_eval or max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = int(history_size)
        self._line_search = line_search_fn
        self._s, self._y = [], []

    def _gather(self):
        return torch.cat([p.detach().float().reshape(-1)
                          for p in self._parameters])

    def _gather_grad(self):
        return torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).float().reshape(-1)
                          for p in self._parameters])

    def _scatter(self, flat):
        i = 0
        for p in self._parameters:
            n = p.numel()
            p.copy_(flat[i:i + n].view(p.shape))
            i += n

    def _direction(self, grad):
        q = grad
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / (torch.dot(y, s) + 1e-10)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y) / (torch.dot(y, y) + 1e-10))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return -q

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that recomputes "
                             "the loss")

        def eval_closure():
            self.clear_grad()
            with torch.enable_grad():
                loss = closure()
                loss.backward()
            return float(loss)

        loss = eval_closure()
        evals = 1
        for _ in range(self._max_iter):
            flat = self._gather()
            grad = self._gather_grad()
            if float(grad.abs().max()) <= self._tol_grad:
                break
            d = self._direction(grad)
            t = float(_f32(self.get_lr()))
            if self._line_search is not None:
                gtd = float(torch.dot(grad, d))
                ok = False
                for _bt in range(10):  # Armijo backtracking
                    self._scatter(flat + t * d)
                    new_loss = eval_closure()
                    evals += 1
                    if new_loss <= loss + 1e-4 * t * gtd:
                        ok = True
                        break
                    t *= 0.5
                if not ok:
                    self._scatter(flat)
                    eval_closure()
                    break
            else:
                self._scatter(flat + t * d)
                new_loss = eval_closure()
                evals += 1
            new_grad = self._gather_grad()
            s = t * d
            y = new_grad - grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
            if abs(new_loss - loss) < self._tol_change:
                loss = new_loss
                break
            loss = new_loss
            if evals >= self._max_eval:
                break
        return loss
