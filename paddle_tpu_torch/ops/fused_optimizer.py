"""The fused multi-tensor Adam / AdamW and Momentum updates: the
hand-written CUDA pass (csrc/fused_optimizer.cu), its plain PyTorch
versions, and the host-side scalars both take.

The reference runs these updates as XLA compositions, one jitted program
over the whole parameter list (paddle_tpu/optimizer/fused.py
`fused_adam_step` :104, `fused_momentum_step` :222) or one fused
expression per parameter (`Adam._apply_one`, `Momentum._apply_one` in
paddle_tpu/optimizer/__init__.py). The port's optimizers
(`paddle_tpu_torch.optimizer`) call `fused_adam` / `fused_momentum` on a
list of parameters of one (parameter, moment) dtype pair: the whole list
under `use_multi_tensor=True`, a list of one otherwise. Each call on CUDA
tensors is one launch (two past `MAX_TENSORS` tensors, and so on), counted
under its entry's name. CPU tensors take the plain versions
(`fused_adam_reference`, `fused_momentum_reference`), loops of the
per-parameter torch ops, which the kernel repeats op for op: on the card
the two give the same bits. There is no fallback: CUDA tensors launch the
kernel or raise.

The update is in place: parameters, moments and master weights are
written where they lie, so an update needs no commit step.

Arithmetic (both versions): the compute type is f32 for f32, bf16 and
f16 parameters (the master weight's when there is one) and f64 for f64;
the scalars are rounded as the reference's f32 arrays round them
(`adam_scalars`, `decay_values`). Moments are stored in their own dtype
(the parameter's, or f32 under multi_precision); the step uses the
unrounded values. Scalar divisions divide by a 0-dim tensor, so they are
true divisions on the card as on the CPU (torch turns a division by a
Python number on a CUDA tensor into a multiplication by its reciprocal),
and square roots are correctly rounded on both (`_sqrt`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ._cuda_common import (check_launch, count_launch, current_stream,
                           kernel_library)
from .fused_norm import _plain

_ADAM = "fused_adam"
_MOMENTUM = "fused_momentum"
#: tensors a launch takes (kMaxTensors in the source); a longer list
#: takes a launch per MAX_TENSORS
MAX_TENSORS = 384
_LOW = (torch.float16, torch.bfloat16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           torch.float64: 3}
#: (parameter dtype, moment dtype) pairs the kernel takes
PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.float16, torch.float16),
         (torch.float16, torch.float32), (torch.float64, torch.float64)}


def _f32(x) -> float:
    """x rounded to f32, as a Python float."""
    return float(np.float32(x))


def comp_dtype(dtype) -> torch.dtype:
    """The update's compute dtype for a weight (master or parameter) of
    `dtype`: f32 for f32, bf16 and f16, f64 for f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class AdamScalars(NamedTuple):
    """Adam's per-step scalars in the compute dtype's precision: beta1,
    1 - beta1, beta2, 1 - beta2 and eps (Python doubles, rounded to f32
    for an f32 compute type), and the bias corrections 1 - beta^t from f32
    powers of the step count."""
    b1: float
    omb1: float
    b2: float
    omb2: float
    bc1: float
    bc2: float
    eps: float


def adam_scalars(beta1, beta2, epsilon, step, comp) -> AdamScalars:
    cast = float if comp == torch.float64 else _f32
    t = np.float32(step)
    bc1 = float(np.float32(1) - np.float32(beta1) ** t)
    bc2 = float(np.float32(1) - np.float32(beta2) ** t)
    return AdamScalars(cast(beta1), cast(1 - beta1), cast(beta2),
                       cast(1 - beta2), bc1, bc2, cast(epsilon))


def decay_values(lrs, coeffs, decoupled, l1, comp) -> list:
    """The per-tensor decay value the update reads: coupled, the
    coefficient (in the compute dtype's precision); decoupled L2, the
    shrink 1 - lr * coeff; decoupled L1, lr * coeff (both in f32, as the
    reference's f32 learning rate makes them)."""
    cast = float if comp == torch.float64 else _f32
    if not decoupled:
        return [cast(c) for c in coeffs]
    if l1:
        return [_f32(lr * _f32(c)) for lr, c in zip(lrs, coeffs)]
    return [_f32(1.0 - _f32(lr * _f32(c))) for lr, c in zip(lrs, coeffs)]


def _scaled(g, scale):
    """g * scale, computed in f32 (f64 for f64) and rounded to g's dtype:
    the gradient a clip scale leaves."""
    return (g.to(comp_dtype(g.dtype)) * scale).to(g.dtype)


def _sqrt(x):
    """The correctly rounded square root (IEEE's, the kernel's
    `__fsqrt_rn`, XLA's): torch's vectorized CPU sqrt misses it by an ulp
    for a few inputs in a thousand, so an f32 root is taken in f64 and
    rounded once (exact for f32: 53 >= 2 * 24 + 2 bits)."""
    if x.dtype == torch.float32:
        return x.double().sqrt().float()
    return x.sqrt()


def _div(x, value):
    """x / value, a true division on every device (value as a 0-dim
    tensor of x's dtype)."""
    return x / torch.full((), value, dtype=x.dtype, device=x.device)


def fused_adam_reference(params, grads, moment1, moment2, moment2_max,
                         masters, lrs, coeffs, *, beta1, beta2, epsilon,
                         step, decoupled, l1=False, scale=None):
    """The plain version of `fused_adam`: for each tensor, the
    per-parameter torch ops in the kernel's order, in place."""
    for i, p in enumerate(params):
        master = masters[i] if masters is not None else None
        base = master if master is not None else p
        comp = comp_dtype(base.dtype)
        h = adam_scalars(beta1, beta2, epsilon, step, comp)
        wd = decay_values([lrs[i]], [coeffs[i]], decoupled, l1, comp)[0]
        g = grads[i] if scale is None else _scaled(grads[i], scale)
        gd = g.to(comp)
        bc = base.to(comp)
        if not decoupled and wd:
            gd = gd + (bc.sign() * wd if l1 else bc * wd)
        m, v = moment1[i], moment2[i]
        new_m = m.to(comp) * h.b1 + gd * h.omb1
        new_v = v.to(comp) * h.b2 + gd.square() * h.omb2
        # the moments stay in their dtype; the step uses the unrounded ones
        m.copy_(new_m)
        v.copy_(new_v)
        vv = new_v
        if moment2_max is not None:
            x = moment2_max[i]
            vv = torch.maximum(x.to(comp), new_v)
            x.copy_(vv)
        upd = _div(new_m, h.bc1) * lrs[i] / (_sqrt(_div(vv, h.bc2)) + h.eps)
        newb = bc
        if decoupled:
            newb = newb - newb.sign() * wd if l1 else newb * wd
        new = newb - upd
        if master is not None:
            master.copy_(new)
        p.copy_(new)


def fused_momentum_reference(params, grads, velocities, masters, lrs,
                             coeffs, *, momentum, nesterov=False, l1=False,
                             scale=None):
    """The plain version of `fused_momentum`: for each tensor, the
    per-parameter torch ops in the kernel's order, in place."""
    for i, p in enumerate(params):
        master = masters[i] if masters is not None else None
        base = master if master is not None else p
        comp = comp_dtype(base.dtype)
        cast = float if comp == torch.float64 else _f32
        mu, wd = cast(momentum), cast(coeffs[i])
        g = grads[i] if scale is None else _scaled(grads[i], scale)
        gd = g.to(comp)
        bc = base.to(comp)
        if wd:
            gd = gd + (bc.sign() * wd if l1 else bc * wd)
        vel = velocities[i].to(comp) * mu + gd
        velocities[i].copy_(vel)
        upd = gd + vel * mu if nesterov else vel
        new = bc - upd * lrs[i]
        if master is not None:
            master.copy_(new)
        p.copy_(new)


# ------------------------------------------------------------- wrappers

def _check(name, params, grads, states, masters, scale):
    """The kernel's terms: one (parameter, state) dtype pair of PAIRS for
    the list, gradients of the parameter's dtype, every tensor contiguous
    and of its parameter's size, f32 master weights beside 2-byte
    parameters only, a one-element f32 scale."""
    pd, sd = params[0].dtype, states[0][0].dtype
    if (pd, sd) not in PAIRS:
        raise ValueError(f"{name}: parameter dtype {pd} with state dtype "
                         f"{sd}; the kernel takes {sorted(map(str, PAIRS))}")
    for i, p in enumerate(params):
        group = [grads[i]] + [s[i] for s in states]
        if masters is not None and masters[i] is not None:
            if masters[i].dtype != torch.float32 or pd not in _LOW:
                raise ValueError(f"{name}: f32 master weights beside "
                                 "bfloat16 or float16 parameters only")
            group.append(masters[i])
        if p.dtype != pd or grads[i].dtype != pd \
                or any(s[i].dtype != sd for s in states):
            raise ValueError(f"{name} takes one dtype pair a call: "
                             f"parameters and gradients {pd}, state {sd}")
        if any(t.numel() != p.numel() for t in group):
            raise ValueError(f"{name}: tensor {i}'s state or gradient "
                             "differs in size from its parameter")
        if not all(t.is_contiguous() for t in [p] + group):
            raise ValueError(f"{name} needs contiguous tensors")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != 1):
        raise ValueError(f"{name}: the clip scale is one f32 value")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


_ENTRIES: dict = {}


def _entry(name, argtypes):
    """The C entry `name`, bound once (a step calls it once a parameter
    on the per-parameter path)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(kernel_library(name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


_P = ctypes.c_void_p


def _batches(params):
    """Indices of the non-empty tensors, in batches of MAX_TENSORS."""
    live = [i for i, p in enumerate(params) if p.numel()]
    return [live[k:k + MAX_TENSORS] for k in range(0, len(live),
                                                   MAX_TENSORS)]


def fused_adam(params, grads, moment1, moment2, moment2_max, masters, lrs,
               coeffs, *, beta1, beta2, epsilon, step, decoupled, l1=False,
               scale=None):
    """One Adam / AdamW step over a list of parameters, in place.

    `moment2_max` (amsgrad) and `masters` (f32 master weights, entries
    None where a parameter has none) may be None. `lrs` and `coeffs` are
    each tensor's f32 learning rate and decay coefficient; `decoupled`
    chooses AdamW's decay, `l1` the L1 kind; `step` is the step count of
    the bias corrections; `scale` an optional one-element f32 clip scale
    on the parameters' device, applied to every gradient. CPU tensors
    take `fused_adam_reference`; CUDA tensors of one dtype pair launch
    the kernel."""
    kw = dict(beta1=beta1, beta2=beta2, epsilon=epsilon, step=step,
              decoupled=decoupled, l1=l1, scale=scale)
    states = [moment1, moment2] + ([moment2_max] if moment2_max else [])
    every = [*params, *grads, *(t for s in states for t in s),
             *(m for m in masters or () if m is not None)]
    if not params or _plain(_ADAM, *every, scale):
        return fused_adam_reference(params, grads, moment1, moment2,
                                    moment2_max, masters, lrs, coeffs, **kw)
    _check(_ADAM, params, grads, states, masters, scale)
    comp = comp_dtype(params[0].dtype)
    h = adam_scalars(beta1, beta2, epsilon, step, comp)
    wds = decay_values(lrs, coeffs, decoupled, l1, comp)
    fn = _entry(_ADAM, [ctypes.c_int] + [_P] * 9 + [ctypes.c_int] * 4
                + [ctypes.c_double] * 7 + [_P, _P])
    stream = current_stream(params[0].device)
    for idx in _batches(params):
        pick = lambda xs: [xs[i] for i in idx]   # noqa: E731
        code = fn(len(idx), _ptrs(pick(params)), _ptrs(pick(grads)),
                  _ptrs(pick(moment1)), _ptrs(pick(moment2)),
                  _ptrs(pick(moment2_max)) if moment2_max else None,
                  _ptrs(pick(masters)) if masters is not None else None,
                  (ctypes.c_longlong * len(idx))(
                      *[params[i].numel() for i in idx]),
                  (ctypes.c_double * len(idx))(*pick(lrs)),
                  (ctypes.c_double * len(idx))(*pick(wds)),
                  _DTYPES[params[0].dtype], _DTYPES[moment1[0].dtype],
                  int(decoupled), int(l1), *h,
                  None if scale is None else scale.data_ptr(), stream)
        check_launch(_ADAM, code)
        count_launch(_ADAM)


def fused_momentum(params, grads, velocities, masters, lrs, coeffs, *,
                   momentum, nesterov=False, l1=False, scale=None):
    """One Momentum step over a list of parameters, in place: the terms of
    `fused_adam`, with the velocities as the one state. CPU tensors take
    `fused_momentum_reference`; CUDA tensors of one dtype pair launch the
    kernel."""
    kw = dict(momentum=momentum, nesterov=nesterov, l1=l1, scale=scale)
    every = [*params, *grads, *velocities,
             *(m for m in masters or () if m is not None)]
    if not params or _plain(_MOMENTUM, *every, scale):
        return fused_momentum_reference(params, grads, velocities, masters,
                                        lrs, coeffs, **kw)
    _check(_MOMENTUM, params, grads, [velocities], masters, scale)
    comp = comp_dtype(params[0].dtype)
    cast = float if comp == torch.float64 else _f32
    wds = [cast(c) for c in coeffs]
    fn = _entry(_MOMENTUM, [ctypes.c_int] + [_P] * 7 + [ctypes.c_int] * 4
                + [ctypes.c_double, _P, _P])
    stream = current_stream(params[0].device)
    for idx in _batches(params):
        pick = lambda xs: [xs[i] for i in idx]   # noqa: E731
        code = fn(len(idx), _ptrs(pick(params)), _ptrs(pick(grads)),
                  _ptrs(pick(velocities)),
                  _ptrs(pick(masters)) if masters is not None else None,
                  (ctypes.c_longlong * len(idx))(
                      *[params[i].numel() for i in idx]),
                  (ctypes.c_double * len(idx))(*pick(lrs)),
                  (ctypes.c_double * len(idx))(*pick(wds)),
                  _DTYPES[params[0].dtype], _DTYPES[velocities[0].dtype],
                  int(l1), int(nesterov), cast(momentum),
                  None if scale is None else scale.data_ptr(), stream)
        check_launch(_MOMENTUM, code)
        count_launch(_MOMENTUM)
