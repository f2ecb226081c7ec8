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
(`adam_scalars`, `decay_coeffs`).

Per-step scalars on the device. A captured CUDA graph replays its
kernels' arguments as they were at the capture, so the values that
change from step to step are read from device memory, as the
reference's compiled steps read its `_step_t` and `_lr_t` arrays: the
base learning rate `lr` (a one-element f32 tensor, the optimizer's
`_lr_t`) and Adam's bias corrections `bc` (two f32, 1 - beta1^t and
1 - beta2^t, which `bias_corrections` computes from the step count on
the device). Each tensor's learning rate is `lr * f1 * f2`, rounded to
f32 after each product (f1: its group's factor, f2: AdamW's lr_ratio;
`lrs` entries are floats (f1 = the value, f2 = 1) or (f1, f2) pairs),
and AdamW's decoupled decay value is derived from it in f32 (1 - lr *
coeff, or lr * coeff for L1), in the kernel and in the plain version
alike. Without `lr` the base is 1, so float `lrs` are the learning
rates, and an int `step` gives the bias corrections. Moments are stored in their own dtype
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
    """Adam's constant scalars in the compute dtype's precision: beta1,
    1 - beta1, beta2, 1 - beta2 and eps (Python doubles, rounded to f32
    for an f32 compute type). The bias corrections change every step and
    are read on the device (`bias_corrections`)."""
    b1: float
    omb1: float
    b2: float
    omb2: float
    eps: float


def adam_scalars(beta1, beta2, epsilon, comp) -> AdamScalars:
    cast = float if comp == torch.float64 else _f32
    return AdamScalars(cast(beta1), cast(1 - beta1), cast(beta2),
                       cast(1 - beta2), cast(epsilon))


def decay_coeffs(coeffs, decoupled, comp) -> list:
    """Each tensor's decay coefficient as the kernel takes it: coupled,
    in the compute dtype's precision; decoupled, rounded to f32 (the
    kernel derives 1 - lr * coeff, or lr * coeff, in f32 from the device
    learning rate)."""
    cast = _f32 if decoupled or comp != torch.float64 else float
    return [cast(c) for c in coeffs]


def bias_corrections(betas, step) -> torch.Tensor:
    """[1 - beta1^t, 1 - beta2^t] in f32 on the betas' device: `betas` is
    a two-f32 tensor [beta1, beta2] (`betas_tensor`), t the step count (an
    int, or the optimizer's f32 `_step_t` on the device, read there). f32
    powers of f32 betas, as the reference's f32 step array gives them;
    scalar f32 `pow` on the CPU is correctly rounded, as numpy's is."""
    t = step if isinstance(step, torch.Tensor) else torch.tensor(
        float(step), dtype=torch.float32, device=betas.device)
    return torch.stack([1 - betas[0] ** t, 1 - betas[1] ** t])


def betas_tensor(beta1, beta2, device) -> torch.Tensor:
    return torch.tensor([_f32(beta1), _f32(beta2)], dtype=torch.float32,
                        device=device)


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


def _factors(entry):
    """(f1, f2) of one `lrs` entry, each rounded to f32."""
    f1, f2 = entry if isinstance(entry, tuple) else (entry, 1.0)
    return _f32(f1), _f32(f2)


_ONES: dict = {}


def _base_lr(lr, device) -> torch.Tensor:
    """The base learning rate as a one-element f32 tensor on `device`:
    `lr`, or 1 when None (float `lrs` are then the learning rates)."""
    if lr is not None:
        return lr
    one = _ONES.get(device)
    if one is None:
        one = _ONES[device] = torch.ones(1, dtype=torch.float32,
                                         device=device)
    return one


def _lr_of(base, entry):
    """Tensor i's learning rate, an f32 0-dim tensor on the device: base
    * f1 * f2, rounded after each product (the kernel's order)."""
    f1, f2 = _factors(entry)
    return base.reshape(()) * f1 * f2


def _decay_of(lr_i, coeff, decoupled, l1, comp):
    """The decay value the update reads: coupled, the coefficient in the
    compute dtype's precision (a Python float); decoupled L2, 1 - lr *
    coeff; decoupled L1, lr * coeff (f32 0-dim tensors, from the device
    learning rate)."""
    if not decoupled:
        return (float if comp == torch.float64 else _f32)(coeff)
    lc = lr_i * _f32(coeff)
    return lc if l1 else 1 - lc


def fused_adam_reference(params, grads, moment1, moment2, moment2_max,
                         masters, lrs, coeffs, *, beta1, beta2, epsilon,
                         step=None, decoupled, l1=False, scale=None,
                         lr=None, bc=None):
    """The plain version of `fused_adam`: for each tensor, the
    per-parameter torch ops in the kernel's order, in place. Reads the
    learning rate and bias corrections on the device, as the kernel."""
    if not params:
        return
    dev = params[0].device
    base = _base_lr(lr, dev)
    if bc is None:
        bc = bias_corrections(betas_tensor(beta1, beta2, dev), step)
    for i, p in enumerate(params):
        master = masters[i] if masters is not None else None
        w = master if master is not None else p
        comp = comp_dtype(w.dtype)
        h = adam_scalars(beta1, beta2, epsilon, comp)
        lr_i = _lr_of(base, lrs[i])
        wd = _decay_of(lr_i, coeffs[i], decoupled, l1, comp)
        g = grads[i] if scale is None else _scaled(grads[i], scale)
        gd = g.to(comp)
        bw = w.to(comp)
        if not decoupled and wd:
            gd = gd + (bw.sign() * wd if l1 else bw * wd)
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
        upd = new_m / bc[0] * lr_i / (_sqrt(vv / bc[1]) + h.eps)
        neww = bw
        if decoupled:
            neww = neww - neww.sign() * wd if l1 else neww * wd
        new = neww - upd
        if master is not None:
            master.copy_(new)
        p.copy_(new)


def fused_momentum_reference(params, grads, velocities, masters, lrs,
                             coeffs, *, momentum, nesterov=False, l1=False,
                             scale=None, lr=None):
    """The plain version of `fused_momentum`: for each tensor, the
    per-parameter torch ops in the kernel's order, in place."""
    if not params:
        return
    base = _base_lr(lr, params[0].device)
    for i, p in enumerate(params):
        master = masters[i] if masters is not None else None
        w = master if master is not None else p
        comp = comp_dtype(w.dtype)
        cast = float if comp == torch.float64 else _f32
        mu, wd = cast(momentum), cast(coeffs[i])
        lr_i = _lr_of(base, lrs[i])
        g = grads[i] if scale is None else _scaled(grads[i], scale)
        gd = g.to(comp)
        bw = w.to(comp)
        if wd:
            gd = gd + (bw.sign() * wd if l1 else bw * wd)
        vel = velocities[i].to(comp) * mu + gd
        velocities[i].copy_(vel)
        upd = gd + vel * mu if nesterov else vel
        new = bw - upd * lr_i
        if master is not None:
            master.copy_(new)
        p.copy_(new)


# ------------------------------------------------------------- wrappers

def _check(name, params, grads, states, masters, scale, lr, bc):
    """The kernel's terms: one (parameter, state) dtype pair of PAIRS for
    the list, gradients of the parameter's dtype, every tensor contiguous
    and of its parameter's size, f32 master weights beside 2-byte
    parameters only, a one-element f32 scale and learning rate and two
    f32 bias corrections."""
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
    if lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError(f"{name}: the learning rate is one f32 value")
    if bc is not None and (bc.dtype != torch.float32 or bc.numel() != 2
                           or not bc.is_contiguous()):
        raise ValueError(f"{name}: the bias corrections are two f32")


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


def _lr_arrays(lrs, idx):
    """The (f1, f2) factors of the tensors `idx` as two C float arrays."""
    fs = [_factors(lrs[i]) for i in idx]
    return ((ctypes.c_float * len(idx))(*[f[0] for f in fs]),
            (ctypes.c_float * len(idx))(*[f[1] for f in fs]))


def fused_adam(params, grads, moment1, moment2, moment2_max, masters, lrs,
               coeffs, *, beta1, beta2, epsilon, step=None, decoupled,
               l1=False, scale=None, lr=None, bc=None):
    """One Adam / AdamW step over a list of parameters, in place.

    `moment2_max` (amsgrad) and `masters` (f32 master weights, entries
    None where a parameter has none) may be None. `lrs` gives each
    tensor's learning-rate factors over the base `lr` (see the module
    note) and `coeffs` its decay coefficient; `decoupled` chooses AdamW's
    decay, `l1` the L1 kind; `bc` the bias corrections on the device
    (`bias_corrections`), or `step`, an int, makes them; `scale` an
    optional one-element f32 clip scale on the parameters' device,
    applied to every gradient. CPU tensors take `fused_adam_reference`;
    CUDA tensors of one dtype pair launch the kernel."""
    kw = dict(beta1=beta1, beta2=beta2, epsilon=epsilon, step=step,
              decoupled=decoupled, l1=l1, scale=scale, lr=lr, bc=bc)
    states = [moment1, moment2] + ([moment2_max] if moment2_max else [])
    every = [*params, *grads, *(t for s in states for t in s),
             *(m for m in masters or () if m is not None)]
    if not params or _plain(_ADAM, *every, scale, lr, bc):
        return fused_adam_reference(params, grads, moment1, moment2,
                                    moment2_max, masters, lrs, coeffs, **kw)
    dev = params[0].device
    lr = _base_lr(lr, dev)
    if bc is None:
        bc = bias_corrections(betas_tensor(beta1, beta2, dev), step)
    _check(_ADAM, params, grads, states, masters, scale, lr, bc)
    comp = comp_dtype(params[0].dtype)
    h = adam_scalars(beta1, beta2, epsilon, comp)
    wds = decay_coeffs(coeffs, decoupled, comp)
    fn = _entry(_ADAM, [ctypes.c_int] + [_P] * 10 + [ctypes.c_int] * 4
                + [ctypes.c_double] * 5 + [_P] * 4)
    stream = current_stream(dev)
    for idx in _batches(params):
        pick = lambda xs: [xs[i] for i in idx]   # noqa: E731
        code = fn(len(idx), _ptrs(pick(params)), _ptrs(pick(grads)),
                  _ptrs(pick(moment1)), _ptrs(pick(moment2)),
                  _ptrs(pick(moment2_max)) if moment2_max else None,
                  _ptrs(pick(masters)) if masters is not None else None,
                  (ctypes.c_longlong * len(idx))(
                      *[params[i].numel() for i in idx]),
                  *_lr_arrays(lrs, idx),
                  (ctypes.c_double * len(idx))(*pick(wds)),
                  _DTYPES[params[0].dtype], _DTYPES[moment1[0].dtype],
                  int(decoupled), int(l1), *h, lr.data_ptr(),
                  bc.data_ptr(), None if scale is None else scale.data_ptr(),
                  stream)
        check_launch(_ADAM, code)
        state = (*pick(params), *pick(moment1), *pick(moment2),
                 *(pick(moment2_max) if moment2_max else ()),
                 *(pick(masters) if masters else ()))
        # read p, g and the state; write p and the state; 15 operations
        # an element
        count_launch(_ADAM, reads=(*pick(grads), *state, lr, bc, scale),
                     writes=state,
                     flops=15 * sum(params[i].numel() for i in idx))


def fused_momentum(params, grads, velocities, masters, lrs, coeffs, *,
                   momentum, nesterov=False, l1=False, scale=None, lr=None):
    """One Momentum step over a list of parameters, in place: the terms of
    `fused_adam`, with the velocities as the one state. CPU tensors take
    `fused_momentum_reference`; CUDA tensors of one dtype pair launch the
    kernel."""
    kw = dict(momentum=momentum, nesterov=nesterov, l1=l1, scale=scale,
              lr=lr)
    every = [*params, *grads, *velocities,
             *(m for m in masters or () if m is not None)]
    if not params or _plain(_MOMENTUM, *every, scale, lr):
        return fused_momentum_reference(params, grads, velocities, masters,
                                        lrs, coeffs, **kw)
    dev = params[0].device
    lr = _base_lr(lr, dev)
    _check(_MOMENTUM, params, grads, [velocities], masters, scale, lr, None)
    comp = comp_dtype(params[0].dtype)
    cast = float if comp == torch.float64 else _f32
    wds = decay_coeffs(coeffs, False, comp)
    fn = _entry(_MOMENTUM, [ctypes.c_int] + [_P] * 8 + [ctypes.c_int] * 4
                + [ctypes.c_double, _P, _P, _P])
    stream = current_stream(dev)
    for idx in _batches(params):
        pick = lambda xs: [xs[i] for i in idx]   # noqa: E731
        code = fn(len(idx), _ptrs(pick(params)), _ptrs(pick(grads)),
                  _ptrs(pick(velocities)),
                  _ptrs(pick(masters)) if masters is not None else None,
                  (ctypes.c_longlong * len(idx))(
                      *[params[i].numel() for i in idx]),
                  *_lr_arrays(lrs, idx),
                  (ctypes.c_double * len(idx))(*pick(wds)),
                  _DTYPES[params[0].dtype], _DTYPES[velocities[0].dtype],
                  int(l1), int(nesterov), cast(momentum), lr.data_ptr(),
                  None if scale is None else scale.data_ptr(), stream)
        check_launch(_MOMENTUM, code)
        state = (*pick(params), *pick(velocities),
                 *(pick(masters) if masters else ()))
        count_launch(_MOMENTUM, reads=(*pick(grads), *state, lr, scale),
                     writes=state,
                     flops=7 * sum(params[i].numel() for i in idx))
