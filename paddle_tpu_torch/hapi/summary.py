"""paddle.summary / paddle.flops.

Port of paddle_tpu/hapi/summary.py: summary() runs a forward pass with
synthetic inputs (zeros on the network's device), collecting per-layer
output shapes and parameter counts through forward hooks; flops()
estimates multiply-adds for the common layer types.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor


def _make_input(input_size, dtype="float32", device=None):
    if isinstance(input_size, (list, tuple)) and input_size and \
            isinstance(input_size[0], (list, tuple)):
        return [_make_input(s, dtype, device) for s in input_size]
    shape = [1 if d is None or d == -1 else int(d) for d in input_size]
    return Tensor._wrap(torch.from_numpy(np.zeros(shape, dtype)).to(device))


def _device_of(net):
    for p in net.parameters():
        return p._data.device
    return None


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer table; returns {'total_params', 'trainable_params'}."""
    records = []
    hooks = []

    def mk_hook(name, layer):
        def hook(lyr, ins, out):
            shape = tuple(out.shape) \
                if isinstance(out, (Tensor, torch.Tensor)) else \
                tuple(out[0].shape) if isinstance(out, (list, tuple)) \
                and out else ()
            n = sum(int(np.prod(p.shape)) for p in lyr.parameters(include_sublayers=False))
            records.append((f"{type(lyr).__name__}-{len(records)}", shape, n))
        return layer.register_forward_post_hook(hook)

    for name, layer in net.named_sublayers():
        if not list(layer.children()):  # leaves only
            hooks.append(mk_hook(name, layer))

    x = input if input is not None else _make_input(
        input_size, (dtypes or ["float32"])[0] if isinstance(dtypes, list)
        else (dtypes or "float32"), _device_of(net))
    try:
        net.eval()
        net(*x) if isinstance(x, list) else net(x)
    finally:
        for h in hooks:
            h.remove()

    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if not p.stop_gradient)
    width = max([len(r[0]) for r in records] + [14]) + 2
    lines = [f"{'Layer (type)':<{width}}{'Output Shape':<24}{'Param #':>12}",
             "=" * (width + 36)]
    for name, shape, n in records:
        lines.append(f"{name:<{width}}{str(shape):<24}{n:>12,}")
    lines.append("=" * (width + 36))
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Estimated forward FLOPs (multiply-adds x2) via per-layer hooks."""
    total = [0]
    custom_ops = custom_ops or {}
    hooks = []

    def count(layer, ins, out):
        t = type(layer)
        name = t.__name__
        if t in custom_ops:
            total[0] += int(custom_ops[t](layer, ins, out))
            return
        x = ins[0] if isinstance(ins, tuple) else ins
        oshape = out.shape if isinstance(out, (Tensor, torch.Tensor)) \
            else None
        if name == "Linear":
            total[0] += 2 * int(np.prod(x.shape)) * layer.weight.shape[-1]
        elif name in ("Conv2D", "Conv1D", "Conv3D"):
            k = int(np.prod(layer.weight.shape[1:]))
            total[0] += 2 * k * int(np.prod(oshape))
        elif name == "Embedding":
            pass  # lookup, no FLOPs
        elif hasattr(layer, "weight") and isinstance(getattr(layer, "weight", None), Tensor):
            total[0] += 2 * int(np.prod(x.shape))

    for _name, layer in net.named_sublayers():
        if not list(layer.children()):
            hooks.append(layer.register_forward_post_hook(count))
    try:
        net.eval()
        net(_make_input(input_size, device=_device_of(net)))
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]
