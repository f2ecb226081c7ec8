"""The port's op table, gradients (CPU).

For every differentiable row of `paddle_tpu_torch/ops/op_table*.py`: the
fp32 gradient of `out.sum()` (torch autograd through the port's op)
against central differences through the same op in float64, probing at
most four elements per input (eps 1e-3, rtol 5e-2, atol 5e-3: the
discipline of `tests/test_op_table_sweep.py`); and the bf16 gradients
within 8e-2 of the fp32 ones. An input the output does not depend on has
no gradient in torch (None, where the reference's tape gives zeros): it
is held to the numeric gradient as zeros. The same fp32 gradients against
paddle_tpu's tape, which also decides ties and kinks that central
differences cannot see, are in test_torch_op_table_tape_{a,b}.py.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.ops import op_table

op_table.ensure_populated()

DIFF = sorted(n for n, s in op_table.OPS.items() if s.diff)
DIFF_BF16 = [n for n in DIFF if op_table.OPS[n].bf16]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = port_device._current
    pt.set_device("cpu")
    yield
    port_device._current = prev


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def _grads(spec, arrays, dtype=None):
    skip = set(spec.int_inputs) | set(spec.no_grad_inputs)
    ts = []
    for i, a in enumerate(arrays):
        t = pt.to_tensor(a)
        if dtype is not None and i not in spec.int_inputs:
            t = t.astype(dtype)
        if i not in skip:
            t.stop_gradient = False
        ts.append(t)
    _first(spec.fn(*ts, **spec.kwargs)).sum().backward()
    out = []
    for i, t in enumerate(ts):
        if i in skip:
            continue
        g = t.grad
        out.append(np.zeros(t.shape) if g is None
                   else g.numpy().astype("float64"))
    return out


def _sum64(spec, arrays):
    ts = [pt.to_tensor(a) if i in spec.int_inputs
          else pt.to_tensor(a.astype("float64"), dtype="float64")
          for i, a in enumerate(arrays)]
    out = _first(spec.fn(*ts, **spec.kwargs))
    return float(out._data.detach().double().sum())


@pytest.mark.parametrize("name", DIFF)
def test_grad_fp32_matches_central_differences(name):
    spec = op_table.OPS[name]
    arrays = spec.sample_inputs(seed=1)
    grads = iter(_grads(spec, arrays))
    skip = set(spec.int_inputs) | set(spec.no_grad_inputs)
    eps, checked = 1e-3, 0
    for i in range(len(arrays)):
        if i in skip:
            continue
        ga = next(grads).reshape(-1)
        flat = arrays[i].reshape(-1)
        for j in range(0, flat.size, max(flat.size // 4, 1)):
            plus = [a.copy() for a in arrays]
            minus = [a.copy() for a in arrays]
            plus[i] = plus[i].astype("float64")
            minus[i] = minus[i].astype("float64")
            plus[i].reshape(-1)[j] += eps
            minus[i].reshape(-1)[j] -= eps
            num = (_sum64(spec, plus) - _sum64(spec, minus)) / (2 * eps)
            np.testing.assert_allclose(ga[j], num, rtol=5e-2, atol=5e-3,
                                       err_msg=f"{name} input {i} el {j}")
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("name", DIFF_BF16)
def test_grad_bf16_tracks_fp32(name):
    spec = op_table.OPS[name]
    arrays = spec.sample_inputs(seed=3)
    for g32, gb in zip(_grads(spec, arrays), _grads(spec, arrays,
                                                     "bfloat16")):
        np.testing.assert_allclose(gb, g32, rtol=8e-2, atol=8e-2,
                                   err_msg=name)


def test_grads_keep_the_input_dtype():
    """bf16 inputs get bf16 gradients (no silent f32 promotion)."""
    x = pt.to_tensor(np.ones((2, 3), "float32")).astype("bfloat16")
    x.stop_gradient = False
    (pt.exp(x) * 2).sum().backward()
    assert x.grad.dtype == torch.bfloat16
