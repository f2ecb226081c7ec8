"""Shared body of tests/test_torch_op_table_tape_{a,b}.py: a row's fp32
gradient of `out.sum()` from the port's tape against paddle_tpu's tape on
the same seeded inputs (the rows that reach nn.functional in
test_torch_op_table_tape_nn.py). The reference's tape runs with
`FLAGS_eager_defer_vjp=False` (its deferred-VJP pass reads a removed
`jax.core.Var`). The rows are split over two files so that
`--dist loadfile` spreads them; the reference's tape takes about 0.2 s a
row on one CPU worker.
"""
import numpy as np

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.ops import op_table as ref_table
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.ops import op_table as port_table

ref_table.ensure_populated()
port_table.ensure_populated()

DIFF = sorted(n for n, s in port_table.OPS.items()
              if s.diff and n not in port_table.NN_ROWS)
HALF = len(DIFF) // 2
#: the rows that reach nn.functional, in a file of their own
DIFF_NN = sorted(n for n in port_table.NN_ROWS if port_table.OPS[n].diff)


def on_cpu_with_the_reference_tape():
    """Generator body of the files' module fixture."""
    prev = port_device._current
    pt.set_device("cpu")
    old = ref.get_flags(["FLAGS_eager_defer_vjp"])
    ref.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    ref.set_flags(old)
    port_device._current = prev


def _grads(pkg, spec, arrays):
    skip = set(spec.int_inputs) | set(spec.no_grad_inputs)
    ts = [pkg.to_tensor(a, stop_gradient=i in skip)
          for i, a in enumerate(arrays)]
    out = spec.fn(*ts, **spec.kwargs)
    if isinstance(out, (list, tuple)):
        out = out[0]
    out.sum().backward()
    return [None if t.grad is None else t.grad.numpy().astype("float64")
            for i, t in enumerate(ts) if i not in skip]


def check_row(name):
    """The port's tape gradient of row `name` equals the reference's at
    the sweep's tolerances (rtol 5e-2, atol 5e-3). An input the output
    does not use has torch's None gradient: it is held to the
    reference's as zeros."""
    arrays = port_table.OPS[name].sample_inputs(seed=1)
    mine = _grads(pt, port_table.OPS[name], [a.copy() for a in arrays])
    theirs = _grads(ref, ref_table.OPS[name], [a.copy() for a in arrays])
    assert len(mine) == len(theirs) > 0
    for i, (m, r) in enumerate(zip(mine, theirs)):
        assert r is not None, f"{name}: the reference gives input {i} none"
        m = np.zeros_like(r) if m is None else m
        assert m.shape == r.shape, (name, i)
        np.testing.assert_allclose(m, r, rtol=5e-2, atol=5e-3,
                                   err_msg=f"{name} input {i}")
