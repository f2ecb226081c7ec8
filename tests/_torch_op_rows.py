"""Shared body of tests/test_torch_op_table.py and _nn.py: a row's copied
`OpSpec` fields against the reference's, its fp32 forward against
paddle_tpu's output and the row's numpy `ref` at the row's tolerance
(dtype, shape and stop_gradient too), and its bf16 forward against the
port's own fp32 at 5e-2, as `tests/test_op_table_sweep.py` holds the
reference.
"""
import numpy as np

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.ops import op_table as ref_table
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.ops import op_table as port_table

ref_table.ensure_populated()
port_table.ensure_populated()

FIELDS = ("n_inputs", "diff", "domain", "domains", "int_inputs",
          "no_grad_inputs", "shape", "shapes", "kwargs", "rtol", "atol",
          "bf16", "int_high", "tags")


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def _port(spec, arrays, bf16=False):
    ts = []
    for i, a in enumerate(arrays):
        t = pt.to_tensor(a)
        ts.append(t.astype("bfloat16") if bf16 and i not in spec.int_inputs
                  else t)
    return _first(spec.fn(*ts, **spec.kwargs))


def _f64(t):
    return t.numpy().astype("float64")


def check_spec_copy(name):
    mine, theirs = port_table.OPS[name], ref_table.OPS[name]
    for f in FIELDS:
        assert getattr(mine, f) == getattr(theirs, f), f
    assert (mine.ref is None) == (theirs.ref is None)
    a, b = mine.sample_inputs(seed=0), theirs.sample_inputs(seed=0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if mine.ref is not None:
        np.testing.assert_array_equal(np.asarray(mine.ref(*a)),
                                      np.asarray(theirs.ref(*b)))


def check_forward_fp32(name):
    spec = port_table.OPS[name]
    arrays = spec.sample_inputs(seed=0)
    out = _port(spec, arrays)
    rspec = ref_table.OPS[name]
    want = _first(rspec.fn(*[ref.to_tensor(a) for a in arrays],
                           **rspec.kwargs))
    assert dtype_name(out.dtype) == np.dtype(want.dtype).name
    assert out.shape == list(want.shape)
    assert out.stop_gradient == want.stop_gradient
    np.testing.assert_allclose(_f64(out),
                               np.asarray(want._data).astype("float64"),
                               rtol=spec.rtol, atol=spec.atol,
                               equal_nan=True)
    if spec.ref is None:
        assert np.isfinite(_f64(out)).all() or out.dtype == pt.bool
    else:
        np.testing.assert_allclose(
            _f64(out), np.asarray(spec.ref(*arrays)).astype("float64"),
            rtol=spec.rtol, atol=spec.atol)


def check_forward_bf16(name):
    spec = port_table.OPS[name]
    arrays = spec.sample_inputs(seed=2)
    out32 = _port(spec, arrays)
    outb = _port(spec, arrays, bf16=True)
    np.testing.assert_allclose(_f64(outb), _f64(out32), rtol=5e-2,
                               atol=5e-2)
