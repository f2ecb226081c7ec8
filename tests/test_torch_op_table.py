"""The port's op table held to paddle_tpu's, forward (CPU).

`paddle_tpu_torch/ops/op_table*.py` copies the 313 rows of paddle_tpu's op
table whose callables reach only the ops and core modules the port has;
the other 105 are listed in `DEFERRED` with the ROADMAP.md item that
ports them. Here: the copy's every field equals the reference's `OpSpec`,
the names partition the reference's, and each row's fp32 forward on the
same seeded numpy inputs equals paddle_tpu's output and the row's numpy
`ref` at the row's tolerance (dtype, shape and stop_gradient too); the
bf16 forward is held to the port's own fp32 at 5e-2, as
`tests/test_op_table_sweep.py` holds the reference. Gradients are in
`test_torch_op_table_grad.py`.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.ops import op_table as ref_table
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.ops import op_table as port_table

ref_table.ensure_populated()
port_table.ensure_populated()

ROWS = sorted(port_table.OPS)
BF16 = [n for n in ROWS if port_table.OPS[n].bf16]
FIELDS = ("n_inputs", "diff", "domain", "domains", "int_inputs",
          "no_grad_inputs", "shape", "shapes", "kwargs", "rtol", "atol",
          "bf16", "int_high", "tags")


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = port_device._current
    pt.set_device("cpu")
    yield
    port_device._current = prev


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


def test_names_partition_the_reference_table():
    ported, deferred = set(port_table.OPS), set(port_table.DEFERRED)
    assert len(ported) == 313 and len(deferred) == 105
    assert not ported & deferred
    assert ported | deferred == set(ref_table.OPS)
    assert set(port_table.DEFERRED.values()) == {"1e", "1f"}


@pytest.mark.parametrize("name", ROWS)
def test_spec_copy_equals_reference(name):
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


@pytest.mark.parametrize("name", ROWS)
def test_forward_fp32_matches_reference(name):
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


@pytest.mark.parametrize("name", BF16)
def test_forward_bf16_tracks_fp32(name):
    spec = port_table.OPS[name]
    arrays = spec.sample_inputs(seed=2)
    out32 = _port(spec, arrays)
    outb = _port(spec, arrays, bf16=True)
    np.testing.assert_allclose(_f64(outb), _f64(out32), rtol=5e-2,
                               atol=5e-2)
