"""Shared body of tests/test_torch_int_promotion_{a,b}.py (F10, ROADMAP.md
Queue 3): every one-input row of the port's op table on int64 and int32
inputs of the row's shape, held to paddle_tpu's dtype, shape and value
wherever the reference returns one (jnp's promotion under x64). The rows
are split over two files so that `--dist loadfile` spreads them.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.ops import op_table as ref_table
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.ops import op_table as port_table

ref_table.ensure_populated()
port_table.ensure_populated()

ONE_INPUT = sorted(n for n, s in port_table.OPS.items() if s.n_inputs == 1)
HALF = len(ONE_INPUT) // 2


def on_cpu_with_the_reference_tape():
    """Generator body of the files' module fixture."""
    prev = port_device._current
    pt.set_device("cpu")
    old = ref.get_flags(["FLAGS_eager_defer_vjp"])
    ref.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    ref.set_flags(old)
    port_device._current = prev


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def check_row(name):
    """Row `name` on int64 and int32 inputs: where the reference returns
    a value the port returns one of its dtype, shape and value (where
    the reference raises, as jax's lax functions do on integers, the row
    skips)."""
    spec, rspec = port_table.OPS[name], ref_table.OPS[name]
    checked = 0
    for dt in ("int64", "int32"):
        a = np.random.RandomState(0).randint(0, 5, spec.shape).astype(dt)
        try:
            want = _first(rspec.fn(ref.to_tensor(a), **rspec.kwargs))
        except Exception:
            continue
        got = _first(spec.fn(pt.to_tensor(a), **spec.kwargs))
        assert str(got.dtype) == np.dtype(want.dtype).name, (
            dt, got.dtype, want.dtype)
        assert got.shape == list(want.shape), dt
        np.testing.assert_allclose(got.numpy().astype("float64"),
                                   np.asarray(want._data).astype("float64"),
                                   rtol=1e-5, atol=1e-6, equal_nan=True)
        checked += 1
    if checked == 0:
        pytest.skip(f"{name}: the reference raises on integer input")
