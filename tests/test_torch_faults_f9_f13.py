"""The repairs of the port's faults F9-F13 (ROADMAP.md Queue 3), each held
to paddle_tpu on the same numpy inputs (CPU).

  * F9: AMP casts the tensors an op takes in a list (`concat`, `stack`,
    `add_n`, ...), as the reference unpacks them into its operands: at O1
    and O2 with bf16 every list op's result dtype is the reference's.
  * F10: integer inputs promote as the reference's (jnp under x64): the
    ops that raised on integers return its values and dtypes, and an
    arithmetic operator's Python int beside an integer Tensor is an int64
    operand, as the reference's `_ensure` makes it (`int8 + 300` is int64
    [301, 302]). The sweep over every one-input row of the op table is in
    test_torch_int_promotion_{a,b}.py.
  * F11: `clip(x)` with neither bound returns x.
  * F12: `linalg.lstsq` returns jnp's residuals at every shape and rank.
  * F13: dtypes print and compare as the reference's numpy dtypes.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.core import dtype as port_dtypes


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = port_device._current
    pt.set_device("cpu")
    yield
    port_device._current = prev


def _name(dt):
    return str(dt)


# ------------------------------------------------------------------ F9
def _list_ops(pkg):
    la = pkg.linalg
    return {
        "concat": lambda xs: pkg.concat(xs),
        "stack": lambda xs: pkg.stack(xs),
        "add_n": lambda xs: pkg.add_n(xs),
        "hstack": lambda xs: pkg.hstack(xs),
        "vstack": lambda xs: pkg.vstack(xs),
        "column_stack": lambda xs: pkg.column_stack(xs),
        "row_stack": lambda xs: pkg.row_stack(xs),
        "broadcast_tensors": lambda xs: pkg.broadcast_tensors(xs)[0],
        "multi_dot": lambda xs: la.multi_dot(xs),
        "block_diag": lambda xs: pkg.block_diag(xs),
    }


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", sorted(_list_ops(pt)))
def test_f9_list_operands_take_the_amp_cast(name, level):
    arrays = [np.random.RandomState(i).rand(4, 4).astype("float32")
              for i in range(3)]
    outs = []
    for pkg in (ref, pt):
        xs = [pkg.to_tensor(a) for a in arrays]
        with pkg.amp.auto_cast(enable=True, level=level, dtype="bfloat16"):
            outs.append(_list_ops(pkg)[name](xs))
    want, got = outs
    assert _name(got.dtype) == np.dtype(want.dtype).name, (got.dtype,
                                                            want.dtype)
    np.testing.assert_allclose(got.numpy().astype("float64"),
                               np.asarray(want._data).astype("float64"),
                               rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------------ F10
def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


@pytest.mark.parametrize("opname", ["std", "var", "nanmean", "frexp"])
@pytest.mark.parametrize("dt", ["int64", "int32"])
def test_f10_ops_that_raised_on_integers(opname, dt):
    a = np.arange(6).reshape(2, 3).astype(dt)
    want = _first(getattr(ref, opname)(ref.to_tensor(a)))
    got = _first(getattr(pt, opname)(pt.to_tensor(a)))
    assert _name(got.dtype) == np.dtype(want.dtype).name
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6)


@pytest.mark.parametrize("dt", ["int64", "int32", "int16", "int8", "uint8"])
def test_f10_python_int_beside_an_integer_tensor(dt):
    """An operator's Python int is an int64 operand (`int8 + 300` is int64
    [301, 302], `int32 * 2` int64), the functional op keeps the Tensor's
    dtype, and a Python float gives float32, in both packages."""
    for pkg in (ref, pt):
        x = pkg.to_tensor([1, 2], dtype=dt)
        for y, want, vals in ((x + 300, "int64", [301, 302]),
                              (3 - x, "int64", [2, 1]),
                              (x * 2, "int64", [2, 4]),
                              (pkg.add(x, 3), dt, [4, 5]),
                              (x * 0.5, "float32", [0.5, 1.0])):
            assert _name(y.dtype) == want, (pkg.__name__, y.dtype, want)
            np.testing.assert_array_equal(np.asarray(y.numpy()), vals)


# ------------------------------------------------------------------ F11
@pytest.mark.parametrize("dt", ["float32", "int64"])
def test_f11_clip_with_neither_bound_returns_x(dt):
    a = np.array([1, 5, 9], dt)
    want = ref.clip(ref.to_tensor(a))
    got = pt.clip(pt.to_tensor(a))
    assert _name(got.dtype) == np.dtype(want.dtype).name
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


# ------------------------------------------------------------------ F12
@pytest.mark.parametrize("xs,ys", [((4, 4), (4, 2)), ((3, 5), (3, 2)),
                                   ((5, 3), (5, 2))])
def test_f12_lstsq_residuals_are_jnps(xs, ys):
    rs = np.random.RandomState(0)
    x = rs.randn(*xs).astype("float32")
    if xs == (4, 4):
        x[:, 3] = x[:, 0]                       # rank deficient
    y = rs.randn(*ys).astype("float32")
    want = ref.linalg.lstsq(ref.to_tensor(x), ref.to_tensor(y))
    got = pt.linalg.lstsq(pt.to_tensor(x), pt.to_tensor(y))
    assert got[1].shape == list(want[1].shape) == [2]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]._data),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]._data),
                               rtol=1e-2, atol=1e-4)
    assert int(got[2]) == int(want[2])


# ------------------------------------------------------------------ F13
@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16",
                                  "float64", "int64", "int32", "bool"])
def test_f13_dtypes_print_and_compare_as_the_references(name):
    a = np.zeros(2, "float32")
    t = pt.to_tensor(a).astype(name)
    r = ref.to_tensor(a).astype(name)
    assert str(t.dtype) == str(r.dtype) == name
    assert t.dtype == name and r.dtype == name
    assert t.dtype == getattr(pt, name) and r.dtype == getattr(ref, name)
    assert t.dtype == getattr(torch, name)
    if name != "bfloat16":
        assert t.dtype == np.dtype(name) and r.dtype == np.dtype(name)
        assert np.dtype(name) == t.dtype
    assert hash(t.dtype) == hash(getattr(torch, name))
    assert {getattr(torch, name): 1}[t.dtype] == 1
    assert port_dtypes.convert_dtype(t.dtype) is getattr(torch, name)
    assert t.dtype != ("float64" if name != "float64" else "float32")


@pytest.mark.parametrize("name", ["float32", "bfloat16", "int64", "bool"])
def test_f13_name_keyed_lookups_take_the_str(name):
    """A DType equals its name but hashes as its torch dtype, so a set or
    dict keyed by names misses it, as one misses the reference's numpy
    dtype: such lookups take str(dtype), which both packages give."""
    a = np.zeros(2, "float32")
    t = pt.to_tensor(a).astype(name)
    r = ref.to_tensor(a).astype(name)
    assert t.dtype == name
    assert (t.dtype in {name}) is (r.dtype in {name}) is False
    assert {name: 1}[str(t.dtype)] == {name: 1}[str(r.dtype)] == 1
    assert t.dtype in {getattr(torch, name)}


def test_f13_numpy_scalar_types_and_parameters():
    t = pt.to_tensor(np.zeros(2, "float32"))
    assert t.dtype == np.float32 and np.float32 == t.dtype
    assert pt.float32 == "float32" and str(pt.bfloat16) == "bfloat16"
    p = pt.create_parameter([2, 2], "float32")
    assert p.dtype == np.float32
    # the op boundary hands torch dtypes to the bodies
    assert pt.cast(t, pt.bfloat16).dtype == torch.bfloat16
    assert pt.zeros([2], dtype=pt.int32)._data.dtype is torch.int32
    assert isinstance(pt.promote_types("int32", pt.float32),
                      port_dtypes.DType)
