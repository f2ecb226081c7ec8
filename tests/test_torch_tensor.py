"""The port's Paddle Tensor against paddle_tpu's (CPU).

`paddle_tpu_torch.Tensor` wraps a torch tensor (`_data`); its tape is torch
autograd. Held here on the same numpy inputs to paddle_tpu's Tensor:
construction and default dtypes, properties, conversion methods,
operators (scalar promotion included), indexing, the names whose Paddle
meaning differs from torch's (`size`, `shape`, `dim`, `transpose`,
`split`, `gather`, `scatter`, `sort`, `max`, `flatten`, non-scalar
`backward`), the in-place rule (`inplace_variant`: a leaf that requires
grad refuses, a recorded tensor rebinds and earlier ops keep the old
value, nothing recording writes the storage), places and the default
device (the card; no card and no `set_device("cpu")` raises), dtypes, and
that a Tensor's `_data` goes through torch code unchanged.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.core.dtype import dtype_name

RS = np.random.RandomState(0)
A = RS.randn(3, 4).astype("float32")
B = RS.randn(3, 4).astype("float32") + 3.0
I = RS.randint(1, 6, (3, 4)).astype("int64")


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = port_device._current
    pt.set_device("cpu")
    old = ref.get_flags(["FLAGS_eager_defer_vjp"])
    ref.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    ref.set_flags(old)
    port_device._current = prev


def _same(mine, theirs, rtol=1e-6, atol=1e-6):
    """Port Tensor vs reference Tensor: dtype, shape and values."""
    assert dtype_name(mine.dtype) == np.dtype(theirs.dtype).name
    assert mine.shape == list(theirs.shape)
    np.testing.assert_allclose(mine.numpy().astype("float64"),
                               np.asarray(theirs._data).astype("float64"),
                               rtol=rtol, atol=atol)


# ------------------------------------------------------------ construction
@pytest.mark.parametrize("data,dtype", [
    ([1, 2, 3], None), ([1.5, 2.5], None), (np.arange(4.0), None),
    (np.arange(4, dtype="int32"), None), ([True, False], None),
    (3.0, None), (7, None), ([1, 2], "float32"), ([1.5], "float16"),
    (A, "bfloat16"), (A.astype("float64"), "float64")])
def test_to_tensor_dtypes_match_reference(data, dtype):
    _same(pt.to_tensor(data, dtype=dtype), ref.to_tensor(data, dtype=dtype),
          rtol=1e-2)


def test_to_tensor_copies_and_takes_tensors():
    src = np.ones(3, "float32")
    t = pt.to_tensor(src)
    src[0] = 5.0
    assert t.numpy()[0] == 1.0
    u = pt.to_tensor(t)
    u.fill_(2.0)
    assert t.numpy()[0] == 1.0
    assert pt.to_tensor([t, t]).shape == [2, 3]
    assert pt.to_tensor(torch.ones(2)).dtype == pt.float32


def test_parameter_and_create_parameter():
    p = pt.Parameter(A)
    r = ref.core.tensor.Parameter(A)
    assert p.stop_gradient is r.stop_gradient is False
    assert p.trainable and p.persistable == r.persistable
    p.trainable = False
    assert p.stop_gradient
    w = pt.create_parameter([4, 3], "float32")
    rw = ref.create_parameter([4, 3], "float32")
    assert w.shape == rw.shape and not w.stop_gradient
    assert abs(float(w.numpy().std()) - 0.02) < 0.01
    b = pt.create_parameter([3], "float32", is_bias=True)
    assert not b.numpy().any() and isinstance(b, pt.Parameter)


# ------------------------------------------------------------ properties
def test_properties_match_reference():
    t, r = pt.to_tensor(A), ref.to_tensor(A)
    assert t.shape == r.shape == [3, 4] and isinstance(t.shape, list)
    assert t.ndim == r.ndim == t.dim == r.dim == 2
    assert t.size == r.size == 12
    assert t.numel() == r.numel() and t.element_size() == r.element_size()
    assert dtype_name(t.dtype) == r.dtype.name
    assert t.is_leaf and t.stop_gradient and t.grad is None
    assert not t.persistable and t.name.startswith("tensor_")
    assert t.place == pt.CPUPlace() and t.place.is_cpu_place()
    y = t * 2
    assert y.is_leaf == (r * 2).is_leaf
    t.stop_gradient = False
    assert not (t * 2).is_leaf and t._data.requires_grad


def test_conversion_methods_match_reference():
    t, r = pt.to_tensor(A), ref.to_tensor(A)
    np.testing.assert_array_equal(t.numpy(), r.numpy())
    np.testing.assert_array_equal(np.asarray(t), np.asarray(r))
    assert t.tolist() == r.tolist()
    assert t[1, 2].item() == r[1, 2].item() and t.item(5) == r.item(5)
    assert len(t) == len(r) == 3
    assert [x.shape for x in t] == [x.shape for x in r]
    s = pt.to_tensor(2.5)
    assert float(s) == 2.5 and int(pt.to_tensor(3)) == 3
    assert bool(pt.to_tensor(True)) and [0, 1, 2][pt.to_tensor(1)] == 1
    _same(t.T, r.T)
    _same(t.astype("float16"), r.astype("float16"), rtol=1e-3)
    _same(t.cast("int32"), r.cast("int32"))
    _same(t.to("float64"), r.to("float64"))
    assert t.cpu().place == pt.CPUPlace() and t.detach().stop_gradient
    c = t.clone()
    c.fill_(0.0)
    assert t.numpy().any()
    assert "Tensor(shape=[3, 4], dtype=float32" in repr(t)
    with pytest.raises(TypeError):
        len(pt.to_tensor(1.0))


def test_mT_swaps_the_last_two_axes():
    x = RS.randn(2, 3, 4).astype("float32")
    _same(pt.to_tensor(x).mT, ref.to_tensor(x).mT)


def test_pickle_round_trip():
    for t in (pt.to_tensor(A, stop_gradient=False),
              pt.to_tensor(A).astype("bfloat16"), pt.to_tensor(I),
              pt.Parameter(A)):
        u = pickle.loads(pickle.dumps(t))
        assert u.dtype == t.dtype and u.stop_gradient == t.stop_gradient
        np.testing.assert_array_equal(u.numpy(), t.numpy())
        assert u.name == t.name and type(u) is type(t)
        assert u.persistable == t.persistable


# ------------------------------------------------------------ gradients
def test_stop_gradient_maps_requires_grad_both_ways():
    t = pt.to_tensor(A)
    assert not t._data.requires_grad
    t.stop_gradient = False
    assert t._data.requires_grad
    t._data.requires_grad_(False)
    assert t.stop_gradient
    y = pt.to_tensor(A, stop_gradient=False) * 2
    y.stop_gradient = True               # a computed tensor: detached
    assert y._data.grad_fn is None and not y._data.requires_grad
    n = pt.to_tensor(I)
    n.stop_gradient = False              # kept on the wrapper for ints
    assert not n.stop_gradient and not n._data.requires_grad


def test_backward_rules_match_reference():
    for pkg in (pt, ref):
        x = pkg.to_tensor(A)
        with pytest.raises(RuntimeError):
            (x * 2).sum().backward()     # stop_gradient root
        x.stop_gradient = False
        with pytest.raises(RuntimeError):
            (x * 2).backward()           # non-scalar, no grad_tensor
    x = pt.to_tensor(A, stop_gradient=False)
    (x * 2).backward(pt.to_tensor(np.ones_like(A)))
    np.testing.assert_allclose(x.grad.numpy(), 2 * np.ones_like(A))
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 5 * np.ones_like(A))
    x.clear_gradient(set_to_zero=True)
    assert x.grad is not None and not x.grad.numpy().any()
    x.clear_grad()
    assert x.grad is None


def test_hooks_and_retain_grads():
    x = pt.to_tensor(A, stop_gradient=False)
    h = x.register_hook(lambda g: g * 10)
    y = x * 2
    y.retain_grads()
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 20 * np.ones_like(A))
    np.testing.assert_allclose(y.grad.numpy(), np.ones_like(A))
    h.remove()
    x.clear_grad()
    (x * 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * np.ones_like(A))


# ------------------------------------------------------------ operators
BIN = ["__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
       "__truediv__", "__rtruediv__", "__floordiv__", "__rfloordiv__",
       "__mod__", "__rmod__", "__pow__", "__rpow__", "__eq__", "__ne__",
       "__lt__", "__le__", "__gt__", "__ge__"]


@pytest.mark.parametrize("dunder", BIN)
@pytest.mark.parametrize("other", ["tensor", "int", "float", "int_tensor"])
def test_binary_operators_match_reference(dunder, other):
    a = np.abs(A) + 0.5
    if other == "tensor":
        o_pt, o_ref = pt.to_tensor(B), ref.to_tensor(B)
    elif other == "int_tensor":
        o_pt, o_ref = pt.to_tensor(I), ref.to_tensor(I)
    else:
        o_pt = o_ref = 2 if other == "int" else 1.5
    _same(getattr(pt.to_tensor(a), dunder)(o_pt),
          getattr(ref.to_tensor(a), dunder)(o_ref), rtol=1e-5)


@pytest.mark.parametrize("dunder", ["__and__", "__or__", "__xor__"])
def test_logical_and_bitwise_operators_match_reference(dunder):
    bm = A > 0
    for x in (bm, I):
        y = (B > 3) if x is bm else I[::-1].copy()
        _same(getattr(pt.to_tensor(x), dunder)(pt.to_tensor(y)),
              getattr(ref.to_tensor(x), dunder)(ref.to_tensor(y)))


def test_unary_operators_and_matmul_match_reference():
    t, r = pt.to_tensor(A), ref.to_tensor(A)
    _same(-t, -r)
    _same(abs(t), abs(r))
    _same(~pt.to_tensor(A > 0), ~ref.to_tensor(A > 0))
    _same(~pt.to_tensor(I), ~ref.to_tensor(I))
    _same(t @ pt.to_tensor(B.T), r @ ref.to_tensor(B.T), rtol=1e-5)
    _same(t.__rmatmul__(pt.to_tensor(B.T)), r.__rmatmul__(ref.to_tensor(
        B.T)), rtol=1e-5)
    bf = pt.to_tensor(A).astype("bfloat16")
    assert (bf * 2.0).dtype == pt.bfloat16 and (bf + 1).dtype == pt.bfloat16
    assert (pt.to_tensor(I) + 1).dtype == pt.int64
    assert (pt.to_tensor(I) * 1.5).dtype == pt.float32


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_number_operands_match_reference_bits_and_need_no_fill(dtype):
    """A Python number beside a floating Tensor: the result's bits equal
    the reference's (which casts the number to the Tensor's dtype first),
    whether the number goes to torch as it is (exact in the dtype) or as
    a fill (0.1 in bf16 / f16); an exact number adds no fill."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.__name__)
            return func(*args, **(kwargs or {}))

    a = np.abs(A) + 0.5
    t, r = pt.to_tensor(a).astype(dtype), ref.to_tensor(a).astype(dtype)
    for num in (2.0, 0.1, 3, 2, -0.5, 0.5, 1e5):
        for dunder in ("__add__", "__radd__", "__sub__", "__rsub__",
                       "__mul__", "__rmul__", "__truediv__", "__pow__"):
            mine = getattr(t, dunder)(num)
            theirs = getattr(r, dunder)(num)
            assert mine.dtype == t.dtype, (dunder, num)
            np.testing.assert_array_equal(
                mine.astype("float32").numpy(),
                np.asarray(theirs.astype("float32")._data),
                err_msg=f"{dunder} {num}")
    with Ops() as seen:
        t * 2.0 + 0.5
        t ** 2
    assert not any("fill" in n or "full" in n for n in seen.names), \
        seen.names


INDEXES = [1, -1, slice(1, 3), (slice(None), 2), (Ellipsis, 1), (None, 1),
           slice(None, None, -1), (slice(None), slice(3, 0, -2)),
           [0, 2], (np.array([0, 2]), np.array([1, 3])), "mask",
           (slice(None), [1, 3])]


@pytest.mark.parametrize("k", range(len(INDEXES)))
def test_getitem_matches_reference(k):
    idx = INDEXES[k]
    if isinstance(idx, str):
        _same(pt.to_tensor(A)[pt.to_tensor(A > 0)],
              ref.to_tensor(A)[ref.to_tensor(A > 0)])
        return
    _same(pt.to_tensor(A)[idx], ref.to_tensor(A)[idx])


@pytest.mark.parametrize("k", [0, 2, 3, 8])
def test_setitem_matches_reference(k):
    idx = INDEXES[k]
    t, r = pt.to_tensor(A), ref.to_tensor(A)
    t[idx] = 7.0
    r[idx] = 7.0
    _same(t, r)
    t, r = pt.to_tensor(A), ref.to_tensor(A)
    t[pt.to_tensor(A > 0)] = 0.0
    r[ref.to_tensor(A > 0)] = 0.0
    _same(t, r)


def test_setitem_on_a_recorded_tensor_stays_differentiable():
    x = pt.to_tensor(A, stop_gradient=False)
    y = x * 2
    y[0] = pt.to_tensor(np.zeros(4, "float32"))
    y.sum().backward()
    want = 2 * np.ones_like(A)
    want[0] = 0
    np.testing.assert_allclose(x.grad.numpy(), want)


def test_op_methods_attached_by_the_reference_rule():
    from paddle_tpu_torch import ops

    skip = ops._SKIP
    for name in ops.__all__:
        if name in skip or name in ("getitem", "setitem", "add_n", "numel",
                                    "shape", "rank", "is_tensor", "iinfo",
                                    "finfo", "is_floating_point",
                                    "is_complex", "is_integer"):
            continue
        assert hasattr(pt.Tensor, name), name
    theirs = {n for n in dir(ref.Tensor) if not n.startswith("_")
              and callable(getattr(ref.Tensor, n, None))}
    mine = {n for n in dir(pt.Tensor) if not n.startswith("_")}
    missing = sorted(n for n in theirs - mine if n in ops.__all__)
    assert not missing, missing


# ------------------------------------------------------------ clashing names
def test_names_that_differ_from_torch_behave_as_the_reference():
    x = RS.randn(4, 6).astype("float32")
    t, r = pt.to_tensor(x), ref.to_tensor(x)
    assert t.size == r.size == 24 and t.shape == r.shape == [4, 6]
    assert t.shape == [4, 6] and t.dim == r.dim == 2
    _same(t.transpose([1, 0]), r.transpose([1, 0]))
    parts, rparts = t.split(3, axis=1), r.split(3, axis=1)
    assert len(parts) == len(rparts) == 3
    for a, b in zip(parts, rparts):
        _same(a, b)
    for a, b in zip(t.split([1, -1, 2], axis=1), r.split([1, -1, 2],
                                                          axis=1)):
        _same(a, b)
    idx = np.array([[2, 0], [1, 1]])
    _same(t.gather(pt.to_tensor(idx), 1), r.gather(ref.to_tensor(idx), 1))
    rows = np.array([1, 3])
    upd = np.ones((2, 6), "float32")
    for overwrite in (True, False):
        _same(t.scatter(pt.to_tensor(rows), pt.to_tensor(upd), overwrite),
              r.scatter(ref.to_tensor(rows), ref.to_tensor(upd), overwrite))
    _same(t.sort(), r.sort())
    _same(t.sort(axis=0, descending=True), r.sort(axis=0, descending=True))
    _same(t.max(1), r.max(1))
    _same(t.max(), r.max())
    _same(t.min(axis=0, keepdim=True), r.min(axis=0, keepdim=True))
    y = RS.randn(2, 3, 4, 5).astype("float32")
    _same(pt.to_tensor(y).flatten(1, 2), ref.to_tensor(y).flatten(1, 2))
    _same(pt.to_tensor(y).flatten(), ref.to_tensor(y).flatten())
    z = pt.to_tensor(x, stop_gradient=False)
    with pytest.raises(RuntimeError, match="non-scalar"):
        (z * 2).backward()


def test_max_splits_a_tie_gradient_as_the_reference():
    """jnp.max (and torch.amax) share a tie's gradient; torch.max(dim)
    would send it to one index. The port's gradient equals the reference
    tape's."""
    a = np.array([[1.0, 3.0, 3.0]], "float32")
    grads = []
    for pkg in (pt, ref):
        x = pkg.to_tensor(a, stop_gradient=False)
        x.max(axis=1).sum().backward()
        grads.append(x.grad.numpy())
    np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_allclose(grads[0], [[0.0, 0.5, 0.5]])


def test_torch_code_takes_the_data_unchanged():
    """A Tensor's `_data` through torch's own Python code and the port's
    layers, and ops given torch tensors return torch tensors."""
    from torch.utils.checkpoint import checkpoint

    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    w = pt.to_tensor(RS.randn(5, 4).astype("float32"), stop_gradient=False)
    x = pt.to_tensor(A)
    out = torch.nn.functional.linear(x._data, w._data)
    out2 = checkpoint(lambda a: torch.nn.functional.linear(a, w._data),
                      x._data, use_reentrant=False)
    (out.sum() + out2.sum()).backward()
    np.testing.assert_allclose(w.grad.numpy(), 2 * np.tile(A.sum(0), (5, 1)),
                               rtol=1e-5)
    torch.manual_seed(0)
    m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    layer = m.model.layers[0]
    h = pt.to_tensor(RS.randn(1, 5, 64).astype("float32"))
    cos, sin = m.rope_tables()
    y = layer(h._data, cos, sin)
    assert isinstance(y, torch.Tensor) and y.shape == (1, 5, 64)
    assert isinstance(pt.add(torch.ones(2), torch.ones(2)), torch.Tensor)
    assert isinstance(pt.add(pt.to_tensor([1.0]), 1.0), pt.Tensor)


# ------------------------------------------------------------ in place
def test_inplace_keeps_the_old_value_for_earlier_ops():
    """y = x * 2; z = y * w; y.add_(1): z's backward sees the old y, and
    y's later uses see the new value."""
    x = pt.to_tensor(A, stop_gradient=False)
    w = pt.to_tensor(B, stop_gradient=False)
    y = x * 2
    z = y * w
    y.add_(pt.to_tensor(np.ones_like(A)))
    np.testing.assert_allclose(y.numpy(), 2 * A + 1, rtol=1e-6)
    z.sum().backward(retain_graph=True)
    np.testing.assert_allclose(w.grad.numpy(), 2 * A, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), 2 * B, rtol=1e-6)
    x.clear_grad()
    (y * 3).sum().backward()             # through the add, to x
    np.testing.assert_allclose(x.grad.numpy(), 6 * np.ones_like(A))


def test_inplace_on_a_leaf_that_requires_grad_refuses():
    x = pt.to_tensor(A, stop_gradient=False)
    for op_ in ("add_", "exp_", "scale_", "clip_", "tanh_", "sqrt_"):
        with pytest.raises(RuntimeError, match="leaf Tensor"):
            fn = getattr(x, op_)
            fn(pt.to_tensor(B)) if op_ == "add_" else fn()
    rx = ref.to_tensor(A, stop_gradient=False)
    with pytest.raises(RuntimeError):
        rx.add_(ref.to_tensor(B))


def test_inplace_without_recording_writes_the_storage():
    p = pt.to_tensor(A, stop_gradient=False)
    data, ptr = p._data, p._data.data_ptr()
    with pt.no_grad():
        p.scale_(2.0)
        p.add_(pt.to_tensor(B))
    assert p._data is data and p._data.data_ptr() == ptr and p.is_leaf
    np.testing.assert_allclose(p.numpy(), 2 * A + B, rtol=1e-6)
    c = pt.to_tensor(A)
    data = c._data
    with pt.no_grad():
        c.exp_()
        c[0] = 1.0
        c.fill_(2.0)
        c.set_value(B)
    assert c._data is data
    np.testing.assert_allclose(data.numpy(), B, rtol=1e-6)


def test_inplace_on_a_constant_in_a_graph_keeps_its_old_value():
    """x a constant, z = x * w with w trainable: every in-place write to
    x while grad is enabled leaves z's backward the old x (the
    reference's buffer swap; a storage write would fail torch's version
    check), and x reads the new value. w.grad equals paddle_tpu's."""
    out = []
    for pkg in (pt, ref):
        x = pkg.to_tensor(A)
        w = pkg.to_tensor(B, stop_gradient=False)
        z = x * w
        x.add_(pkg.to_tensor(np.ones_like(A)))
        x.scale_(2.0)
        x[0] = 5.0
        x.exp_()
        x.set_value(np.zeros_like(A))
        x.fill_(3.0)
        z.sum().backward()
        out.append((w.grad.numpy(), x.numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][0], A)
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_set_value_copy_zero_fill_match_reference():
    for pkg in (pt, ref):
        t = pkg.to_tensor(A)
        t.set_value(np.ones(4, "float32"))   # broadcast into the shape
        np.testing.assert_array_equal(t.numpy(), np.ones_like(A))
        t.copy_(pkg.to_tensor(B))
        np.testing.assert_array_equal(t.numpy(), B)
        t.zero_()
        assert not t.numpy().any()
        t.fill_(2.5)
        assert (t.numpy() == 2.5).all()
    p = pt.to_tensor(A, stop_gradient=False)
    ptr = p._data.data_ptr()
    p.set_value(B)                           # a leaf's value, in place
    assert p._data.data_ptr() == ptr and not p.stop_gradient


def test_inplace_twins_exist_for_the_reference_bases():
    from paddle_tpu.ops import _INPLACE_BASES

    from paddle_tpu_torch import ops

    for base in _INPLACE_BASES:
        if hasattr(ops, base) and hasattr(ref, base + "_"):
            assert hasattr(pt.Tensor, base + "_"), base
            assert hasattr(pt, base + "_"), base
    t = pt.to_tensor(np.array([0.5, 1.0], "float32"))
    t.cos_()
    np.testing.assert_allclose(t.numpy(), np.cos([0.5, 1.0]), rtol=1e-6)
    m = pt.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]], "float32"))
    m.tril_()
    np.testing.assert_array_equal(m.numpy(), [[1.0, 0.0], [3.0, 4.0]])
    m.t_()
    np.testing.assert_array_equal(m.numpy(), [[1.0, 3.0], [0.0, 4.0]])


# ------------------------------------------------------------ places, dtypes
def test_default_device_is_the_card_and_refuses_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_device._current = None
    for make in (lambda: pt.to_tensor([1.0]), lambda: pt.zeros([2]),
                 lambda: pt.arange(3), lambda: pt.set_device("gpu")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    t = pt.to_tensor([1.0], place=pt.CPUPlace())
    assert t.place.is_cpu_place()
    assert pt.to_tensor([1.0], place="cpu").place == pt.CPUPlace()
    pt.set_device("cpu")
    assert pt.get_device() == ref.get_device() == "cpu:0"
    assert pt.zeros([2]).place == pt.CPUPlace()


def test_places_and_device_queries():
    assert repr(pt.CPUPlace()) == "Place(cpu:0)"
    assert repr(pt.CUDAPlace(1)) == "Place(gpu:1)"
    assert pt.CUDAPlace(0).is_gpu_place() and pt.CUDAPinnedPlace() \
        .is_cuda_pinned_place()
    assert pt.CPUPlace() != pt.CUDAPlace(0)
    assert isinstance(pt.device_count(), int)
    assert isinstance(pt.is_compiled_with_cuda(), bool)
    with pytest.raises(ValueError):
        pt.set_device("tpu:0")


def test_dtypes_match_reference():
    for name in ("bool", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64", "complex64",
                 "complex128"):
        assert dtype_name(getattr(pt, name)) == np.dtype(
            getattr(ref, name)).name
    assert pt.get_default_dtype() == pt.float32
    pt.set_default_dtype("float64")
    try:
        assert pt.to_tensor([1.5]).dtype == pt.float64
    finally:
        pt.set_default_dtype("float32")
    assert pt.promote_types("int32", "float32") == pt.float32
    assert dtype_name(pt.promote_types("bfloat16", "float32")) == np.dtype(
        ref.core.dtype.promote_types(ref.bfloat16, ref.float32)).name
    assert pt.is_floating_point(pt.to_tensor(A)) and not pt.is_integer(
        pt.to_tensor(A))
    assert pt.is_floating_point("bfloat16") and pt.is_integer(pt.int64)
    assert pt.iinfo("int32").max == ref.iinfo("int32").max
    assert pt.finfo("float32").eps == pytest.approx(ref.finfo("float32").eps)
    assert pt.finfo(pt.bfloat16).eps == pytest.approx(
        float(ref.finfo(ref.bfloat16).eps))
