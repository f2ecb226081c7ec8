"""The port's nn surface beside paddle_tpu's (CPU): `paddle.save` /
`paddle.load` across the two packages in both directions, the README's
quick start (eagerly and under `to_static`), `amp.decorate` at O2 on a
Layer, the initializers, and a Layer's device and dtype moves and hooks
(the exports and every layer class's `state_dict` are in
test_torch_nn_state_dict.py).

The random initializers draw from the port's generator and cannot equal
the reference's jax draws: they are held to their shapes, dtypes, bounds
and moments, and Constant, Assign, Dirac, Orthogonal and the Xavier /
Kaiming fans and gains exactly.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.nn as rnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu.nn import initializer as rinit
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.nn import initializer as pinit


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = port_device._current
    pt.set_device("cpu")
    yield
    port_device._current = prev


def test_embedding_padding_row():
    emb = pnn.Embedding(10, 4, padding_idx=-1)
    assert not emb.weight.numpy()[9].any()
    out = emb(pt.to_tensor(np.array([[9, 1]])))
    assert not out.numpy()[0, 0].any() and out.numpy()[0, 1].any()
    out.sum().backward()
    assert not emb.weight.grad.numpy()[9].any()


def _linear_pair():
    ref.seed(1)
    rl = rnn.Sequential(rnn.Linear(4, 6), rnn.ReLU(), rnn.BatchNorm1D(6))
    pl = pnn.Sequential(pnn.Linear(4, 6), pnn.ReLU(), pnn.BatchNorm1D(6))
    return rl, pl


def _outputs(rl, pl, x):
    rl.eval()
    pl.eval()
    return (np.asarray(rl(ref.to_tensor(x))._data),
            pl(pt.to_tensor(x)).numpy())


def test_reference_file_loads_in_the_port(tmp_path):
    rl, pl = _linear_pair()
    path = str(tmp_path / "ref.pdparams")
    ref.save({"model": rl.state_dict(), "step": 7, "tags": ("a", [1, 2])},
             path)
    obj = pt.load(path)
    assert obj["step"] == 7 and obj["tags"] == ("a", [1, 2])
    assert isinstance(obj["model"]["0.weight"], pt.Tensor)
    pl.set_state_dict(obj["model"])
    x = np.random.RandomState(0).randn(3, 4).astype("float32")
    want, got = _outputs(rl, pl, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        pt.load(path, return_numpy=True)["model"]["0.bias"],
        np.asarray(rl.state_dict()["0.bias"]._data))


def test_port_file_loads_in_the_reference(tmp_path):
    rl, pl = _linear_pair()
    pt.seed(3)
    pl2 = pnn.Sequential(pnn.Linear(4, 6), pnn.ReLU(), pnn.BatchNorm1D(6))
    path = str(tmp_path / "port.pdparams")
    pt.save(pl2.state_dict(), path)
    assert not [f for f in tmp_path.iterdir() if ".tmp." in f.name]
    rl.set_state_dict(ref.load(path))
    pl.set_state_dict(pt.load(path))
    x = np.random.RandomState(1).randn(3, 4).astype("float32")
    want, got = _outputs(rl, pl, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pl2.eval()
    np.testing.assert_array_equal(pl2(pt.to_tensor(x)).numpy(), got)


def test_bfloat16_round_trip_keeps_the_bits(tmp_path):
    """The port writes bf16 as exact f32 data with a "dtype" key: its own
    load restores bf16 bit for bit; the reference's load gives f32 of the
    same values."""
    t = pt.to_tensor(np.random.RandomState(2).randn(5, 3).astype(
        "float32")).astype("bfloat16")
    path = str(tmp_path / "bf16.pd")
    pt.save({"w": t}, path)
    back = pt.load(path)["w"]
    assert str(back.dtype) == "bfloat16"
    assert torch.equal(back._data.view(torch.int16), t._data.view(torch.int16))
    theirs = ref.load(path)["w"]
    assert np.dtype(theirs.dtype).name == "float32"
    np.testing.assert_array_equal(np.asarray(theirs._data), t.numpy())
    with open(path, "rb") as f:
        assert pickle.load(f)["w"]["dtype"] == "bfloat16"


def _quick_start(static):
    """The README's quick start at 784 -> 256 -> 10, 20 AdamW steps on
    one seeded batch of 64."""
    pt.seed(0)
    net = pnn.Sequential(pnn.Linear(784, 256), pnn.ReLU(),
                         pnn.Linear(256, 10))
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=net.parameters())

    def train_step(x, y):
        loss = PF.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = pt.jit.to_static(train_step) if static else train_step
    rs = np.random.RandomState(0)
    x = pt.to_tensor(rs.randn(64, 784).astype("float32"))
    y = pt.to_tensor(rs.randint(0, 10, (64,)))
    return [float(step(x, y)) for _ in range(20)], step


def test_readme_quick_start_eager_and_to_static():
    eager, _ = _quick_start(False)
    static, step = _quick_start(True)
    assert eager[-1] < 0.5 * eager[0]
    assert len(step._cache) == 1
    np.testing.assert_allclose(static, eager, rtol=1e-3, atol=1e-3)


def test_amp_decorate_o2_keeps_norm_layers_f32_and_the_leaves():
    def build(nn):
        return nn.Sequential(nn.Linear(4, 8), nn.LayerNorm(8),
                             nn.BatchNorm1D(8), nn.Linear(8, 2))

    ref.seed(0)
    rl = build(rnn)
    pl = build(pnn)
    ropt = ref.optimizer.AdamW(parameters=rl.parameters())
    popt = pt.optimizer.AdamW(parameters=pl.parameters())
    leaves = [p._data for p in pl.parameters()]
    ref.amp.decorate(rl, ropt, level="O2", dtype="bfloat16")
    pt.amp.decorate(pl, popt, level="O2", dtype="bfloat16")
    want = {k: str(v.dtype) for k, v in rl.state_dict().items()}
    got = {k: str(v.dtype) for k, v in pl.state_dict().items()}
    assert got == want
    assert got["1.weight"] == "float32" and got["0.weight"] == "bfloat16"
    assert all(p._data is leaf for p, leaf in zip(pl.parameters(), leaves))
    before = pl[0].weight.numpy().copy()
    with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
        loss = pl(pt.to_tensor(np.ones((3, 4), "float32"))).sum()
    loss.backward()
    popt.step()
    assert not np.array_equal(pl[0].weight.numpy(), before)


def test_amp_decorate_save_dtype_on_a_layer():
    pl = pnn.Linear(4, 3)
    pt.amp.decorate(pl, level="O1", save_dtype="float16")
    assert str(pl.state_dict()["weight"].dtype) == "float16"
    assert str(pl.weight.dtype) == "float32"


# ------------------------------------------------------------ initializers
SHAPES = [(5,), (4, 6), (8, 3, 3, 3), (6, 2, 5)]


@pytest.mark.parametrize("shape", SHAPES)
def test_fans_and_gains_are_the_references(shape):
    assert pinit._fans(shape) == rinit._fans(shape)
    for name in ("sigmoid", "linear", "conv2d", "tanh", "relu", "selu",
                 "leaky_relu", "other"):
        assert pinit.calculate_gain(name) == rinit.calculate_gain(name)
    assert pinit.calculate_gain("leaky_relu", 0.2) == \
        rinit.calculate_gain("leaky_relu", 0.2)
    fi, fo = rinit._fans(shape)
    assert pinit.XavierNormal(gain=2.0).std(shape) == \
        2.0 * np.sqrt(2.0 / (fi + fo))
    assert pinit.XavierUniform().limit(shape) == np.sqrt(6.0 / (fi + fo))
    assert pinit.KaimingNormal().std(shape) == np.sqrt(2.0) / np.sqrt(fi)
    assert pinit.KaimingUniform(negative_slope=0.1,
                                nonlinearity="leaky_relu").limit(shape) \
        == np.sqrt(2.0 / 1.01) * np.sqrt(3.0 / fi)


def _param(shape, dtype="float32"):
    return pnn.Layer().create_parameter(shape, dtype=dtype,
                                        default_initializer=pinit.Constant(0))


def _ref_param(shape):
    return rnn.Layer().create_parameter(shape, dtype="float32",
                                        default_initializer=rinit.Constant(0))


@pytest.mark.parametrize("case", ["constant", "assign", "dirac"])
def test_deterministic_initializers_equal_the_references(case):
    shape = (4, 2, 3, 3)
    value = np.random.RandomState(0).randn(*shape).astype("float32")
    make = {"constant": lambda m: m.Constant(0.75),
            "assign": lambda m: m.Assign(value),
            "dirac": lambda m: m.Dirac(groups=2)}[case]
    p, r = _param(shape), _ref_param(shape)
    make(pinit)(p)
    make(rinit)(r)
    np.testing.assert_array_equal(p.numpy(), np.asarray(r._data))
    assert not p.stop_gradient


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (4, 2, 3)])
def test_orthogonal_rows_or_columns(shape):
    p = _param(shape)
    pinit.Orthogonal(gain=1.5)(p)
    m = p.numpy().reshape(shape[0], -1)
    g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    np.testing.assert_allclose(g, 2.25 * np.eye(len(g)), atol=1e-5)


@pytest.mark.parametrize("case", ["normal", "truncated", "uniform",
                                  "xavier_normal", "xavier_uniform",
                                  "kaiming_normal", "kaiming_uniform"])
def test_random_initializers_by_shape_bounds_and_moments(case):
    shape = (256, 256)
    fi, fo = pinit._fans(shape)
    lim_x, lim_k = np.sqrt(6.0 / (fi + fo)), np.sqrt(2.0) * np.sqrt(3.0 / fi)
    init, mean, std, bound = {
        "normal": (pinit.Normal(0.5, 2.0), 0.5, 2.0, None),
        "truncated": (pinit.TruncatedNormal(0.0, 1.0, -1.0, 1.0), 0.0,
                      0.5379, (-1.0, 1.0)),
        "uniform": (pinit.Uniform(-0.3, 0.9), 0.3, 1.2 / np.sqrt(12),
                    (-0.3, 0.9)),
        "xavier_normal": (pinit.XavierNormal(), 0.0,
                          np.sqrt(2.0 / (fi + fo)), None),
        "xavier_uniform": (pinit.XavierUniform(), 0.0, lim_x / np.sqrt(3),
                           (-lim_x, lim_x)),
        "kaiming_normal": (pinit.KaimingNormal(), 0.0,
                           np.sqrt(2.0 / fi), None),
        "kaiming_uniform": (pinit.KaimingUniform(), 0.0,
                            lim_k / np.sqrt(3), (-lim_k, lim_k)),
    }[case]
    pt.seed(11)
    p = _param(shape)
    init(p)
    a = p.numpy()
    assert a.shape == shape and str(p.dtype) == "float32"
    assert abs(a.mean() - mean) < 0.02 * max(std, 1.0)
    assert abs(a.std() / std - 1) < 0.02
    if bound is not None:
        assert a.min() >= bound[0] and a.max() <= bound[1]
    pt.seed(11)
    q = _param(shape)
    init(q)
    np.testing.assert_array_equal(q.numpy(), a)         # seed repeats it
    b = _param(shape, "bfloat16")
    init(b)
    assert str(b.dtype) == "bfloat16"


# ------------------------------------------------------------ moves, hooks
def test_layer_moves_keep_parameters_and_leaves():
    layer = pnn.Linear(3, 2)
    leaf = layer.weight._data
    assert layer.to("cpu") is layer
    assert isinstance(layer.weight, pt.Parameter)
    assert layer.weight._data is leaf
    layer.to(dtype="bfloat16")
    assert str(layer.weight.dtype) == "bfloat16" and \
        layer.weight._data is leaf
    layer.float()
    out = layer(pt.to_tensor(np.ones((1, 3), "float32")))
    out.sum().backward()
    assert layer.weight.grad is not None
    layer.clear_gradients()
    assert layer.weight.grad is None


def test_forward_hooks_and_parameter_attrs():
    layer = pnn.Linear(2, 2, weight_attr=pnn.ParamAttr(
        initializer=pinit.Constant(1.0), learning_rate=0.5, trainable=False))
    assert layer.weight.stop_gradient and \
        layer.weight.optimize_attr == {"learning_rate": 0.5}
    seen = []
    pre = layer.register_forward_pre_hook(lambda m, i: (i[0] * 2,))
    post = layer.register_forward_post_hook(
        lambda m, i, o: seen.append(o.shape))
    out = layer(pt.to_tensor(np.ones((1, 2), "float32")))
    np.testing.assert_allclose(out.numpy(), [[4.0, 4.0]])
    assert seen == [[1, 2]]
    pre.remove()
    post.remove()
    np.testing.assert_allclose(layer(pt.to_tensor(np.ones(
        (1, 2), "float32"))).numpy(), [[2.0, 2.0]])
