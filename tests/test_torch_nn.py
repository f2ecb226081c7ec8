"""The reference's nn.Layer stack tests (tests/test_nn.py), every case,
on the port (CPU): layers, containers, state_dict, train/eval.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.core import device as port_device


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = port_device._current
    paddle.set_device("cpu")
    yield
    port_device._current = prev


def rnd(*shape):
    return np.random.randn(*shape).astype(np.float32)


def test_linear():
    layer = nn.Linear(4, 3)
    x = paddle.to_tensor(rnd(2, 4))
    y = layer(x)
    assert y.shape == [2, 3]
    ref = x.numpy() @ layer.weight.numpy() + layer.bias.numpy()
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_conv2d_shapes():
    layer = nn.Conv2D(3, 8, 3, stride=2, padding=1)
    y = layer(paddle.to_tensor(rnd(2, 3, 16, 16)))
    assert y.shape == [2, 8, 8, 8]
    # groups + dilation
    g = nn.Conv2D(4, 8, 3, groups=2, dilation=2, padding=2)
    assert g(paddle.to_tensor(rnd(1, 4, 9, 9))).shape == [1, 8, 9, 9]


def test_conv_matches_torch_style_reference():
    w = rnd(2, 1, 3, 3)
    x = rnd(1, 1, 5, 5)
    conv = nn.Conv2D(1, 2, 3)
    conv.weight.set_value(w)
    conv.bias.set_value(np.zeros(2, np.float32))
    out = conv(paddle.to_tensor(x)).numpy()
    # direct correlation
    ref = np.zeros((1, 2, 3, 3), np.float32)
    for o in range(2):
        for i in range(3):
            for j in range(3):
                ref[0, o, i, j] = np.sum(x[0, 0, i:i + 3, j:j + 3] * w[o, 0])
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_batchnorm_train_eval():
    bn = nn.BatchNorm2D(3)
    x = paddle.to_tensor(rnd(4, 3, 5, 5) * 3 + 1)
    bn.train()
    y = bn(x)
    m = y.numpy().mean(axis=(0, 2, 3))
    np.testing.assert_allclose(m, np.zeros(3), atol=1e-4)
    bn.eval()
    y2 = bn(x)
    assert y2.shape == [4, 3, 5, 5]
    # running stats moved toward batch stats
    assert not np.allclose(bn._mean.numpy(), np.zeros(3))


def test_layernorm():
    ln = nn.LayerNorm(8)
    x = paddle.to_tensor(rnd(2, 5, 8) * 4 + 2)
    y = ln(x).numpy()
    np.testing.assert_allclose(y.mean(-1), np.zeros((2, 5)), atol=1e-4)
    np.testing.assert_allclose(y.std(-1), np.ones((2, 5)), atol=1e-2)


def test_embedding():
    emb = nn.Embedding(10, 4)
    idx = paddle.to_tensor(np.array([[1, 2], [3, 4]], np.int64))
    y = emb(idx)
    assert y.shape == [2, 2, 4]
    np.testing.assert_allclose(y.numpy()[0, 0], emb.weight.numpy()[1])


def test_dropout_train_eval():
    do = nn.Dropout(0.5)
    x = paddle.to_tensor(np.ones((100, 100), np.float32))
    do.train()
    y = do(x)
    assert (y.numpy() == 0).mean() > 0.3
    do.eval()
    np.testing.assert_array_equal(do(x).numpy(), x.numpy())


def test_sequential_and_children():
    net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    y = net(paddle.to_tensor(rnd(3, 4)))
    assert y.shape == [3, 2]
    assert len(list(net.parameters())) == 4
    assert len(list(net.children())) == 3


def test_layerlist_layerdict():
    ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
    assert len(list(ll.parameters())) == 6
    x = paddle.to_tensor(rnd(1, 2))
    for l in ll:
        x = l(x)
    assert x.shape == [1, 2]


def test_state_dict_roundtrip():
    net = nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1D(8))
    sd = net.state_dict()
    assert any("weight" in k for k in sd)
    net2 = nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1D(8))
    net2.set_state_dict(sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), net2.state_dict()[k].numpy())


def test_named_parameters_and_sublayers():
    class M(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(2, 2)
            self.inner = nn.Sequential(nn.Linear(2, 2))

        def forward(self, x):
            return self.inner(self.fc1(x))

    m = M()
    names = [n for n, _ in m.named_parameters()]
    assert "fc1.weight" in names
    assert any(n.startswith("inner.") for n in names)
    assert len(list(m.sublayers())) >= 2


def test_activations():
    x = rnd(3, 4)
    tx = paddle.to_tensor(x)
    np.testing.assert_allclose(F.relu(tx).numpy(), np.maximum(x, 0))
    np.testing.assert_allclose(
        F.softmax(tx, axis=-1).numpy().sum(-1), np.ones((3,)), rtol=1e-5)
    np.testing.assert_allclose(
        F.log_softmax(tx, axis=-1).numpy(),
        np.log(np.exp(x) / np.exp(x).sum(-1, keepdims=True)), rtol=1e-4, atol=1e-5)
    assert F.gelu(tx).shape == [3, 4]
    np.testing.assert_allclose(F.silu(tx).numpy(), x / (1 + np.exp(-x)), rtol=1e-4)
    np.testing.assert_allclose(
        F.leaky_relu(tx, 0.1).numpy(), np.where(x > 0, x, 0.1 * x), rtol=1e-5)


def test_losses():
    logits = paddle.to_tensor(rnd(4, 5), stop_gradient=False)
    labels = paddle.to_tensor(np.array([0, 1, 2, 3], np.int64))
    loss = nn.CrossEntropyLoss()(logits, labels)
    assert loss.shape == []
    lp = logits.numpy() - np.log(np.exp(logits.numpy()).sum(-1, keepdims=True))
    ref = -lp[np.arange(4), [0, 1, 2, 3]].mean()
    np.testing.assert_allclose(float(loss), ref, rtol=1e-5)
    loss.backward()
    assert logits.grad is not None

    a, b = paddle.to_tensor(rnd(3, 4)), paddle.to_tensor(rnd(3, 4))
    np.testing.assert_allclose(
        float(nn.MSELoss()(a, b)), ((a.numpy() - b.numpy()) ** 2).mean(), rtol=1e-5)
    np.testing.assert_allclose(
        float(nn.L1Loss()(a, b)), np.abs(a.numpy() - b.numpy()).mean(), rtol=1e-5)

    p = paddle.to_tensor(np.random.rand(6).astype(np.float32))
    t = paddle.to_tensor((np.random.rand(6) > 0.5).astype(np.float32))
    ref = -(t.numpy() * np.log(p.numpy()) + (1 - t.numpy()) * np.log(1 - p.numpy())).mean()
    np.testing.assert_allclose(float(nn.BCELoss()(p, t)), ref, rtol=1e-4)


def test_pooling():
    x = rnd(2, 3, 8, 8)
    tx = paddle.to_tensor(x)
    y = F.max_pool2d(tx, 2, 2)
    assert y.shape == [2, 3, 4, 4]
    np.testing.assert_allclose(y.numpy()[0, 0, 0, 0], x[0, 0, :2, :2].max())
    y = F.avg_pool2d(tx, 2, 2)
    np.testing.assert_allclose(y.numpy()[0, 0, 0, 0], x[0, 0, :2, :2].mean(), rtol=1e-5)
    y = F.adaptive_avg_pool2d(tx, 1)
    np.testing.assert_allclose(
        y.numpy()[..., 0, 0], x.mean(axis=(2, 3)), rtol=1e-5)


def test_multihead_attention_and_transformer_layer():
    mha = nn.MultiHeadAttention(16, 4)
    x = paddle.to_tensor(rnd(2, 5, 16))
    y = mha(x, x, x)
    assert y.shape == [2, 5, 16]
    enc = nn.TransformerEncoderLayer(16, 4, 32)
    y = enc(x)
    assert y.shape == [2, 5, 16]


def test_parameter_registration_and_buffers():
    class M(nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([3, 3])
            self.register_buffer("running", paddle.zeros([3]))

        def forward(self, x):
            return x

    m = M()
    assert len(list(m.parameters())) == 1
    assert "running" in m.state_dict()


def test_train_eval_propagates():
    net = nn.Sequential(nn.Linear(2, 2), nn.Dropout(0.5))
    net.eval()
    assert not net[1].training
    net.train()
    assert net[1].training


def test_apply_and_to():
    net = nn.Linear(2, 2)
    net.apply(lambda l: None)
    netf = net.to(dtype="float32")
    assert netf.weight.dtype == np.float32


def test_grad_flow_through_net():
    net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 1))
    x = paddle.to_tensor(rnd(3, 4))
    loss = paddle.mean(net(x))
    loss.backward()
    for p in net.parameters():
        assert p.grad is not None, p.name
