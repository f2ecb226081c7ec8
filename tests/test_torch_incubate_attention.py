"""The decode-attention functions of the port's `incubate.nn.functional`
held to paddle_tpu's on the CPU: `masked_multihead_attention`,
`blha_get_max_len` and `block_multihead_attention` (the decode step;
prefill refuses, as the reference's), by
test_torch_incubate_functional.py's `check`: outputs, and the gradients
in the inputs the reference differentiates, within 1e-5 of each tensor's
largest |value|. `fused_moe`, the varlen attention and the transformer
stack are in test_torch_incubate_moe.py.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as RF

import paddle_tpu_torch as pt
import paddle_tpu_torch.incubate.nn.functional as PF
from paddle_tpu_torch.core import device as port_device
from test_torch_incubate_functional import _f, _rand, check


@pytest.fixture(autouse=True, scope="module")
def _setup():
    prev = port_device._current
    pt.set_device("cpu")
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    paddle.set_flags(old)
    port_device._current = prev


@pytest.mark.parametrize("bias,mask", [(False, False), (True, True)])
def test_masked_multihead_attention(bias, mask):
    b, h, L, d = 2, 2, 6, 4
    lens = np.array([2, 5], "int64")
    src = np.where(np.random.RandomState(1).rand(b, 1, 1, L) > 0.8, -1e4,
                   0.0).astype("float32")

    def fn(pkg, x, cache, bi, sm, ln):
        return _f(pkg).masked_multihead_attention(
            x, cache, bi if bias else None, sm if mask else None,
            sequence_lengths=ln)

    check(fn, [_rand(b, 3 * h * d), _rand(2, b, h, L, d, seed=1),
               _rand(3 * h * d, seed=2), src, lens],
          diff=(0, 1))


def test_masked_multihead_attention_refusals():
    x = np.ones((1, 12), "float32")
    c = np.ones((2, 1, 1, 4, 4), "float32")
    for pkg in (pt, paddle):
        F = _f(pkg)
        t, ct = pkg.to_tensor(x), pkg.to_tensor(c)
        lens = pkg.to_tensor(np.array([1]))
        with pytest.raises(ValueError):
            F.masked_multihead_attention(t)
        with pytest.raises(ValueError):
            F.masked_multihead_attention(t, ct)
        with pytest.raises(ValueError):
            F.masked_multihead_attention(t, ct, sequence_lengths=lens,
                                         seq_len=2)
        with pytest.raises(NotImplementedError):
            F.masked_multihead_attention(t, ct, sequence_lengths=lens,
                                         qkv_out_scale=t)


def test_blha_get_max_len():
    enc, dec = np.array([3, 7, 1]), np.array([9, 2, 4])
    got = PF.blha_get_max_len(pt.to_tensor(enc), pt.to_tensor(dec), 3)
    want = RF.blha_get_max_len(paddle.to_tensor(enc), paddle.to_tensor(dec),
                               3)
    assert [int(a) for a in got] == [int(a) for a in want] == [7, 9]


def test_block_multihead_attention():
    b, h, bs, d, blocks = 2, 2, 4, 8, 6
    tables = np.array([[0, 2, 5], [1, 3, 4]], "int32")
    lens = np.array([5, 9], "int32")
    this = np.ones(b, "int32")

    def fn(pkg, qkv, kc, vc, ln, tb, th):
        return _f(pkg).block_multihead_attention(
            qkv, kc, vc, ln, ln, th, None, None, None, None, tb)

    check(fn, [_rand(b, 3 * h * d), _rand(blocks, h, bs, d, seed=1),
               _rand(blocks, h, bs, d, seed=2), lens, tables, this],
          diff=(0, 1, 2))
    for pkg in (pt, paddle):
        with pytest.raises(NotImplementedError):
            fn(pkg, *[pkg.to_tensor(a) for a in (
                _rand(b, 3 * h * d), _rand(blocks, h, bs, d),
                _rand(blocks, h, bs, d), lens, tables,
                np.array([2, 1], "int32"))])
