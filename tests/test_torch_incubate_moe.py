"""The MoE, varlen-attention and transformer-stack functions of the
port's `incubate.nn.functional` held to paddle_tpu's on the CPU:
`fused_moe`, `variable_length_memory_efficient_attention` and
`fused_multi_transformer` (pre- and post-LN, 4-D and 2-D qkv weights), by
test_torch_incubate_functional.py's `check`: outputs, and the gradients
in the inputs the reference differentiates, within 1e-5 of each tensor's
largest |value| (the layer stack 1e-4). The decode attention is in
test_torch_incubate_attention.py, whose setup this file shares.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest

from test_torch_incubate_attention import _setup  # noqa: F401
from test_torch_incubate_functional import _f, _rand, check


@pytest.mark.parametrize("biases,norm", [(True, True), (False, False)])
def test_fused_moe(biases, norm):
    e, h, f = 3, 6, 10
    arrays = [_rand(2, 4, h), _rand(h, e, seed=1)]
    arrays += [_rand(h, f, seed=10 + i) for i in range(e)]
    arrays += [_rand(f, h, seed=20 + i) for i in range(e)]
    if biases:
        arrays += [_rand(f, seed=30 + i) for i in range(e)]
        arrays += [_rand(h, seed=40 + i) for i in range(e)]

    def fn(pkg, x, g, *ws):
        return _f(pkg).fused_moe(
            x, g, list(ws[:e]), list(ws[e:2 * e]),
            list(ws[2 * e:3 * e]) if biases else None,
            list(ws[3 * e:]) if biases else None, moe_topk=2,
            norm_topk_prob=norm)

    check(fn, arrays, diff=tuple(range(len(arrays))))


@pytest.mark.parametrize("causal,mask", [(False, False), (True, True)])
def test_variable_length_memory_efficient_attention(causal, mask):
    b, h, s, d = 2, 2, 5, 4
    m = np.where(np.random.RandomState(3).rand(b, 1, s, s) > 0.8, -1e4,
                 0.0).astype("float32")

    def fn(pkg, q, k, v, sl, kl, mk):
        return _f(pkg).variable_length_memory_efficient_attention(
            q, k, v, sl, kl, mk if mask else None, causal=causal)

    check(fn, [_rand(b, h, s, d), _rand(b, h, s, d, seed=1),
               _rand(b, h, s, d, seed=2), np.array([5, 3]),
               np.array([5, 2]), m], diff=(0, 1, 2))


@pytest.mark.parametrize("pre,four_d", [(True, True), (False, False)])
def test_fused_multi_transformer(pre, four_d):
    hid, heads, dh, ffn, layers = 64, 1, 64, 32, 2
    shape = [3, heads, dh, hid] if four_d else [3 * hid, hid]
    arrays = [_rand(2, 5, hid)]
    for i in range(layers):
        arrays += [_rand(hid, seed=i), _rand(hid, seed=10 + i),
                   _rand(*shape, seed=20 + i) * 0.1,
                   _rand(3 * hid, seed=30 + i),
                   _rand(hid, hid, seed=40 + i) * 0.1,
                   _rand(hid, seed=50 + i), _rand(hid, seed=60 + i),
                   _rand(hid, seed=70 + i), _rand(hid, ffn, seed=80 + i) * 0.1,
                   _rand(ffn, seed=90 + i),
                   _rand(ffn, hid, seed=100 + i) * 0.1,
                   _rand(hid, seed=110 + i)]

    def fn(pkg, x, *ws):
        per = [ws[i::12] for i in range(12)]
        out, _ = _f(pkg).fused_multi_transformer(
            x, *[list(p) for p in per], pre_layer_norm=pre, epsilon=1e-5)
        return out

    check(fn, arrays, diff=(0, 3, 5, 9), tol=1e-4)
