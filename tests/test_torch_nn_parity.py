"""The port's layers held to paddle_tpu's (CPU), at a small size
(tests/_torch_nn_parity.py): a 2-layer TransformerEncoder (post- and
pre-norm, with a mask) and TransformerDecoder at d 32 and 4 heads,
MultiHeadAttention with `Cache` and `StaticCache` and with its weights,
Conv2D + BatchNorm2D (train, then eval on the updated running
statistics) + pooling, and Sequential with its `state_dict`. The
recurrent layers are in test_torch_nn_parity_rnn.py.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.nn as rnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
from _torch_nn_parity import (FWD, both, check,
                              on_cpu_with_the_reference_tape, rand)

_setup = pytest.fixture(autouse=True, scope="module")(
    on_cpu_with_the_reference_tape)


def test_transformer_encoder():
    rl, pl = both(lambda nn: nn.TransformerEncoder(
        nn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                   activation="gelu"), 2))
    check(rl, pl, [rand(2, 5, 32)])


def test_transformer_encoder_pre_norm_with_mask():
    rl, pl = both(lambda nn: nn.TransformerEncoder(
        nn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                   normalize_before=True), 2,
        nn.LayerNorm(32)))
    mask = np.triu(np.full((5, 5), -1e9, "float32"), 1)[None, None]
    check(rl, pl, [rand(2, 5, 32), mask], grad=[True, False],
           call=lambda layer, x, m: layer(x, src_mask=m))


def test_transformer_decoder():
    rl, pl = both(lambda nn: nn.TransformerDecoder(
        nn.TransformerDecoderLayer(32, 4, 64, dropout=0.0), 2))
    mask = rnn.Transformer.generate_square_subsequent_mask(4)
    assert np.array_equal(
        pnn.Transformer.generate_square_subsequent_mask(4).numpy(),
        np.asarray(mask._data))
    check(rl, pl, [rand(2, 4, 32), rand(2, 6, 32, seed=1),
                    np.asarray(mask._data)], grad=[True, True, False],
           call=lambda layer, t, m, tm: layer(t, m, tgt_mask=tm))


def test_multihead_attention_with_cache_and_static_cache():
    rl, pl = both(lambda nn: nn.MultiHeadAttention(32, 4))
    x, mem = rand(2, 3, 32), rand(2, 5, 32, seed=1)

    def incremental(layer, q, m):
        cache = layer.gen_cache(q)
        out, cache = layer(q, q, q, cache=cache)
        out2, cache = layer(q, q, q, cache=cache)
        static = layer.gen_cache(m, m, type=type(layer).StaticCache)
        out3, _ = layer(out2, m, m, cache=static)
        assert cache.k.shape[1] == 6
        return out + out3

    check(rl, pl, [x, mem], call=incremental)


def test_multihead_attention_need_weights():
    rl, pl = both(lambda nn: nn.MultiHeadAttention(32, 4,
                                                    need_weights=True))
    check(rl, pl, [rand(2, 3, 32)])
    _, w = pl(pt.to_tensor(rand(2, 3, 32)))
    np.testing.assert_allclose(w.numpy().sum(-1), 1.0, rtol=1e-6)


def _conv_net(nn):
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8),
                         nn.ReLU(), nn.MaxPool2D(2, 2),
                         nn.Conv2D(8, 4, 3, stride=2, padding="SAME"),
                         nn.AvgPool2D(2, 2, ceil_mode=True),
                         nn.AdaptiveAvgPool2D(1), nn.Flatten())


def test_conv_batchnorm_pool_train_then_eval():
    rl, pl = both(_conv_net)
    x = rand(4, 3, 9, 9) * 2 + 1
    check(rl, pl, [x])
    rsd, psd = rl.state_dict(), pl.state_dict()
    for k in ("1._mean", "1._variance"):          # the running statistics
        np.testing.assert_allclose(psd[k].numpy(), np.asarray(rsd[k]._data),
                                   rtol=1e-5, atol=1e-6)
        assert not np.allclose(psd[k].numpy(), 0.0 if "mean" in k else 1.0)
    rl.eval()
    pl.eval()
    np.testing.assert_allclose(pl(pt.to_tensor(x)).numpy(),
                               np.asarray(rl(ref.to_tensor(x))._data),
                               rtol=FWD, atol=FWD)


def test_sequential_state_dict_round_trip():
    rl, pl = both(lambda nn: nn.Sequential(
        nn.Linear(4, 8), nn.GELU(), nn.LayerNorm(8), nn.Linear(8, 3)))
    check(rl, pl, [rand(5, 4)])
    p2 = pnn.Sequential(pnn.Linear(4, 8), pnn.GELU(), pnn.LayerNorm(8),
                        pnn.Linear(8, 3))
    p2.set_state_dict(pl.state_dict())
    x = pt.to_tensor(rand(5, 4))
    np.testing.assert_array_equal(p2(x).numpy(), pl(x).numpy())
