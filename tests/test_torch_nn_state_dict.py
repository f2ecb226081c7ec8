"""The port's nn exports and every layer class's `state_dict` (keys,
shapes and dtypes) beside paddle_tpu's (CPU).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

import paddle_tpu.nn as rnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.core import device as port_device


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = port_device._current
    pt.set_device("cpu")
    yield
    port_device._current = prev


def test_exports_are_the_references():
    want = {n for n in dir(rnn) if n[0].isupper()}
    assert want <= {n for n in dir(pnn) if n[0].isupper()}
    fwant = {n for n in dir(rnn.functional) if not n.startswith("_")
             and getattr(getattr(rnn.functional, n), "__module__",
                         "").startswith("paddle_tpu.nn")}
    missing = {n for n in fwant if not hasattr(PF, n)}
    assert not missing, missing
    assert pt.save and pt.load and pt.ParamAttr


#: every layer class that holds parameters or buffers, with its arguments
LAYERS = {
    "Linear": (4, 3), "Embedding": (10, 4), "Bilinear": (3, 4, 5),
    "Conv1D": (3, 4, 3), "Conv2D": (3, 4, 3), "Conv3D": (2, 3, 2),
    "Conv2DTranspose": (3, 4, 3), "Conv3DTranspose": (2, 3, 2),
    "BatchNorm": (4,), "BatchNorm1D": (4,), "BatchNorm2D": (4,),
    "BatchNorm3D": (4,), "SyncBatchNorm": (4,), "LayerNorm": (8,),
    "RMSNorm": (8,), "GroupNorm": (2, 4), "InstanceNorm1D": (4,),
    "InstanceNorm2D": (4,), "InstanceNorm3D": (4,),
    "SpectralNorm": ([4, 3],), "PReLU": (3,),
    "MultiHeadAttention": (8, 2), "TransformerEncoderLayer": (8, 2, 16),
    "TransformerDecoderLayer": (8, 2, 16),
    "Transformer": (8, 2, 1, 1, 16), "LSTM": (3, 4, 2, "bidirect"),
    "GRU": (3, 4, 2), "SimpleRNN": (3, 4), "LSTMCell": (3, 4),
    "GRUCell": (3, 4), "SimpleRNNCell": (3, 4), "HSigmoidLoss": (4, 6),
    "AdaptiveLogSoftmaxWithLoss": (8, 20, [4, 12]),
}
#: classes without parameters (their state_dict is empty in both)
PLAIN = {
    "ReLU": (), "GELU": (), "Softmax": (), "Dropout": (0.5,),
    "Flatten": (), "Identity": (), "MaxPool2D": (2,), "AvgPool2D": (2,),
    "AdaptiveAvgPool2D": (1,), "Upsample": (None, 2.0), "Pad2D": (1,),
    "CrossEntropyLoss": (), "MSELoss": (), "CTCLoss": (), "Fold": (4, 2),
    "Unfold": (2,), "PixelShuffle": (2,), "LocalResponseNorm": (3,),
    "ZeroPad3D": (1,), "Softmax2D": (), "Maxout": (2,),
}


def _sd(pkg_nn, name, args):
    layer = getattr(pkg_nn, name)(*args)
    return {k: (list(v.shape), str(v.dtype))
            for k, v in layer.state_dict().items()}


@pytest.mark.parametrize("name", sorted(LAYERS) + sorted(PLAIN))
def test_state_dict_keys_shapes_and_dtypes(name):
    """(The reference's Embedding with a padding_idx fails on this jax,
    writing into a read-only numpy view; the port's zeroes the row, and
    `test_embedding_padding_row` holds it.)"""
    args = LAYERS.get(name, PLAIN.get(name))
    want = _sd(rnn, name, args)
    got = _sd(pnn, name, args)
    assert list(got) == list(want)
    assert got == want
    assert bool(want) == (name in LAYERS)
