"""paddle_tpu_torch.nn: `Layer`, the layer zoo, `functional`,
`initializer`, `utils` and gradient clipping.

Port of paddle_tpu/nn/__init__.py, with the reference's exports.
"""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid, Hardswish,
    Hardtanh, LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU,
    ReLU6, RReLU, Sigmoid, SiLU, Softmax, Softplus, Softshrink, Softsign,
    Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .layer.common import (  # noqa: F401
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D, Dropout3D,
    Embedding, Flatten, Identity, Linear, Pad1D, Pad2D, Pad3D, PixelShuffle,
    PixelUnshuffle, Unflatten, Upsample, UpsamplingBilinear2D,
    UpsamplingNearest2D, ZeroPad2D)
from .layer.container import (LayerDict, LayerList,  # noqa: F401
                              ParameterDict, ParameterList, Sequential)
from .layer.conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                         Conv2DTranspose, Conv3D)
from .layer.extended import (  # noqa: F401
    RNN, AdaptiveLogSoftmaxWithLoss, BeamSearchDecoder, BiRNN,
    ChannelShuffle, Conv3DTranspose, CTCLoss, FeatureAlphaDropout, Fold,
    FractionalMaxPool2D, FractionalMaxPool3D, GaussianNLLLoss, HSigmoidLoss,
    LPPool1D, LPPool2D, MaxUnPool1D, MaxUnPool2D, MaxUnPool3D,
    MultiLabelSoftMarginLoss, MultiMarginLoss, PairwiseDistance,
    PoissonNLLLoss, RNNCellBase, RNNTLoss, SimpleRNNCell, Softmax2D,
    SoftMarginLoss, TripletMarginWithDistanceLoss, Unfold, ZeroPad1D,
    ZeroPad3D, dynamic_decode)
from .layer.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    HingeEmbeddingLoss, KLDivLoss, L1Loss, MarginRankingLoss, MSELoss,
    NLLLoss, SmoothL1Loss, TripletMarginLoss)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm, SyncBatchNorm)
from .layer.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .layer.rnn import GRU, LSTM, GRUCell, LSTMCell, SimpleRNN  # noqa: F401
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)
from .layer_base import Layer  # noqa: F401

from ..core.tensor import Parameter  # noqa: E402,F401

Silu = SiLU  # both spellings are exported by the reference


class ParamAttr:
    """paddle.ParamAttr: a parameter's name, initializer, learning-rate
    factor, regularizer and trainability."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


from . import utils  # noqa: E402,F401
