"""The long tail of the nn layers.

Port of paddle_tpu/nn/layer/extended.py: Softmax2D, ChannelShuffle, the
1-D and 3-D zero pads, Fold / Unfold, PairwiseDistance,
FeatureAlphaDropout, LPPool*, MaxUnPool*, FractionalMaxPool*,
Conv3DTranspose, the loss-zoo layers (CTC, RNN-T, HSigmoid,
AdaptiveLogSoftmaxWithLoss, ...), the RNN cell infrastructure (RNNCellBase,
SimpleRNNCell, RNN, BiRNN) and beam search (BeamSearchDecoder,
dynamic_decode). Each wraps its `nn.functional` op or composes the cells.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import op
from ...core.tensor import Tensor
from .. import functional as F
from ..initializer import Uniform
from ..layer_base import Layer


# ----------------------------------------------------------------- activations
class Softmax2D(Layer):
    """Softmax over the channel axis of [C, H, W] or [N, C, H, W]."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError("Softmax2D expects 3-D or 4-D input")
        return F.softmax(x, axis=-3)


# ---------------------------------------------------------------- shape layers
class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


@op("zeropad1d")
def _zeropad1d(x, pl, pr, data_format):
    return TF.pad(x, (pl, pr) if data_format == "NCL" else (0, 0, pl, pr))


@op("zeropad3d")
def _zeropad3d(x, padding, data_format):
    pl, pr, pt, pb, pf, pk = padding
    if data_format == "NCDHW":
        return TF.pad(x, (pl, pr, pt, pb, pf, pk))
    return TF.pad(x, (0, 0, pl, pr, pt, pb, pf, pk))


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding = padding if isinstance(padding, (list, tuple)) \
            else (padding, padding)
        self.data_format = data_format

    def forward(self, x):
        pl, pr = self.padding
        return _zeropad1d(x, pl, pr, self.data_format)


class ZeroPad3D(Layer):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        if isinstance(padding, int):
            padding = (padding,) * 6
        self.padding = tuple(padding)
        self.data_format = data_format

    def forward(self, x):
        return _zeropad3d(x, self.padding, self.data_format)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.a = (output_sizes, kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, *self.a)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.a = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.a)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, self.training)


# -------------------------------------------------------------------- pooling
class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.a = (norm_type, kernel_size, stride, padding, ceil_mode,
                  data_format)

    def forward(self, x):
        return F.lp_pool1d(x, *self.a)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.a = (norm_type, kernel_size, stride, padding, ceil_mode,
                  data_format)

    def forward(self, x):
        return F.lp_pool2d(x, *self.a)


class _MaxUnPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, os_ = self.a
        return type(self)._fn(x, indices, k, s, p, df or self._format, os_)


class MaxUnPool1D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool1d)
    _format = "NCL"


class MaxUnPool2D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool2d)
    _format = "NCHW"


class MaxUnPool3D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool3d)
    _format = "NCDHW"


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        return F.fractional_max_pool2d(x, *self.a)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        return F.fractional_max_pool3d(x, *self.a)


# ----------------------------------------------------------------------- conv
class Conv3DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__()
        ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * 3
        std = 1.0 / math.sqrt(in_channels * int(np.prod(ks)))
        self.weight = self.create_parameter(
            (in_channels, out_channels // groups) + tuple(ks),
            default_initializer=Uniform(-std, std), attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_channels,), is_bias=True,
            default_initializer=Uniform(-std, std), attr=bias_attr)
        self.a = (stride, padding, output_padding, groups, dilation,
                  data_format)

    def forward(self, x, output_size=None):
        s, p, op_, g, d, df = self.a
        return F.conv3d_transpose(x, self.weight, self.bias, s, p, op_, g, d,
                                  df, output_size)


# ---------------------------------------------------------------------- losses
class _FnLoss(Layer):
    def __init__(self, fn, **kw):
        super().__init__()
        self._fn, self._kw = fn, kw

    def forward(self, *args):
        return self._fn(*args, **self._kw)


class SoftMarginLoss(_FnLoss):
    def __init__(self, reduction="mean", name=None):
        super().__init__(F.soft_margin_loss, reduction=reduction)


class MultiLabelSoftMarginLoss(_FnLoss):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(F.multi_label_soft_margin_loss, weight=weight,
                         reduction=reduction)


class MultiMarginLoss(_FnLoss):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(F.multi_margin_loss, p=p, margin=margin,
                         weight=weight, reduction=reduction)


class PoissonNLLLoss(_FnLoss):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(F.poisson_nll_loss, log_input=log_input, full=full,
                         epsilon=epsilon, reduction=reduction)


class GaussianNLLLoss(_FnLoss):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__(F.gaussian_nll_loss, full=full, epsilon=epsilon,
                         reduction=reduction)


class TripletMarginWithDistanceLoss(_FnLoss):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__(F.triplet_margin_with_distance_loss,
                         distance_function=distance_function, margin=margin,
                         swap=swap, reduction=reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean", name=None):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           self.blank, self.fastemit_lambda, self.reduction)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        std = 1.0 / math.sqrt(feature_size)
        self.weight = self.create_parameter(
            (num_classes - 1, feature_size),
            default_initializer=Uniform(-std, std), attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_classes - 1, 1), is_bias=True, attr=bias_attr)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code)


@op("adaptive_log_prob")
def _adaptive_log_prob(x, hw, tails, hb, shortlist):
    head = x @ hw
    if hb is not None:
        head = head + hb
    head_lsm = torch.log_softmax(head, -1)
    parts = [head_lsm[:, :shortlist]]
    for i, (proj, cls_w) in enumerate(tails):
        tail_lsm = torch.log_softmax((x @ proj) @ cls_w, -1)
        parts.append(head_lsm[:, shortlist + i:shortlist + i + 1] + tail_lsm)
    return torch.cat(parts, -1)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """The factorized softmax head with frequency-ordered clusters."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if cutoffs != sorted(cutoffs) or min(cutoffs) <= 0 \
                or max(cutoffs) > n_classes - 1 \
                or len(set(cutoffs)) != len(cutoffs):
            raise ValueError("cutoffs should be a sorted list of unique "
                             "positive integers < n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        n_clusters = len(self.cutoffs) - 1
        head_size = self.cutoffs[0] + n_clusters
        std = 1.0 / math.sqrt(in_features)
        self.head_weight = self.create_parameter(
            (in_features, head_size), default_initializer=Uniform(-std, std))
        self.head_bias = self.create_parameter(
            (head_size,), is_bias=True) if head_bias else None
        self.tail_weights = []
        for i in range(n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            proj = self.create_parameter(
                (in_features, hsz), default_initializer=Uniform(-std, std))
            cls_w = self.create_parameter(
                (hsz, osz), default_initializer=Uniform(-std, std))
            self.add_parameter(f"tail_proj_{i}", proj)
            self.add_parameter(f"tail_cls_{i}", cls_w)
            self.tail_weights.append((proj, cls_w))

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights,
            self.cutoffs[:-1], self.head_bias)

    def log_prob(self, input):
        """The full [N, n_classes] log-probability table."""
        return _adaptive_log_prob(input, self.head_weight, self.tail_weights,
                                  self.head_bias, self.cutoffs[0])

    def predict(self, input):
        from ...ops.reduction import argmax

        return argmax(self.log_prob(input), axis=-1)


# ------------------------------------------------------------------- RNN infra
class RNNCellBase(Layer):
    """The initial-state helper of the cells."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        from ...ops.creation import full

        b = batch_ref.shape[batch_dim_idx]
        shape = shape or (self.hidden_size,)
        if isinstance(shape, int):
            shape = (shape,)
        return full([b, *shape], init_value, dtype or "float32")


@op("simple_rnn_cell")
def _simple_rnn_cell(x, h, wi, wh, bi, bh, activation):
    act = torch.tanh if activation == "tanh" else torch.relu
    return act(x @ wi.T + bi + h @ wh.T + bh)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.hidden_size = hidden_size
        self.activation = activation
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            (hidden_size, input_size), default_initializer=init,
            attr=weight_ih_attr)
        self.weight_hh = self.create_parameter(
            (hidden_size, hidden_size), default_initializer=init,
            attr=weight_hh_attr)
        self.bias_ih = self.create_parameter(
            (hidden_size,), is_bias=True, default_initializer=init,
            attr=bias_ih_attr)
        self.bias_hh = self.create_parameter(
            (hidden_size,), is_bias=True, default_initializer=init,
            attr=bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, dtype=inputs.dtype)
        h2 = _simple_rnn_cell(inputs, states, self.weight_ih, self.weight_hh,
                              self.bias_ih, self.bias_hh, self.activation)
        return h2, h2

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """Run a cell over time, step by step."""

    def __init__(self, cell, is_reverse=False, time_major=False, name=None):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        from ...ops.manipulation import stack

        t_axis = 0 if self.time_major else 1
        T = inputs.shape[t_axis]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        states = initial_states
        outs = [None] * T
        for t in steps:
            x_t = inputs[:, t] if t_axis == 1 else inputs[t]
            y, states = self.cell(x_t, states, **kwargs)
            outs[t] = y
        return stack(outs, axis=t_axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False, name=None):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        from ...ops.manipulation import concat

        st_fw, st_bw = (initial_states if initial_states is not None
                        else (None, None))
        out_fw, s_fw = self.rnn_fw(inputs, st_fw, sequence_length, **kwargs)
        out_bw, s_bw = self.rnn_bw(inputs, st_bw, sequence_length, **kwargs)
        return concat([out_fw, out_bw], axis=-1), (s_fw, s_bw)


# -------------------------------------------------------------- beam decoding
class BeamSearchDecoder:
    """Beam expansion around a cell, for `dynamic_decode`: log-prob
    accumulation, no length normalization, end-token finishing (the
    reference's subset)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states, batch_size):
        from ...ops.creation import full, zeros

        k = self.beam_size
        ids = full([batch_size, k], self.start_token, "int64")
        log_probs = Tensor(np.tile(np.array([[0.0] + [-1e9] * (k - 1)],
                                            "float32"), (batch_size, 1)))
        finished = zeros([batch_size, k], dtype="bool")
        return ids, log_probs, finished, initial_cell_states

    def step(self, inputs, states):
        return self.cell(inputs, states)


def dynamic_decode(decoder, inits=None, max_step_num=None, batch_size=None,
                   output_time_major=False, **kwargs):
    """The beam loop over a fixed number of steps, stopping when every
    beam has emitted the end token."""
    from ...ops.manipulation import stack
    from ...ops.reduction import topk

    ids, log_probs, finished, cell_states = decoder.initialize(
        inits, batch_size or 1)
    b, k = ids.shape[0], decoder.beam_size

    def gather_beams(obj, parent):
        if isinstance(obj, Tensor):
            if obj.ndim >= 2 and obj.shape[0] == b and obj.shape[1] == k:
                return stack([obj[i][parent[i]] for i in range(b)], axis=0)
            if obj.ndim >= 1 and obj.shape[0] == b * k:
                re = obj.reshape([b, k] + list(obj.shape[1:]))
                return gather_beams(re, parent).reshape(list(obj.shape))
            return obj
        if isinstance(obj, (tuple, list)):
            return type(obj)(gather_beams(o, parent) for o in obj)
        return obj

    step_outputs = []
    cur = ids
    for _ in range(max_step_num or 32):
        flat = cur.reshape([b * k])
        emb = decoder.embedding_fn(flat) if decoder.embedding_fn else flat
        out, cell_states = decoder.step(emb, cell_states)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        lsm = F.log_softmax(logits, axis=-1)
        v = lsm.shape[-1]
        total = (log_probs.reshape([b * k, 1]) + lsm).reshape([b, k * v])
        top_v, top_i = topk(total, k, axis=-1)
        parent = (top_i // v).numpy()
        cur = top_i % v
        log_probs = top_v
        step_outputs = [gather_beams(s, parent) for s in step_outputs]
        cell_states = gather_beams(cell_states, parent)
        finished = gather_beams(finished, parent) | (cur == decoder.end_token)
        step_outputs.append(cur)
        if finished.numpy().all():
            break
    return stack(step_outputs, axis=0 if output_time_major else 1), log_probs
