"""Recurrent layers: SimpleRNN, LSTM, GRU and their cells.

Port of paddle_tpu/nn/layer/rnn.py. The reference runs the whole sequence
as one `lax.scan` per layer and direction inside one op; the port runs
the same recurrence as a loop over time steps inside one op of the
Tensor API (torch autograd records it). Gates are the reference's (LSTM
i, f, g, o; GRU r, z, n with the reset gate on the hidden projection);
weights [gates * hidden, in]. With `sequence_length`, padded steps keep
the carry and emit zeros, and the reverse direction walks the padding
first, as the reference's masked scan does. The reference applies no
dropout between layers; neither does the port.
"""
from __future__ import annotations

import math

import torch

from ...core.dispatch import op
from ...ops.creation import zeros
from ..initializer import Uniform
from ..layer_base import Layer


def _lstm_step(carry, x, w_ih, w_hh, b_ih, b_hh):
    h, c = carry
    g = x @ w_ih.T + b_ih + h @ w_hh.T + b_hh
    i, f, gg, o = g.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return (h2, c2), h2


def _gru_step(carry, x, w_ih, w_hh, b_ih, b_hh):
    h = carry[0]
    ir, iz, inn = (x @ w_ih.T + b_ih).chunk(3, dim=-1)
    hr, hz, hn = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    h2 = (1 - z) * n + z * h
    return (h2,), h2


def _simple_step(act):
    def step(carry, x, w_ih, w_hh, b_ih, b_hh):
        h2 = act(x @ w_ih.T + b_ih + carry[0] @ w_hh.T + b_hh)
        return (h2,), h2

    return step


_STEPS = {"LSTM": _lstm_step, "GRU": _gru_step,
          "RNN_TANH": _simple_step(torch.tanh),
          "RNN_RELU": _simple_step(torch.relu)}


def _run(mode, num_layers, bidirect, hidden, time_major, x, init_h, init_c,
         lens, weights):
    """The stacked recurrence (module note): (out, h [L*D, B, H], c)."""
    step = _STEPS[mode]
    cell = mode == "LSTM"
    xt = x if time_major else x.transpose(0, 1)            # [T, B, C]
    T, b = xt.shape[0], xt.shape[1]
    wi = iter(weights)
    layer_in = xt
    last_h, last_c = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(bidirect):
            w = [next(wi) for _ in range(4)]
            li = layer * bidirect + d
            if init_h is not None:
                h0 = init_h[li].to(x.dtype)
                c0 = init_c[li].to(x.dtype) if cell else None
            else:
                h0 = x.new_zeros((b, hidden))
                c0 = torch.zeros_like(h0) if cell else None
            carry = (h0, c0) if cell else (h0,)
            seq = layer_in.flip(0) if d == 1 else layer_in
            if lens is not None:
                tidx = torch.arange(T, device=x.device)[:, None]
                valid = (tidx < lens[None, :]) if d == 0 else \
                    (tidx.flip(0) < lens[None, :])
            ys = []
            for t in range(T):
                new, y = step(carry, seq[t], *w)
                if lens is not None:
                    m = valid[t][:, None]
                    new = tuple(torch.where(m, n, o)
                                for n, o in zip(new, carry))
                    y = torch.where(m, y, 0.0)
                carry = new
                ys.append(y)
            ys = torch.stack(ys)
            outs.append(ys.flip(0) if d == 1 else ys)
            last_h.append(carry[0])
            if cell:
                last_c.append(carry[1])
        layer_in = torch.cat(outs, -1) if bidirect == 2 else outs[0]
    out = layer_in if time_major else layer_in.transpose(0, 1)
    if cell:
        return out, torch.stack(last_h), torch.stack(last_c)
    return out, torch.stack(last_h)


def _rnn_op(name):
    @op(name)
    def run(mode, num_layers, bidirect, hidden, time_major, x, init_h,
            init_c, lens, *weights):
        return _run(mode, num_layers, bidirect, hidden, time_major, x,
                    init_h, init_c, lens, weights)

    return run


_OPS = {m: _rnn_op(m.lower()) for m in _STEPS}


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        gates = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}[mode]
        self._all_weights = []
        std = 1.0 / math.sqrt(hidden_size)
        for layer in range(num_layers):
            for d in range(self.bidirect):
                in_sz = input_size if layer == 0 \
                    else hidden_size * self.bidirect
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                names = (f"weight_ih{sfx}", f"weight_hh{sfx}",
                         f"bias_ih{sfx}", f"bias_hh{sfx}")
                for n, shape, attr, bias in (
                        (names[0], (gates * hidden_size, in_sz),
                         weight_ih_attr, False),
                        (names[1], (gates * hidden_size, hidden_size),
                         weight_hh_attr, False),
                        (names[2], (gates * hidden_size,), bias_ih_attr,
                         True),
                        (names[3], (gates * hidden_size,), bias_hh_attr,
                         True)):
                    self.add_parameter(n, self.create_parameter(
                        shape, attr=attr, is_bias=bias,
                        default_initializer=Uniform(-std, std)))
                self._all_weights.append(names)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        cell = self.mode == "LSTM"
        init_h = init_c = None
        if initial_states is not None:
            if cell:
                init_h, init_c = initial_states[0], initial_states[1]
            else:
                init_h = initial_states[0] if isinstance(
                    initial_states, (list, tuple)) else initial_states
        flat = [getattr(self, n) for names in self._all_weights
                for n in names]
        res = _OPS[self.mode](self.mode, self.num_layers, self.bidirect,
                              self.hidden_size, self.time_major, inputs,
                              init_h, init_c, sequence_length, *flat)
        if cell:
            out, h, c = res
            return out, (h, c)
        return res


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("RNN_TANH" if activation == "tanh" else "RNN_RELU",
                         input_size, hidden_size, num_layers, direction,
                         time_major, dropout)


@op("lstm_cell")
def _lstm_cell(x, h, c, wi, wh, bi, bh):
    return _lstm_step((h, c), x, wi, wh, bi, bh)[0]


@op("gru_cell")
def _gru_cell(x, h, wi, wh, bi, bh):
    return _gru_step((h,), x, wi, wh, bi, bh)[1]


class LSTMCell(Layer):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__()
        std = 1.0 / math.sqrt(hidden_size)
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter(
            (4 * hidden_size, input_size),
            default_initializer=Uniform(-std, std))
        self.weight_hh = self.create_parameter(
            (4 * hidden_size, hidden_size),
            default_initializer=Uniform(-std, std))
        self.bias_ih = self.create_parameter((4 * hidden_size,), is_bias=True)
        self.bias_hh = self.create_parameter((4 * hidden_size,), is_bias=True)

    def forward(self, inputs, states=None):
        if states is None:
            b = inputs.shape[0]
            states = (zeros([b, self.hidden_size], dtype=inputs.dtype),
                      zeros([b, self.hidden_size], dtype=inputs.dtype))
        h2, c2 = _lstm_cell(inputs, states[0], states[1], self.weight_ih,
                            self.weight_hh, self.bias_ih, self.bias_hh)
        return h2, (h2, c2)


class GRUCell(Layer):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__()
        std = 1.0 / math.sqrt(hidden_size)
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter(
            (3 * hidden_size, input_size),
            default_initializer=Uniform(-std, std))
        self.weight_hh = self.create_parameter(
            (3 * hidden_size, hidden_size),
            default_initializer=Uniform(-std, std))
        self.bias_ih = self.create_parameter((3 * hidden_size,), is_bias=True)
        self.bias_hh = self.create_parameter((3 * hidden_size,), is_bias=True)

    def forward(self, inputs, states=None):
        if states is None:
            states = zeros([inputs.shape[0], self.hidden_size],
                           dtype=inputs.dtype)
        h2 = _gru_cell(inputs, states, self.weight_ih, self.weight_hh,
                       self.bias_ih, self.bias_hh)
        return h2, h2
