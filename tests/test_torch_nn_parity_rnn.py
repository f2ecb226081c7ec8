"""The port's recurrent layers held to paddle_tpu's (CPU), at a small size
(tests/_torch_nn_parity.py): 2-layer LSTM, GRU and SimpleRNN (one and
both directions, and with sequence lengths and initial states) and the
three cells.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest

from _torch_nn_parity import (both, check, on_cpu_with_the_reference_tape,
                              rand)

_setup = pytest.fixture(autouse=True, scope="module")(
    on_cpu_with_the_reference_tape)


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
def test_recurrent_layers(cls, direction):
    rl, pl = both(lambda nn: getattr(nn, cls)(6, 8, num_layers=2,
                                               direction=direction))
    check(rl, pl, [rand(3, 5, 6)])


@pytest.mark.parametrize("cls", ["LSTM", "GRU"])
def test_recurrent_layers_with_lengths_and_initial_states(cls):
    rl, pl = both(lambda nn: getattr(nn, cls)(6, 8, num_layers=2,
                                               direction="bidirect"))
    h0 = rand(4, 3, 8, seed=2)
    lens = np.array([5, 2, 4], "int64")

    def call(layer, x, h, n):
        init = (h, h * 0.5) if cls == "LSTM" else h
        out, _ = layer(x, init, sequence_length=n)
        return out

    check(rl, pl, [rand(3, 5, 6), h0, lens], grad=[True, True, False],
           call=call)


@pytest.mark.parametrize("cls", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_cells(cls):
    rl, pl = both(lambda nn: getattr(nn, cls)(6, 8))
    check(rl, pl, [rand(3, 6), rand(3, 8, seed=1)],
           call=lambda layer, x, h: layer(x, (h, h) if cls == "LSTMCell"
                                          else h)[0])
