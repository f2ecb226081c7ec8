"""The port's op table held to paddle_tpu's, forward (CPU).

`paddle_tpu_torch/ops/op_table*.py` copies the 418 rows of paddle_tpu's op
table (`DEFERRED` is empty). The 94 rows that reach `nn.functional`
(`NN_ROWS`) are held the same way in test_torch_op_table_nn.py, the 11
of the long tail (`TAIL_ROWS`: fft, signal, geometric, incubate,
text.viterbi) in test_torch_op_table_tail.py (tests/_torch_op_rows.py). Here: the copy's every field equals the reference's `OpSpec`,
the names partition the reference's, and each row's fp32 forward on the
same seeded numpy inputs equals paddle_tpu's output and the row's numpy
`ref` at the row's tolerance (dtype, shape and stop_gradient too); the
bf16 forward is held to the port's own fp32 at 5e-2, as
`tests/test_op_table_sweep.py` holds the reference. Gradients are in
`test_torch_op_table_grad.py`.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

import paddle_tpu_torch as pt
from _torch_op_rows import (check_forward_bf16, check_forward_fp32,
                            check_spec_copy)
from paddle_tpu.ops import op_table as ref_table
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.ops import op_table as port_table

ROWS = sorted(n for n in port_table.OPS if n not in port_table.NN_ROWS
              and n not in port_table.TAIL_ROWS)
BF16 = [n for n in ROWS if port_table.OPS[n].bf16]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = port_device._current
    pt.set_device("cpu")
    yield
    port_device._current = prev


def test_names_partition_the_reference_table():
    ported, deferred = set(port_table.OPS), set(port_table.DEFERRED)
    assert len(ported) == 418 and not deferred
    assert ported == set(ref_table.OPS)
    assert len(port_table.NN_ROWS) == 94 and port_table.NN_ROWS <= ported
    assert len(port_table.TAIL_ROWS) == 11 and port_table.TAIL_ROWS <= ported
    assert not port_table.NN_ROWS & port_table.TAIL_ROWS


@pytest.mark.parametrize("name", ROWS)
def test_spec_copy_equals_reference(name):
    check_spec_copy(name)


@pytest.mark.parametrize("name", ROWS)
def test_forward_fp32_matches_reference(name):
    check_forward_fp32(name)


@pytest.mark.parametrize("name", BF16)
def test_forward_bf16_tracks_fp32(name):
    check_forward_bf16(name)
