"""The op table's rows that reach `nn.functional` (`NN_ROWS`, ROADMAP.md
Queue 1 item 1e) held to paddle_tpu's, forward (CPU,
tests/_torch_op_rows.py): every copied `OpSpec` field, the fp32 forward
against the reference's output and the row's numpy `ref`, the bf16
forward against the port's fp32. Their gradients are in
test_torch_op_table_grad.py (central differences) and
test_torch_op_table_tape_nn.py (the reference's tape).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

import paddle_tpu_torch as pt
from _torch_op_rows import (check_forward_bf16, check_forward_fp32,
                            check_spec_copy)
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.ops import op_table as port_table

ROWS = sorted(port_table.NN_ROWS)
BF16 = [n for n in ROWS if port_table.OPS[n].bf16]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    prev = port_device._current
    pt.set_device("cpu")
    yield
    port_device._current = prev


@pytest.mark.parametrize("name", ROWS)
def test_spec_copy_equals_reference(name):
    check_spec_copy(name)


@pytest.mark.parametrize("name", ROWS)
def test_forward_fp32_matches_reference(name):
    check_forward_fp32(name)


@pytest.mark.parametrize("name", BF16)
def test_forward_bf16_tracks_fp32(name):
    check_forward_bf16(name)
