"""The op table's rows of the long tail (`TAIL_ROWS`, ROADMAP.md Queue 1
item 1f: fft, signal, geometric, incubate, text.viterbi) held to
paddle_tpu's (CPU): every copied `OpSpec` field, the fp32 forward against
the reference's output and the row's numpy `ref`, the bf16 forward
against the port's fp32 where the row takes bf16
(tests/_torch_op_rows.py), and each differentiable row's fp32 gradient
of `out.sum()` against the reference's tape (tests/_torch_op_tape.py;
central differences in test_torch_op_table_grad.py).
"""
import pytest

from _torch_op_rows import (check_forward_bf16, check_forward_fp32,
                            check_spec_copy)
from _torch_op_tape import (DIFF_TAIL, check_row,
                            on_cpu_with_the_reference_tape)
from paddle_tpu_torch.ops import op_table as port_table

ROWS = sorted(port_table.TAIL_ROWS)
BF16 = [n for n in ROWS if port_table.OPS[n].bf16]

_setup = pytest.fixture(autouse=True, scope="module")(
    on_cpu_with_the_reference_tape)


@pytest.mark.parametrize("name", ROWS)
def test_spec_copy_equals_reference(name):
    check_spec_copy(name)


@pytest.mark.parametrize("name", ROWS)
def test_forward_fp32_matches_reference(name):
    check_forward_fp32(name)


@pytest.mark.parametrize("name", BF16)
def test_forward_bf16_tracks_fp32(name):
    check_forward_bf16(name)


@pytest.mark.parametrize("name", DIFF_TAIL)
def test_grad_fp32_matches_the_reference_tape(name):
    check_row(name)
