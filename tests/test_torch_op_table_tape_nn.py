"""The port's op table, gradients against paddle_tpu's tape (CPU), the
differentiable rows that reach `nn.functional` (`NN_ROWS`, ROADMAP.md
Queue 1 item 1e): each row's fp32 gradient of `out.sum()` equals the
reference tape's on the same seeded inputs (tests/_torch_op_tape.py).
"""
import pytest

from _torch_op_tape import DIFF_NN, check_row, on_cpu_with_the_reference_tape

_setup = pytest.fixture(autouse=True, scope="module")(
    on_cpu_with_the_reference_tape)


@pytest.mark.parametrize("name", DIFF_NN)
def test_grad_fp32_matches_the_reference_tape(name):
    check_row(name)
