"""The second half of test_torch_op_table_tape_nn.py's rows (the
differentiable rows that reach `nn.functional`): each row's fp32 gradient
of `out.sum()` equals the reference tape's on the same seeded inputs
(tests/_torch_op_tape.py).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from _torch_op_tape import DIFF_NN, check_row, on_cpu_with_the_reference_tape

_setup = pytest.fixture(autouse=True, scope="module")(
    on_cpu_with_the_reference_tape)


@pytest.mark.parametrize("name", DIFF_NN[len(DIFF_NN) // 2:])
def test_grad_fp32_matches_the_reference_tape(name):
    check_row(name)
