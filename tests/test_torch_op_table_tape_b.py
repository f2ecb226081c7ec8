"""The port's op table, gradients against paddle_tpu's tape (CPU), the
second half of the differentiable rows in name order: each row's fp32
gradient of `out.sum()` equals the reference tape's on the same seeded
inputs (tests/_torch_op_tape.py). Central differences through the port's
op are in test_torch_op_table_grad.py.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from _torch_op_tape import (DIFF, HALF, check_row,
                            on_cpu_with_the_reference_tape)

_setup = pytest.fixture(autouse=True, scope="module")(
    on_cpu_with_the_reference_tape)


@pytest.mark.parametrize("name", DIFF[HALF:])
def test_grad_fp32_matches_the_reference_tape(name):
    check_row(name)
