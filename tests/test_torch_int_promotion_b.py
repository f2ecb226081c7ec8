"""F10 (ROADMAP.md Queue 3), the second half of the one-input rows of the
op table in name order: integer inputs promote as paddle_tpu's
(tests/_torch_int_sweep.py).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from _torch_int_sweep import (HALF, ONE_INPUT, check_row,
                              on_cpu_with_the_reference_tape)

_setup = pytest.fixture(autouse=True, scope="module")(
    on_cpu_with_the_reference_tape)


@pytest.mark.parametrize("name", ONE_INPUT[HALF:])
def test_integer_inputs_promote_as_the_reference(name):
    check_row(name)
