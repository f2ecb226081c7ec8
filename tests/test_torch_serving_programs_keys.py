"""The second half of test_torch_serving_programs.py's program-key cases
(`test_program_keys_match_reference` over `_KEY_CASES[5:]`: the engine's
program keys, tokens and counters equal paddle_tpu's), in a file of its
own so that the halves run on different workers.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from test_torch_serving_programs import _KEY_CASES
from test_torch_serving_programs import \
    test_program_keys_match_reference as keys_case


@pytest.mark.parametrize("case", list(_KEY_CASES)[5:])
def test_program_keys_match_reference(case):
    keys_case(case)
