"""The plain-CE f32 case of test_torch_gpt.py's
`test_f32_gpt_steps_match_reference` (its rule, tolerances and body), in
a file of its own so that it runs on another worker.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from test_torch_gpt import fused_flags  # noqa: F401
from test_torch_gpt import test_f32_gpt_steps_match_reference as f32_case


@pytest.mark.parametrize("case", ["plain-ce"])
def test_f32_gpt_steps_match_reference(fused_flags, case):  # noqa: F811
    f32_case(fused_flags, case)
