"""The GQA f32 case of test_torch_train_fused.py (its rule, tolerances
and body), in a file of its own so that it runs on another worker.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from test_torch_train_fused import fused_flags  # noqa: F401
from test_torch_train_fused import \
    test_f32_fused_steps_match_reference as f32_case


@pytest.mark.parametrize("case", ["gqa-fused-ce"])
def test_f32_fused_steps_match_reference(fused_flags, case):  # noqa: F811
    f32_case(fused_flags, case)
