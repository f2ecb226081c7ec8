"""The bf16 O2 cases of test_torch_gpt.py (`bf16_o2_losses_held`: the
loss at every step within 5e-3 relative), in a file of their own so that
they run on another worker.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from test_torch_gpt import CASES, bf16_o2_losses_held
from test_torch_gpt import fused_flags  # noqa: F401


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_o2_gpt_losses_match_reference(fused_flags,  # noqa: F811
                                            case):
    bf16_o2_losses_held(case)
