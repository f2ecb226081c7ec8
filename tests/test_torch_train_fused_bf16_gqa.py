"""The bf16 O2 GQA case of test_torch_train_fused.py (its rule,
tolerance and body), in a file of its own so that it runs on another
worker.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from test_torch_train_fused import fused_flags  # noqa: F401
from test_torch_train_fused import bf16_o2_losses_held


@pytest.mark.parametrize("case", ["gqa-fused-ce"])
def test_bf16_o2_fused_losses_match_reference(fused_flags,  # noqa: F811
                                              case):
    bf16_o2_losses_held(case)
