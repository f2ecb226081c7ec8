"""The bf16 O2 case of test_torch_bert.py's
`test_bert_steps_match_reference` (its rule and tolerance, its body), in a
file of its own so that the two cases run on different workers.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from test_torch_bert import test_bert_steps_match_reference as steps_case
from test_torch_gpt import fused_flags  # noqa: F401


@pytest.mark.parametrize("bf16,lr", [(True, 2e-5)], ids=["bf16-o2"])
def test_bert_steps_match_reference(fused_flags, bf16, lr):  # noqa: F811
    steps_case(fused_flags, bf16, lr)
