"""GPT's and BERT's Layer models against paddle_tpu's: logits, loss and
every gradient on the same weights, with FLAGS_pallas_fused_ops on and
off (CPU, f32; the rule and tolerances of
test_torch_models_layer_grads.py, whose helpers this file shares).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import pytest

from test_torch_models_layer_grads import (both_flags,  # noqa: F401
                                           held_to_reference)


@pytest.mark.parametrize("arch", ["gpt", "bert"])
def test_logits_loss_and_grads_match_reference(both_flags, arch):
    held_to_reference(arch)
