"""One O1 step of tiny GPT and BERT against paddle_tpu's: the body and
tolerance of test_torch_amp.py's `o1_gpt_and_bert_step`, in a file of its
own so that it runs on another worker than the rest of the AMP tests.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)

from test_torch_amp import o1_gpt_and_bert_step, ref_vjp  # noqa: F401


def test_o1_gpt_and_bert_step_as_reference(ref_vjp):  # noqa: F811
    o1_gpt_and_bert_step(ref_vjp)
