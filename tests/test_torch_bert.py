"""The port's BERT fine-tuning step against paddle_tpu's: the BERT slice
as a whole.

Tiny BERT classifiers (hidden 64, 2 layers, 4 heads, intermediate 128,
sequence 16) are built in paddle_tpu and carried into the port with
`bert_from_numpy`; both take the same three AdamW steps on the same
seeded batch and binary labels, with `FLAGS_pallas_fused_ops` on and the
reference's Pallas kernels forced into interpret mode on the norm and
attention gates (the fixture of test_torch_gpt.py). Dropout masks come
from torch's generator in the port and JAX's in the reference, so the
parity runs use `hidden_dropout_prob=0.0`, where both skip dropout (the
reference's own early return, which the port keeps).

  * f32, lr 1e-3: the loss at every step within 1e-5 relative, the first
    gradients and the weights after three steps within 1e-4 of each
    tensor's largest |value| (the key bias, whose gradient is zero in
    exact arithmetic, as test_torch_gpt.NULL_GRAD says).
  * bf16 O2, at the reference configuration's fine-tuning rate 2e-5
    (`bench.py` `bench_bert`): the loss at every step within 5e-3
    relative. At 1e-3 the 4-example batch is fitted within three steps,
    and the steps after the first follow the signs of gradients that are
    sums cancelling to near zero (the embedding norm's bias, the key
    bias); bf16 rounding sets those signs differently on the two sides
    and AdamW turns each into a whole step. The f32 run holds the update
    itself.

With dropout 0.1 the port's flag-on run (K6's op) is held against its
flag-off run (the reference's composition) from one seeded generator.
Also: a boolean attention mask (the plain composition on both sides),
the numpy round trip.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models.bert import BertConfig as PBertConfig
from paddle_tpu.text.models.bert import \
    BertForSequenceClassification as PBert
from test_torch_gpt import (NULL_GRAD, check_f32,  # noqa: F401
                            fused_flags, reference_state, rel, train_both)

from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import (BertConfig,
                                          BertForSequenceClassification,
                                          bert_from_numpy, bert_to_numpy)

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64)
BATCH, SEQ = 4, 16


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (BATCH, SEQ)), rs.randint(0, 2, (BATCH,))


def _bert_pair(dropout=0.0):
    paddle.seed(0)
    ref = PBert(PBertConfig(**TINY, hidden_dropout_prob=dropout))
    port = bert_from_numpy(BertConfig(**TINY, hidden_dropout_prob=dropout),
                           reference_state(ref), device="cpu")
    return ref, port


@pytest.mark.parametrize("bf16,lr", [(False, 1e-3), (True, 2e-5)],
                         ids=["f32", "bf16-o2"])
def test_bert_steps_match_reference(fused_flags, bf16, lr):  # noqa: F811
    ref, port = _bert_pair()
    ids, lab = _batch()
    x, y = paddle.to_tensor(ids), paddle.to_tensor(lab)
    tx, ty = torch.from_numpy(ids), torch.from_numpy(lab)
    losses, grads = train_both(ref, port, lambda: ref(x, labels=y),
                               lambda: port(tx, labels=ty), bf16=bf16,
                               lr=lr)
    if bf16:
        np.testing.assert_allclose(losses["port"], losses["ref"], rtol=5e-3)
        assert losses["port"][-1] < losses["port"][0]
    else:
        check_f32(port, losses, grads, reference_state(ref),
                  bert_to_numpy(port))


def test_bert_dropout_flag_on_matches_flag_off():
    """hidden dropout 0.1, f32: three AdamW steps with the flag on (K3-LN
    and K6's ops) and off (the compositions), each from the default
    generator seeded alike, give the same losses (1e-5 relative) and
    weights (1e-4 of each tensor's largest |value|); dropout is live (the
    loss differs from the dropout-free one)."""
    _, port0 = _bert_pair(0.1)
    state = bert_to_numpy(port0)
    ids, lab = (torch.from_numpy(a) for a in _batch(1))
    old = flag("FLAGS_pallas_fused_ops")
    runs = []
    try:
        for fused in (True, False):
            set_flags({"FLAGS_pallas_fused_ops": fused})
            model = bert_from_numpy(BertConfig(**TINY,
                                               hidden_dropout_prob=0.1),
                                    state, device="cpu")
            opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
            torch.manual_seed(5)
            losses = []
            for _ in range(3):
                loss = model(ids, labels=lab)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.item())
            runs.append((losses, bert_to_numpy(model)))
        model.eval()
        with torch.no_grad():
            eval_loss = model(ids, labels=lab).item()
    finally:
        set_flags({"FLAGS_pallas_fused_ops": old})
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    for name, w in runs[0][1].items():
        if name.endswith(NULL_GRAD):     # see test_torch_gpt.NULL_GRAD
            assert np.abs(w - runs[1][1][name]).max() <= 2 * 3 * 1e-3
        else:
            assert rel(w, runs[1][1][name]) <= 1e-4, name
    assert eval_loss != pytest.approx(runs[1][0][-1], rel=1e-4)


def test_bert_attention_mask_matches_reference():
    """A boolean key mask takes the plain attention composition on both
    sides: the f32 logits agree within 1e-5 of their largest |value|, and
    differ from the unmasked ones."""
    ref, port = _bert_pair()
    ids, _ = _batch(2)
    keep = np.ones((BATCH, 1, 1, SEQ), dtype=bool)
    keep[:, :, :, 11:] = False
    want = np.asarray(ref(paddle.to_tensor(ids),
                          attn_mask=paddle.to_tensor(keep))._data)
    with torch.no_grad():
        got = port(torch.from_numpy(ids),
                   attn_mask=torch.from_numpy(keep)).numpy()
        free = port(torch.from_numpy(ids)).numpy()
    assert rel(got, want) <= 1e-5
    assert rel(free, want) > 1e-3


def test_bert_numpy_round_trip_and_device():
    ref, port = _bert_pair()
    state = reference_state(ref)
    back = bert_to_numpy(port)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
    assert port.device.type == "cpu"
    assert BertConfig().hidden_dropout_prob == 0.1
