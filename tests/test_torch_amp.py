"""The port's AMP (`amp.auto_cast` at O1 and O2, custom lists, `decorate`,
recompute under O1, `amp.debugging`) against paddle_tpu's.

Both packages see the same numpy inputs. Op by op, the output dtype of
`auto_cast` at O1 and O2 must be the reference's, with its WHITE_LIST /
BLACK_LIST and the custom lists deciding. Whole models: a tiny LLaMA with
f32 parameters trains three AdamW steps under `auto_cast(O1, bfloat16)`
with `FLAGS_pallas_fused_ops` on and off, and tiny GPT and BERT take one
O1 step, each from the reference's weights: losses within 5e-3 relative
(the bound the bf16 O2 parity tests use: the two packages round bf16
products at different places). The reference runs its eager VJPs
directly (`FLAGS_eager_defer_vjp=False`: its deferred-VJP liveness pass
reads `jax.core.Var`, which this jax no longer has).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as pnn
import paddle_tpu.nn.functional as PF
from paddle_tpu.ops import pallas_norm as pn
from paddle_tpu.text.models import LlamaForCausalLM as PLlama
from paddle_tpu.text.models.llama import llama_tiny_config as p_tiny

from paddle_tpu_torch import amp
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                          llama_from_numpy,
                                          llama_tiny_config)

LOSS_TOL = 5e-3


@pytest.fixture
def ref_vjp():
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    paddle.set_flags(old)


@pytest.fixture
def both_flags(request):
    """FLAGS_pallas_fused_ops on both sides (the reference's norm kernels
    in interpret mode when on)."""
    on = request.param
    old = paddle.get_flags(["FLAGS_pallas_fused_ops",
                            "FLAGS_eager_defer_vjp"])
    port_old = flag("FLAGS_pallas_fused_ops")
    paddle.set_flags({"FLAGS_pallas_fused_ops": on,
                      "FLAGS_eager_defer_vjp": False})
    set_flags({"FLAGS_pallas_fused_ops": on})
    pn.FORCE_PALLAS = True if on else None
    yield on
    pn.FORCE_PALLAS = None
    paddle.set_flags(old)
    set_flags({"FLAGS_pallas_fused_ops": port_old})


def _dt(t):
    return str(t.dtype).replace("torch.", "").replace("paddle.", "")


def _ops(lib, x, w, y):
    """name -> a function of (x, w, y) in package `lib` ("ref"/"port")."""
    if lib == "ref":
        return {
            "matmul": lambda: paddle.matmul(x, w),
            "linear": lambda: PF.linear(x, w),
            "softmax": lambda: PF.softmax(x),
            "sum": lambda: x.sum(),
            "exp": lambda: paddle.exp(x),
            "layer_norm": lambda: PF.layer_norm(x, [4]),
            "cross_entropy": lambda: PF.cross_entropy(x, y),
            "add": lambda: x + x,
        }
    F = torch.nn.functional
    return {
        "matmul": lambda: torch.matmul(x, w),
        "linear": lambda: F.linear(x, w.T),
        "softmax": lambda: F.softmax(x, -1),
        "sum": lambda: x.sum(),
        "exp": lambda: torch.exp(x),
        "layer_norm": lambda: F.layer_norm(x, [4]),
        "cross_entropy": lambda: F.cross_entropy(x, y),
        "add": lambda: x + x,
    }


def _dtypes(level, white=None, black=None, enable=True):
    rs = np.random.RandomState(0)
    xn, wn = rs.rand(3, 4).astype("float32"), rs.rand(4, 4).astype("float32")
    yn = rs.randint(0, 4, (3,))
    out = {}
    for lib, ctx, conv in (
            ("ref", paddle.amp.auto_cast, paddle.to_tensor),
            ("port", amp.auto_cast, torch.from_numpy)):
        ops = _ops(lib, conv(xn), conv(wn), conv(yn))
        with ctx(enable=enable, custom_white_list=white,
                 custom_black_list=black, level=level, dtype="bfloat16"):
            out[lib] = {n: _dt(f()) for n, f in ops.items()}
    return out


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_op_dtypes_match_reference(level):
    got = _dtypes(level)
    assert got["port"] == got["ref"]
    if level == "O1":
        assert got["port"]["matmul"] == "bfloat16"
        assert got["port"]["softmax"] == got["port"]["add"] == "float32"
    else:
        assert got["port"]["add"] == "bfloat16"
        assert got["port"]["sum"] == "float32"


@pytest.mark.parametrize("white,black", [
    (None, ["matmul"]), (["exp", "sum"], None), (["add"], ["linear"])],
    ids=["black-matmul", "white-exp-sum", "both"])
def test_custom_lists_match_reference(white, black):
    for level in ("O1", "O2"):
        got = _dtypes(level, white, black)
        assert got["port"] == got["ref"], level


def test_disabled_is_noop():
    got = _dtypes("O1", enable=False)
    assert got["port"] == got["ref"]
    assert set(got["port"].values()) == {"float32"}
    # and no mode is installed: a plain call after the context is f32
    x = torch.rand(2, 2)
    with amp.auto_cast(enable=False):
        assert not torch.overrides._is_torch_function_mode_enabled() \
            or (x @ x).dtype == torch.float32


def test_grads_arrive_in_param_dtype(ref_vjp):
    rs = np.random.RandomState(1)
    xn = rs.rand(2, 8).astype("float32")
    ref = pnn.Linear(8, 8)
    port = torch.nn.Linear(8, 8)
    with paddle.amp.auto_cast(enable=True, dtype="bfloat16", level="O1"):
        rl = ref(paddle.to_tensor(xn)).sum()
    rl.backward()
    with amp.auto_cast(enable=True, dtype="bfloat16", level="O1"):
        out = port(torch.from_numpy(xn))
    assert out.dtype == torch.bfloat16
    out.sum().backward()
    assert "float32" in str(ref.weight.grad.dtype)
    assert port.weight.grad.dtype == port.bias.grad.dtype == torch.float32


def test_decorate_save_dtype():
    ref = pnn.Linear(4, 4)
    paddle.amp.decorate(ref, level="O1", save_dtype="float16")
    port = torch.nn.Linear(4, 4)
    amp.decorate(port, level="O1", save_dtype="float16")
    assert {str(np.asarray(v._data).dtype) if hasattr(v, "_data")
            else str(v.dtype) for v in ref.state_dict().values()} \
        == {"float16"}
    assert {v.dtype for v in port.state_dict().values()} == {torch.float16}
    # the training dtypes are untouched
    assert port.weight.dtype == torch.float32


def test_recompute_sees_the_forwards_amp_state():
    """Under O1 the recomputed block's second forward runs under the
    forward's AMP state, restored in the backward (which runs outside the
    context): its gradients are those of the same block without
    recompute, bit for bit, and the block's output is bf16."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(16, 16)
    x = torch.randn(4, 16, requires_grad=True)

    def block(t):
        return torch.nn.functional.softmax(lin(t).float(), -1) * lin(t)

    grads = []
    for use in (True, False):
        with amp.auto_cast(enable=True, dtype="bfloat16", level="O1"):
            y = recompute(block, x) if use else block(x)
        assert y.dtype == torch.float32
        y.square().sum().backward()
        grads.append([t.grad.clone() for t in (x, lin.weight, lin.bias)])
        for t in (x, lin.weight, lin.bias):
            t.grad = None
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _llama_o1(kw, steps=3):
    paddle.seed(0)
    ref = PLlama(p_tiny(**kw))
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    port = llama_from_numpy(llama_tiny_config(**kw), state, device="cpu")
    ropt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=ref.parameters())
    popt = AdamW(learning_rate=1e-3, parameters=port.parameters())
    ids = np.random.RandomState(0).randint(0, kw.get("vocab_size", 256),
                                           (2, 33))
    x, tx = paddle.to_tensor(ids), torch.from_numpy(ids)
    losses = {"ref": [], "port": []}
    for _ in range(steps):
        with paddle.amp.auto_cast(enable=True, dtype="bfloat16",
                                  level="O1"):
            loss = ref(x, x)
        loss.backward()
        ropt.step()
        ropt.clear_grad()
        with amp.auto_cast(enable=True, dtype="bfloat16", level="O1"):
            ploss = port(tx, labels=tx)
        ploss.backward()
        popt.step()
        popt.clear_grad()
        losses["ref"].append(float(np.asarray(loss._data)))
        losses["port"].append(ploss.item())
    return losses, port


@pytest.mark.parametrize("both_flags", [True, False], indirect=True,
                         ids=["fused", "plain"])
def test_tiny_llama_o1_trains_as_reference(both_flags):
    losses, port = _llama_o1({})
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=LOSS_TOL)
    assert losses["port"][-1] < losses["port"][0]
    assert {p.dtype for p in port.parameters()} == {torch.float32}


def test_o1_op_stats_of_a_llama_forward():
    """amp.debugging counts each op the rule sees by output dtype: under
    O1 the matmuls run in bf16, the norms and the loss in f32."""
    torch.manual_seed(0)
    model = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    ids = torch.randint(0, 256, (2, 17))
    with amp.debugging.collect_operator_stats() as stats:
        with amp.auto_cast(enable=True, dtype="bfloat16", level="O1"):
            model(ids, labels=ids)
    assert set(stats["linear"]) == {"bfloat16"}
    assert set(stats["scaled_dot_product_attention"]) == {"bfloat16"}
    assert set(stats["rms_norm"]) == {"float32"}
    assert set(stats["cross_entropy"]) == {"float32"}
    rep = amp.debugging.compare_accuracy(
        lambda t: model(t), (ids,), dtype="bfloat16", level="O1",
        rtol=0.1, atol=0.1)
    assert rep[0]["max_abs"] > 0


def test_o2_models_same_with_mode_on_and_suspended():
    """The models run their forward with the AMP mode suspended at O2
    (`amp.SUSPEND_O2_IN_MODELS`): with the mode on instead, a bf16 O2
    tiny LLaMA gives the same loss dtype and value and the same gradient
    dtypes and values."""
    out = []
    for suspend in (True, False):
        torch.manual_seed(0)
        model = LlamaForCausalLM(llama_tiny_config(), device="cpu")
        model = amp.decorate(model, level="O2", dtype="bfloat16")
        ids = torch.randint(0, 256, (2, 17), generator=torch.Generator()
                            .manual_seed(3))
        old = amp.SUSPEND_O2_IN_MODELS
        amp.SUSPEND_O2_IN_MODELS = suspend
        try:
            with amp.auto_cast(enable=True, dtype="bfloat16", level="O2"):
                loss = model(ids, labels=ids)
        finally:
            amp.SUSPEND_O2_IN_MODELS = old
        loss.backward()
        out.append((loss.dtype, loss.item(),
                    [(p.grad.dtype, p.grad._data.clone()) for p in
                     model.parameters()]))
    (d0, l0, g0), (d1, l1, g1) = out
    assert d0 == d1 == torch.float32 and l0 == l1
    for (da, a), (db, b) in zip(g0, g1):
        assert da == db and torch.equal(a, b)


def test_o1_gpt_and_bert_step_as_reference(ref_vjp):
    """One O1 step of tiny GPT and BERT (f32 parameters, the plain paths
    on both sides) from the reference's weights: the losses within
    LOSS_TOL, and the port's update applied."""
    from paddle_tpu.text.models import BertConfig as PBertConfig
    from paddle_tpu.text.models import (BertForSequenceClassification as
                                        PBert)
    from paddle_tpu.text.models.gpt import GPTConfig as PGPTConfig
    from paddle_tpu.text.models.gpt import GPTForCausalLM as PGPT

    from paddle_tpu_torch.text.models import (BertConfig, GPTConfig,
                                              bert_from_numpy,
                                              gpt_from_numpy)

    old = paddle.get_flags(["FLAGS_pallas_fused_ops"])
    port_old = flag("FLAGS_pallas_fused_ops")
    paddle.set_flags({"FLAGS_pallas_fused_ops": False})
    set_flags({"FLAGS_pallas_fused_ops": False})
    try:
        rs = np.random.RandomState(0)
        ids = rs.randint(0, 256, (2, 16))
        lab = rs.randint(0, 2, (2,))
        tiny = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=64)
        paddle.seed(0)
        rg = PGPT(PGPTConfig(**tiny))
        pg = gpt_from_numpy(GPTConfig(**tiny), {
            k: np.asarray(v._data) for k, v in rg.state_dict().items()},
            device="cpu")
        paddle.seed(0)
        btiny = dict(tiny, intermediate_size=128)
        rb = PBert(PBertConfig(**btiny, hidden_dropout_prob=0.0))
        pb = bert_from_numpy(BertConfig(**btiny, hidden_dropout_prob=0.0), {
            k: np.asarray(v._data) for k, v in rb.state_dict().items()},
            device="cpu")
        for ref, port, rloss, ploss in (
                (rg, pg, lambda m: m(paddle.to_tensor(ids),
                                     paddle.to_tensor(ids)),
                 lambda m: m(torch.from_numpy(ids),
                             labels=torch.from_numpy(ids))),
                (rb, pb, lambda m: m(paddle.to_tensor(ids),
                                     labels=paddle.to_tensor(lab)),
                 lambda m: m(torch.from_numpy(ids),
                             labels=torch.from_numpy(lab)))):
            ropt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                          parameters=ref.parameters())
            popt = AdamW(learning_rate=1e-3, parameters=port.parameters())
            before = [p._data.detach().clone() for p in port.parameters()]
            with paddle.amp.auto_cast(enable=True, dtype="bfloat16",
                                      level="O1"):
                loss = rloss(ref)
            loss.backward()
            ropt.step()
            with amp.auto_cast(enable=True, dtype="bfloat16", level="O1"):
                pl = ploss(port)
            pl.backward()
            popt.step()
            np.testing.assert_allclose(pl.item(), float(np.asarray(
                loss._data)), rtol=LOSS_TOL)
            assert any(not torch.equal(a, p._data) for a, p in
                       zip(before, port.parameters()))
    finally:
        paddle.set_flags(old)
        set_flags({"FLAGS_pallas_fused_ops": port_old})


def test_residual_dtype_bfloat16_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        set_flags({"FLAGS_residual_dtype": "bfloat16"})
    assert flag("FLAGS_residual_dtype") == "float32"
