"""Activation recompute in the port against paddle_tpu's.

The reference's `TestFlashResidentRemat._grads` model (LLaMA, f32, 2
layers, hidden 64, 4 heads, vocab 256, ids [2, 128] from RandomState(0),
`loss = model(ids, ids)`) is built in paddle_tpu with `use_recompute` at
each granularity ("full", "mlp", "flash_resident") and without, its
weights carried into the port with `llama_from_numpy`:

  * the loss within 1e-5 relative and every parameter's gradient within
    1e-4 of the tensor's largest |value| of the reference's, with
    FLAGS_pallas_fused_ops on and off on both sides (the bounds of
    tests/test_torch_train.py: summation order through two layers);
  * the port's recompute runs against its own run without recompute:
    the loss within 1e-6 and the gradients within 1e-6 absolute (the
    reference's own test's bounds; the second forward repeats the
    first's arithmetic);
  * the policy proof: the flash forward op (`torch.ops.paddle_tpu_torch.
    flash_attention_fwd`, K1 on a card) runs L times a step under
    "flash_resident" and "mlp", 2L under "full";
  * bytes saved for the backward, seen by
    `torch.autograd.graph.saved_tensors_hooks` (unique storages packed
    during the forward): "full" and "flash_resident" save less than
    "mlp", "mlp" less than no recompute. Inside a recompute region
    torch's checkpoint packs its own placeholders, so these hooks see
    what autograd keeps outside the regions; the region's inputs and the
    flash outputs that "flash_resident" keeps are not in the count;
  * `recompute` itself: a plain call without a differentiable input or
    under no_grad, dropout inside a region, the policies "dots" and
    "nothing" and a callable, and the unknown-policy error.

The reference's eager backward runs with FLAGS_eager_defer_vjp=False
(its deferred-VJP pass reads `jax.core.Var`, which this jax no longer
has; the math is the same).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models import LlamaConfig as PLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as PLlamaForCausalLM

from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.distributed.fleet.utils import (_resolve_remat_policy,
                                                      recompute)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.text.models import llama_from_numpy, llama_tiny_config

GRANS = [None, "full", "mlp", "flash_resident"]
LAYERS = 2
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=LAYERS, num_attention_heads=4,
           max_position_embeddings=128)
IDS = np.random.RandomState(0).randint(0, 256, (2, 128))


@pytest.fixture
def flags(request):
    """Both packages' FLAGS_pallas_fused_ops set to the test's `fused`."""
    fused = request.param
    old = paddle.get_flags(["FLAGS_pallas_fused_ops",
                            "FLAGS_eager_defer_vjp"])
    port_old = flag("FLAGS_pallas_fused_ops")
    paddle.set_flags({"FLAGS_pallas_fused_ops": fused,
                      "FLAGS_eager_defer_vjp": False})
    set_flags({"FLAGS_pallas_fused_ops": fused})
    yield fused
    paddle.set_flags(old)
    set_flags({"FLAGS_pallas_fused_ops": port_old})


def _recompute_kw(gran):
    return dict(use_recompute=gran is not None,
                recompute_granularity=gran or "full")


def _reference_model(gran):
    paddle.seed(0)
    return PLlamaForCausalLM(PLlamaConfig(**CFG, **_recompute_kw(gran)))


def _reference(gran):
    """The reference's (loss, {port name: gradient}, state)."""
    model = _reference_model(gran)
    ids = paddle.to_tensor(IDS.astype("int64"))
    loss = model(ids, ids)
    loss.backward()
    grads = {n: None if p.grad is None else np.asarray(p.grad._data)
             for n, p in model.named_parameters()}
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    return float(loss), grads, state


def _port(gran, state):
    """The port's (loss, {name: gradient}) from the reference's weights."""
    model = llama_from_numpy(llama_tiny_config(**CFG, **_recompute_kw(gran)),
                             state, device="cpu")
    ids = torch.from_numpy(IDS)
    loss = model(ids, labels=ids)
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in
                         model.named_parameters()}


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def state():
    """The weights every granularity's reference model starts from."""
    return {k: np.asarray(v._data)
            for k, v in _reference_model(None).state_dict().items()}


@pytest.mark.parametrize("flags", [True, False], indirect=True)
@pytest.mark.parametrize("gran", GRANS)
def test_grads_match_reference(flags, gran):
    loss, grads, state = _reference(gran)
    if gran == "mlp":
        # the reference's "mlp" branch passes a bound method to its
        # recompute, which records only the method's tensor arguments
        # (a method has no .parameters()): the MLP's and the
        # post-attention norm's weights get no gradient there. The
        # port's gradients for those are held to the reference's without
        # recompute, the same function
        lost = {n for n, g in grads.items() if g is None}
        assert lost == {f"llama.layers.{i}.{m}.weight" for i in
                        range(LAYERS) for m in (
                            "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj",
                            "post_attention_layernorm")}
        full = _reference(None)[1]
        grads = {n: full[n] if n in lost else g for n, g in grads.items()}
    ploss, pgrads = _port(gran, state)
    assert abs(ploss - loss) <= 1e-5 * abs(loss)
    assert set(pgrads) == set(grads)
    for name, g in pgrads.items():
        want = grads[name]
        assert _rel(g, want) <= 1e-4, name


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("gran", GRANS[1:])
def test_recompute_matches_no_recompute(state, fused, gran):
    old = flag("FLAGS_pallas_fused_ops")
    set_flags({"FLAGS_pallas_fused_ops": fused})
    try:
        l0, g0 = _port(None, state)
        l1, g1 = _port(gran, state)
    finally:
        set_flags({"FLAGS_pallas_fused_ops": old})
    assert abs(l0 - l1) < 1e-6
    for name, g in g0.items():
        np.testing.assert_allclose(g1[name], g, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("gran,runs", [(None, LAYERS),
                                       ("flash_resident", LAYERS),
                                       ("full", 2 * LAYERS),
                                       ("mlp", LAYERS)])
def test_flash_forward_op_runs_per_step(state, monkeypatch, gran, runs):
    """The op's body runs once per layer in the forward; a recompute
    region re-runs it in the backward unless its policy keeps the
    outputs (a kept op is not dispatched again)."""
    seen = []
    real = fa.flash_attention_fwd

    def counted(*args, **kwargs):
        seen.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    _port(gran, state)
    assert len(seen) == runs


def test_bytes_saved_for_backward_order(state):
    held = {}
    ids = torch.from_numpy(IDS)
    for gran in GRANS:
        model = llama_from_numpy(
            llama_tiny_config(**CFG, **_recompute_kw(gran)), state,
            device="cpu")
        storages = {}

        def pack(t):
            s = t.untyped_storage()
            storages[s.data_ptr()] = s.nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model(ids, labels=ids)
        loss.backward()
        held[gran] = sum(storages.values())
    assert held["full"] < held["mlp"] < held[None], held
    assert held["flash_resident"] < held["mlp"], held


class _Block(torch.nn.Module):
    def __init__(self, p=0.0):
        super().__init__()
        self.lin = torch.nn.Linear(16, 16)
        self.p = p

    def forward(self, x):
        h = torch.tanh(self.lin(x))
        if self.p:
            h = torch.nn.functional.dropout(h, self.p, training=True)
        return self.lin(h) + x


def test_recompute_calls_function_plainly_without_a_gradient(monkeypatch):
    import torch.utils.checkpoint as cp

    from paddle_tpu_torch.distributed.fleet import utils as fu

    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint must not run")

    monkeypatch.setattr(fu, "checkpoint", refuse)
    x = torch.randn(4, 16)
    frozen = _Block().requires_grad_(False)
    assert recompute(lambda t: t * 2, x).equal(x * 2)      # no grad input
    assert recompute(frozen, x).equal(frozen(x))             # frozen params
    with torch.no_grad():
        live = _Block()
        assert recompute(live, x.requires_grad_(True)).equal(live(x))
    assert callable(cp.checkpoint)


@pytest.mark.parametrize("policy", [None, "nothing", "dots",
                                    "flash_resident"])
def test_dropout_inside_a_region_matches_outside(policy):
    torch.manual_seed(0)
    block = _Block(p=0.3)
    x = torch.randn(8, 16, requires_grad=True)
    grads = []
    for wrap in (False, True):
        torch.manual_seed(7)
        out = recompute(block, x, policy=policy) if wrap else block(x)
        out.square().sum().backward()
        grads.append([t.grad.clone() for t in (x, *block.parameters())])
        for t in (x, *block.parameters()):
            t.grad = None
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_policies_give_no_recompute_gradients(state):
    """"dots" (the 2-D products kept), a callable policy and "nothing"
    over whole layers give the gradients without recompute."""
    from torch.utils.checkpoint import CheckpointPolicy

    from paddle_tpu_torch.text.models import llama as port_llama

    def keep_flash_and_dots(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE
                if op in fa.FLASH_RESIDUAL_OPS + (torch.ops.aten.mm.default,)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    _, g0 = _port(None, state)
    for policy in ("dots", "nothing", keep_flash_and_dots):
        model = llama_from_numpy(llama_tiny_config(**CFG), state,
                                 device="cpu")
        real = port_llama.LlamaDecoderLayer.forward

        def layer_forward(self, x, cos, sin, policy=policy):
            return recompute(lambda *a: real(self, *a), x, cos, sin,
                             policy=policy)

        ids = torch.from_numpy(IDS)
        port_llama.LlamaDecoderLayer.forward = layer_forward
        try:
            loss = model(ids, labels=ids)
        finally:
            port_llama.LlamaDecoderLayer.forward = real
        loss.backward()
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), g0[name], atol=1e-6,
                                       err_msg=f"{policy}: {name}")


def test_resolve_remat_policy():
    with pytest.raises(ValueError, match="unknown recompute policy"):
        _resolve_remat_policy("no_such_policy")

    def mine(ctx, op, *args, **kwargs):
        return None

    assert _resolve_remat_policy(mine) is mine
    for name in ("flash_resident", "nothing", "dots"):
        assert callable(_resolve_remat_policy(name))
