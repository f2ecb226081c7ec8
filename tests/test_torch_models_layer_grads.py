"""The port's Layer models' logits, loss and gradients against
paddle_tpu's on the same weights (CPU, f32; ROADMAP.md Queue 1 item 11).

The models of test_torch_models_layer.py, the reference's weights carried
in by `set_state_dict`, with `FLAGS_pallas_fused_ops` on and off in both
packages (on, the port runs its fused ops' plain versions and the
reference its compositions below its kernels' size gate): logits within
1e-4 (the model parity tests' tolerance), the loss within 1e-5 relative,
and every parameter's gradient within 1e-4 of its largest |value|, keyed
by the one state name both packages give it. The reference's tape runs
with `FLAGS_eager_defer_vjp=False` (its deferred-VJP pass reads a
removed `jax.core.Var`). The LLaMAs here, GPT and BERT in
test_torch_models_layer_grads_gpt_bert.py.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.core.flags import flag, set_flags
from test_torch_models_layer import ARCHS, carried, ids_for, logits


@pytest.fixture(params=[True, False], ids=["fused", "plain"])
def both_flags(request):
    keys = ["FLAGS_pallas_fused_ops", "FLAGS_eager_defer_vjp"]
    old, port_old = paddle.get_flags(keys), flag("FLAGS_pallas_fused_ops")
    prev = port_device._current
    paddle.set_flags({"FLAGS_pallas_fused_ops": request.param,
                      "FLAGS_eager_defer_vjp": False})
    set_flags({"FLAGS_pallas_fused_ops": request.param})
    pt.set_device("cpu")
    yield
    paddle.set_flags(old)
    set_flags({"FLAGS_pallas_fused_ops": port_old})
    port_device._current = prev


def _loss(model, ids, pkg, arch):
    """The loss on the next tokens (the ids shifted by one; with labels
    equal to the ids a tied LLaMA predicts its input almost surely, and
    its attention gradients shrink to rounding noise)."""
    x = pkg.to_tensor(ids)
    if arch == "bert":
        return model(x, labels=pkg.to_tensor(np.array([1, 0], "int64")))
    y = pkg.to_tensor(np.roll(ids, -1, axis=1))
    return model(x, labels=y) if pkg is pt else model(x, y)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a.startswith("llama")])
def test_logits_loss_and_grads_match_reference(both_flags, arch):
    held_to_reference(arch)


def held_to_reference(arch):
    """`arch`'s logits, loss and every gradient against the reference's
    (module note)."""
    ref, port = carried(arch)
    ids = ids_for(arch)
    with torch.no_grad():
        got = logits(port, ids, pt)
    np.testing.assert_allclose(got, logits(ref, ids, paddle), atol=1e-4,
                               rtol=0)
    rloss = _loss(ref, ids, paddle, arch)
    rloss.backward()
    ploss = _loss(port, ids, pt, arch)
    ploss.backward()
    assert abs(float(ploss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    want = {n: np.asarray(p.grad._data) for n, p in ref.named_parameters()
            if p.grad is not None}
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()
             if p.grad is not None}
    assert set(grads) == set(want)
    for n, g in grads.items():
        w = want[n]
        scale = np.abs(w).max()
        if n.endswith("attention.key.bias"):
            # no gradient in exact arithmetic (a softmax ignores a shift
            # common to its keys): rounding on both sides, held to the key
            # weight's scale
            scale = np.abs(want[n[:-4] + "weight"]).max()
        assert np.abs(g - w).max() <= 1e-4 * scale, n
