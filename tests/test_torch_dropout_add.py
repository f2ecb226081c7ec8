"""The port's fused dropout + add (K6) against paddle_tpu's.

The `DropoutAdd` autograd Function of `paddle_tpu_torch.ops.fused_norm`
(on CPU tensors: the kernels' plain versions), reached through
`dropout_add_raw`, is held, forward and backward, against the
reference's Pallas kernels in interpret mode (`pn.dropout_add_raw` with
`pn.FORCE_PALLAS = True`, and its `jax.vjp`) with one shared 0/1 mask
from numpy, and against x * mask * scale + y written out. Masks come
from torch's generator in the port and from JAX's in the reference, so
`nn.functional.fused_dropout_add` is checked within the port: p = 0 and
eval return x + y and draw nothing; with p = 0.1, the flag on (K6) and
off (the reference's composition) give the same output and gradients
from one seeded generator. Tolerances, of each output's largest |value|:
f32 5e-5; bf16 2^-7 (one rounding each, and the composition's scale
rounded to bf16, as the reference's is).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.ops import pallas_norm as pn

from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.incubate.nn import functional as PIF
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops import fused_norm as fn

TOL = {"float32": 5e-5, "bfloat16": 2 ** -7}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
P = 0.1
SCALE = 1.0 / (1.0 - P)


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _inputs(dtype, shape=(2, 33, 80), seed=0):
    rs = np.random.RandomState(seed)
    x, y, g = (rs.randn(*shape).astype("float32") for _ in range(3))
    mask = (rs.rand(*shape) >= P).astype("float32")
    return x, y, g, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 33, 80), (3, 37)])
def test_dropout_add_matches_pallas(dtype, shape):
    x, y, g, mask = _inputs(dtype, shape)
    jx, jy, jg, jm = (jnp.asarray(a).astype(JDT[dtype])
                      for a in (x, y, g, mask))
    pn.FORCE_PALLAS = True
    try:
        o, pull = jax.vjp(lambda a, b: pn.dropout_add_raw(a, b, jm, SCALE),
                          jx, jy)
        dx, dy = pull(jg)
    finally:
        pn.FORCE_PALLAS = None
    tx, ty = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_()
              for a in (x, y))
    ot = fn.dropout_add_raw(tx, ty, torch.from_numpy(mask).to(TDT[dtype]),
                            SCALE)
    ot.backward(torch.from_numpy(g).to(TDT[dtype]))
    assert ot.dtype == TDT[dtype]
    for got, want, what in ((ot, o, "o"), (tx.grad, dx, "dx"),
                            (ty.grad, dy, "dy")):
        _close(got, want, TOL[dtype], what)
    # and the function written out, from the same rounded inputs
    xr, yr = (np.asarray(jnp.asarray(a).astype(JDT[dtype]).astype(
        jnp.float32)) for a in (x, y))
    _close(ot, xr * mask * SCALE + yr, TOL[dtype], "x*mask*scale+y")


def test_dropout_add_function_passes_gradcheck():
    torch.manual_seed(0)
    x, y = (torch.randn(4, 24, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    mask = (torch.rand(4, 24) >= P).double()
    assert torch.autograd.gradcheck(
        lambda a, b: fn.dropout_add_raw(a, b, mask, SCALE), (x, y))


@pytest.mark.parametrize("p,training", [(0.0, True), (P, False)],
                         ids=["p0", "eval"])
def test_no_dropout_returns_sum_and_draws_nothing(p, training):
    """The reference's early return: x + y, no mask drawn (the generator
    does not move), no kernel launched, with the flag on."""
    x, y, _, _ = _inputs("float32")
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    _cuda_common.reset_launch_counts()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = PF.fused_dropout_add(tx, ty, p=p, training=training, generator=gen)
    assert torch.equal(got, tx + ty)
    assert torch.equal(gen.get_state(), state)
    assert not any(_cuda_common.launch_counts().values())
    want = RF.fused_dropout_add(paddle.to_tensor(x), paddle.to_tensor(y),
                                p=p, training=training)
    _close(got, np.asarray(want._data), TOL["float32"], "x + y")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flag_on_and_off_agree_from_one_generator(dtype):
    """p = 0.1: K6's op (flag on) and the reference's composition (flag
    off) draw the same mask from one seeded generator and give the same
    output and gradients; the mask keeps about 1 - p of the elements."""
    x, y, g, _ = _inputs(dtype, (64, 96), seed=1)
    old = flag("FLAGS_pallas_fused_ops")
    runs = []
    try:
        for fused in (True, False):
            set_flags({"FLAGS_pallas_fused_ops": fused})
            tx, ty = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_()
                      for a in (x, y))
            gen = torch.Generator().manual_seed(11)
            o = PF.fused_dropout_add(tx, ty, p=P, generator=gen)
            o.backward(torch.from_numpy(g).to(TDT[dtype]))
            runs.append((o, tx.grad, ty.grad))
    finally:
        set_flags({"FLAGS_pallas_fused_ops": old})
    for got, want in zip(*runs):
        assert got.dtype == TDT[dtype]
        _close(got, want.detach().float().numpy(), TOL[dtype],
               "flag on vs off")
    kept = (runs[0][1] != 0).float().mean().item()
    assert abs(kept - (1 - P)) < 0.02, kept
    torch.testing.assert_close(runs[0][2], torch.from_numpy(g).to(
        TDT[dtype]))


def test_dropout_and_alias():
    """`dropout` keeps what its draw keeps, scaled by 1 / (1 - p), in
    x's dtype; the incubate alias is the fused op."""
    x = torch.from_numpy(np.random.RandomState(2).randn(8, 6, 5).astype(
        "float32"))
    gen = torch.Generator().manual_seed(4)
    keep = torch.empty_like(x).bernoulli_(1 - P, generator=gen)
    gen.manual_seed(4)
    torch.testing.assert_close(PF.dropout(x, P, generator=gen),
                               x * keep / (1 - P))
    assert PF.dropout(x, P, training=False) is x
    assert PF.dropout(x.to(torch.bfloat16), P).dtype == torch.bfloat16
    assert PIF.fused_dropout_add is PF.fused_dropout_add
