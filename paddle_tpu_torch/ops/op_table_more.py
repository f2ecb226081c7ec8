"""The port's copy of paddle_tpu/ops/op_table_more.py's rows that this
package ports (see `op_table`); `ensure_populated` pulls it.
"""
from __future__ import annotations

import numpy as np

from .op_table import OpSpec, register

_SAFE = (-2.0, 2.0)
_POS = (0.2, 2.0)
_UNIT01 = (0.05, 0.95)


def populate_more():
    import paddle_tpu_torch as pd


    # ---------------------------------------------------------- creation
    register(OpSpec("ones", lambda: pd.ones([2, 3]), 0, False,
                    ref=lambda: np.ones((2, 3)), tags=("creation",)))
    register(OpSpec("zeros", lambda: pd.zeros([2, 3]), 0, False,
                    ref=lambda: np.zeros((2, 3)), tags=("creation",)))
    register(OpSpec("full_create", lambda: pd.full([2, 3], 1.5), 0, False,
                    ref=lambda: np.full((2, 3), 1.5), tags=("creation",)))
    register(OpSpec("ones_like", pd.ones_like, 1, False,
                    ref=np.ones_like, tags=("creation",)))
    register(OpSpec("zeros_like", pd.zeros_like, 1, False,
                    ref=np.zeros_like, tags=("creation",)))
    register(OpSpec("full_like", lambda x: pd.full_like(x, 2.5), 1, False,
                    ref=lambda x: np.full_like(x, 2.5), tags=("creation",)))
    register(OpSpec("eye", lambda: pd.eye(4, 3), 0, False,
                    ref=lambda: np.eye(4, 3), tags=("creation",)))
    register(OpSpec("linspace", lambda: pd.linspace(0.0, 1.0, 7), 0, False,
                    ref=lambda: np.linspace(0.0, 1.0, 7),
                    tags=("creation",)))
    register(OpSpec("logspace", lambda: pd.logspace(0.0, 2.0, 5), 0, False,
                    ref=lambda: np.logspace(0.0, 2.0, 5), rtol=1e-4,
                    tags=("creation",)))
    register(OpSpec("tril_indices", lambda: pd.tril_indices(4, 4, 0), 0,
                    False, ref=lambda: np.stack(np.tril_indices(4, 0, 4)),
                    bf16=False, tags=("creation",)))
    register(OpSpec("triu_indices", lambda: pd.triu_indices(4, 4, 0), 0,
                    False, ref=lambda: np.stack(np.triu_indices(4, 0, 4)),
                    bf16=False, tags=("creation",)))
    register(OpSpec("meshgrid", lambda x, y: pd.meshgrid(x, y)[0], 2,
                    True, shapes=((3,), (4,)),
                    ref=lambda x, y: np.meshgrid(x, y, indexing="ij")[0],
                    tags=("creation",)))
    register(OpSpec("diag_embed", pd.diag_embed, 1, True, shape=(2, 4),
                    ref=lambda x: np.stack([np.diag(r) for r in x]),
                    tags=("creation",)))

    # ------------------------------------------------------ shape / misc
    register(OpSpec("shape", pd.shape, 1, False, shape=(2, 5),
                    ref=lambda x: np.array(x.shape), bf16=False))
    register(OpSpec("numel", pd.numel, 1, False, shape=(2, 5),
                    ref=lambda x: np.array(x.size), bf16=False))
    register(OpSpec("equal_all_op", pd.equal_all, 2, False,
                    ref=lambda x, y: np.array(np.array_equal(x, y)),
                    bf16=False))
    register(OpSpec("increment_op", lambda x: pd.increment(pd.assign(x)), 1,
                    False, shape=(1,), ref=lambda x: x + 1.0))
    register(OpSpec("scale_op", lambda x: pd.scale(x, scale=2.0, bias=0.5),
                    1, True, ref=lambda x: 2.0 * x + 0.5))
    register(OpSpec("reverse_op", lambda x: pd.flip(x, axis=[1]), 1, True,
                    ref=lambda x: x[:, ::-1]))
    register(OpSpec("unstack_first", lambda x: pd.unstack(x, axis=0)[0], 1,
                    True, ref=lambda x: x[0]))
    register(OpSpec("multiplex_op",
                    lambda a, b, idx: pd.multiplex([a, b], idx), 3, True,
                    shapes=((4, 3), (4, 3), (4, 1)), int_inputs=(2,),
                    int_high=2,
                    ref=lambda a, b, idx: np.where(idx == 0, a, b)))
    register(OpSpec("broadcast_tensors",
                    lambda a, b: pd.add(*pd.broadcast_tensors([a, b])), 2,
                    True, shapes=((1, 3), (4, 3)),
                    ref=lambda a, b: np.broadcast_to(a, (4, 3)) + b))
    register(OpSpec("bitwise_left_shift",
                    pd.bitwise_left_shift, 2, False, int_inputs=(0, 1),
                    int_high=4, ref=np.left_shift, bf16=False))
    register(OpSpec("bitwise_right_shift",
                    pd.bitwise_right_shift, 2, False, int_inputs=(0, 1),
                    int_high=4, ref=np.right_shift, bf16=False))
    register(OpSpec("shard_index_op",
                    lambda x: pd.shard_index(x, 20, 2, 0, -1), 1, False,
                    int_inputs=(0,), shape=(6, 1), int_high=20, bf16=False))
    register(OpSpec("unique_consecutive_op",
                    lambda x: pd.unique_consecutive(x), 1, False,
                    int_inputs=(0,), shape=(8,), int_high=3, bf16=False))
    register(OpSpec("mean_all", lambda x: x.mean(), 1, True,
                    ref=lambda x: np.array(x.mean(), x.dtype)))

    # ---------------------------------------------------------- norms
    register(OpSpec("frobenius_norm",
                    lambda x: pd.linalg.norm(x, p="fro"), 1, True,
                    shape=(3, 4),
                    ref=lambda x: np.array(np.linalg.norm(x, "fro"),
                                           x.dtype)))
    register(OpSpec("p_norm", lambda x: pd.linalg.norm(x, p=3, axis=1), 1,
                    True, shape=(3, 4), domain=_POS,
                    ref=lambda x: (np.abs(x) ** 3).sum(1) ** (1 / 3),
                    rtol=1e-4))
    register(OpSpec("l1_norm", lambda x: pd.abs(x).sum(), 1, True,
                    ref=lambda x: np.array(np.abs(x).sum(), x.dtype)))
    register(OpSpec("squared_l2_norm", lambda x: (x * x).sum(), 1, True,
                    ref=lambda x: np.array((x * x).sum(), x.dtype)))

    # ---------------------------------------------------------- losses
    register(OpSpec("hinge_loss_op",
                    lambda x, y: (pd.maximum(
                        pd.zeros_like(x), 1.0 - x * y)).mean(), 2, True,
                    domains=(_SAFE, _SAFE), no_grad_inputs=(1,),
                    ref=lambda x, y: np.array(
                        np.maximum(0, 1 - x * y).mean(), x.dtype)))

    # ---------------------------------------------------------- linalg
    register(OpSpec("qr", lambda x: pd.linalg.qr(x)[0], 1, True,
                    shape=(4, 3), rtol=1e-4, bf16=False))
    register(OpSpec("svd", lambda x: pd.linalg.svd(x)[1], 1, False,
                    shape=(4, 3),
                    ref=lambda x: np.linalg.svd(x, compute_uv=False),
                    rtol=1e-4, bf16=False))
    register(OpSpec("eigh",
                    lambda x: pd.linalg.eigvalsh(x + x.transpose([1, 0])),
                    1, False, shape=(3, 3),
                    ref=lambda x: np.linalg.eigvalsh(x + x.T), rtol=1e-4,
                    bf16=False))
    register(OpSpec("lstsq",
                    lambda a, b: pd.linalg.lstsq(a, b)[0], 2, False,
                    shapes=((5, 3), (5, 2)),
                    ref=lambda a, b: np.linalg.lstsq(a, b, rcond=None)[0],
                    rtol=1e-3, atol=1e-4, bf16=False))
    register(OpSpec("cholesky_solve_op",
                    lambda b, x: pd.linalg.cholesky_solve(
                        b, pd.linalg.cholesky(
                            x @ x.transpose([1, 0]) + 3.0 * pd.eye(3)),
                        upper=False), 2, True, shapes=((3, 2), (3, 3)),
                    ref=lambda b, x: np.linalg.solve(
                        x @ x.T + 3.0 * np.eye(3), b), rtol=1e-4,
                    atol=1e-5, bf16=False))

    # ------------------------------------------------- conv / pool extras

    # ---------------------------------------------------------- signal

    register(OpSpec("norm", lambda x: pd.linalg.norm(x), 1, True,
                    shape=(3, 4),
                    ref=lambda x: np.array(np.linalg.norm(x), x.dtype),
                    rtol=1e-4))
    register(OpSpec("expand", lambda x: pd.expand(x, [4, 3]), 1, True,
                    shape=(1, 3),
                    ref=lambda x: np.broadcast_to(x, (4, 3))))

    # ---- nn.functional (ROADMAP.md Queue 1 item 1e)
    from ..nn import functional as F

    register(OpSpec("one_hot", lambda x: F.one_hot(x, 6), 1, False,
                    int_inputs=(0,), shape=(5,), int_high=6,
                    ref=lambda x: np.eye(6)[x], bf16=False,
                    tags=("creation",)))
    register(OpSpec("sequence_mask_op", lambda x: F.sequence_mask(x, 6), 1,
                    False, int_inputs=(0,), shape=(4,), int_high=6,
                    ref=lambda x: (np.arange(6)[None, :] < x[:, None]),
                    bf16=False, tags=("creation",)))
    register(OpSpec("bce_loss", F.binary_cross_entropy, 2, True,
                    domains=(_UNIT01, _UNIT01), no_grad_inputs=(1,),
                    ref=lambda x, y: np.array(
                        (-(y * np.log(x) + (1 - y) * np.log1p(-x))).mean(),
                        x.dtype), rtol=1e-4))
    register(OpSpec("huber_loss",
                    lambda x, y: F.smooth_l1_loss(x, y, delta=1.0), 2, True,
                    no_grad_inputs=(1,),
                    ref=lambda x, y: np.array(np.where(
                        np.abs(x - y) < 1.0, 0.5 * (x - y) ** 2,
                        np.abs(x - y) - 0.5).mean(), x.dtype)))
    register(OpSpec("nll_loss_op",
                    lambda x, y: F.nll_loss(F.log_softmax(x, -1), y), 2,
                    True, shapes=((4, 5), (4,)), int_inputs=(1,),
                    int_high=5))
    register(OpSpec("sigmoid_cross_entropy_with_logits",
                    lambda x, y: F.binary_cross_entropy_with_logits(
                        x, pd.cast(y, "float32")), 2, True,
                    domains=(_SAFE, (0.0, 1.0)), no_grad_inputs=(1,),
                    ref=lambda x, y: np.array(np.mean(
                        np.maximum(x, 0) - x * y + np.log1p(np.exp(-np.abs(x)))
                    ), x.dtype), rtol=1e-4))
    register(OpSpec("label_smooth_op",
                    lambda x: F.label_smooth(x, epsilon=0.1), 1, True,
                    domain=(0.0, 1.0), shape=(4, 5),
                    ref=lambda x: 0.9 * x + 0.1 / 5))
    register(OpSpec("conv3d_transpose_op",
                    lambda x, w: F.conv3d_transpose(x, w, stride=2), 2,
                    True, shapes=((1, 2, 3, 3, 3), (2, 2, 2, 2, 2)),
                    rtol=1e-4, atol=1e-5))
    register(OpSpec("pool3d", lambda x: F.max_pool3d(x, 2, stride=2), 1,
                    True, shapes=((1, 2, 4, 4, 4),)))
    register(OpSpec("max_pool3d_with_index",
                    lambda x: F.max_pool3d(x, 2, stride=2,
                                           return_mask=True)[0], 1, True,
                    shapes=((1, 2, 4, 4, 4),)))
    register(OpSpec("lp_pool2d_op",
                    lambda x: F.lp_pool2d(x, 2.0, 2, stride=2), 1, True,
                    domain=_POS, shapes=((1, 2, 6, 6),), rtol=1e-4))
    register(OpSpec("fractional_max_pool2d_op",
                    lambda x: F.fractional_max_pool2d(x, 3, random_u=0.4),
                    1, True, shapes=((1, 2, 8, 8),)))
    register(OpSpec("fractional_max_pool3d_op",
                    lambda x: F.fractional_max_pool3d(x, 2, random_u=0.4),
                    1, True, shapes=((1, 1, 6, 6, 6),)))
    register(OpSpec("unpool3d_op",
                    lambda x, idx: F.max_unpool3d(
                        x, pd.cast(idx, "int64") * 7, 2), 2, False,
                    shapes=((1, 1, 2, 2, 2), (1, 1, 2, 2, 2)),
                    int_inputs=(1,), int_high=2, bf16=False))
    register(OpSpec("maxout", lambda x: F.maxout(x, groups=2), 1, True,
                    shapes=((1, 4, 2, 2),)))
    register(OpSpec("swish", F.swish, 1, True,
                    ref=lambda x: x / (1 + np.exp(-x)), rtol=1e-5,
                    atol=1e-6))
    register(OpSpec("thresholded_relu",
                    lambda x: F.thresholded_relu(x, threshold=0.5), 1, True,
                    ref=lambda x: np.where(x > 0.5, x, 0.0)))
