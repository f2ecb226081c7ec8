"""The port's op table: the 418 rows of paddle_tpu's op table
(paddle_tpu/ops/op_table.py, op_table_ext.py, op_table_more.py)
(`NN_ROWS` the 94 that reach `nn.functional`, `TAIL_ROWS` the 11 that
reach fft, signal, geometric, incubate and text.viterbi), each
with the port's callable and the reference's test spec (inputs, domains,
shapes, kwargs, tolerances, the bf16 flag and the numpy `ref`), so the
sweep runs where there is no jax (`chip_smoke.py`'s TENSOR_OPS on the
card) and the CPU tests hold the port to the reference
(tests/test_torch_op_table*.py, which also hold every copied field equal
to the reference's `OpSpec`).

Split into three files as the reference's; `ensure_populated` pulls all
three.
"""
from __future__ import annotations

import math as _math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

__all__ = ["OpSpec", "OPS", "register", "testable_specs"]


@dataclass
class OpSpec:
    name: str
    fn: Callable                     # public op over Tensors
    n_inputs: int = 1
    diff: bool = True                # has a meaningful gradient
    domain: tuple = (-2.0, 2.0)      # sample range for float inputs
    domains: tuple | None = None     # per-input ranges (overrides domain)
    int_inputs: tuple = ()           # positions sampled as ints
    no_grad_inputs: tuple = ()       # float positions with no defined grad
    ref: Callable | None = None      # independent NumPy reference
    shape: tuple = (2, 3)
    shapes: tuple | None = None      # per-input shapes
    kwargs: dict = field(default_factory=dict)
    rtol: float = 1e-5
    atol: float = 1e-6
    bf16: bool = True                # include in the bf16 sweep
    int_high: int = 5                # exclusive upper bound for int samples
    tags: tuple = ()                 # e.g. ("reduction", "activation")

    def sample_inputs(self, seed=0, dtype="float32"):
        rs = np.random.RandomState(seed)
        outs = []
        shapes = self.shapes or (self.shape,) * self.n_inputs
        for i in range(self.n_inputs):
            shp = shapes[i]
            if i in self.int_inputs:
                outs.append(rs.randint(0, self.int_high, shp).astype("int64"))
                continue
            lo, hi = (self.domains[i] if self.domains else self.domain)
            outs.append((lo + (hi - lo) * rs.rand(*shp)).astype(dtype))
        return tuple(outs)


OPS: dict[str, OpSpec] = {}


def register(spec: OpSpec):
    OPS[spec.name] = spec
    return spec


def testable_specs(diff_only=False):
    out = [s for s in OPS.values()]
    if diff_only:
        out = [s for s in out if s.diff]
    return sorted(out, key=lambda s: s.name)


# --------------------------------------------------------------------------
# table population: pulls the module-level op groups so there is ONE place
# that knows every op; domains/refs are the per-op test metadata.

_POS = (0.2, 2.0)           # strictly positive
_UNIT = (-0.95, 0.95)       # open (-1, 1)
_GT1 = (1.05, 3.0)          # > 1
_SAFE = (-2.0, 2.0)

_erf_np = np.vectorize(_math.erf)
_gamma_ln = np.vectorize(_math.lgamma)

#: unary: name -> (domain, diff, numpy ref or None)
_UNARY_META = {
    "exp": (_SAFE, True, np.exp), "expm1": (_SAFE, True, np.expm1),
    "log": (_POS, True, np.log), "log2": (_POS, True, np.log2),
    "log10": (_POS, True, np.log10), "log1p": (_POS, True, np.log1p),
    "sqrt": (_POS, True, np.sqrt),
    "rsqrt": (_POS, True, lambda x: 1.0 / np.sqrt(x)),
    "square": (_SAFE, True, np.square), "abs": (_SAFE, True, np.abs),
    "neg": (_SAFE, True, np.negative),
    "sin": (_SAFE, True, np.sin), "cos": (_SAFE, True, np.cos),
    "tan": ((-1.0, 1.0), True, np.tan),
    "asin": (_UNIT, True, np.arcsin), "acos": (_UNIT, True, np.arccos),
    "atan": (_SAFE, True, np.arctan),
    "sinh": (_SAFE, True, np.sinh), "cosh": (_SAFE, True, np.cosh),
    "tanh": (_SAFE, True, np.tanh),
    "asinh": (_SAFE, True, np.arcsinh), "acosh": (_GT1, True, np.arccosh),
    "atanh": (_UNIT, True, np.arctanh),
    "ceil": (_SAFE, False, np.ceil), "floor": (_SAFE, False, np.floor),
    "round": (_SAFE, False, np.round), "trunc": (_SAFE, False, np.trunc),
    "frac": (_SAFE, False, lambda x: x - np.trunc(x)),
    "sign": (_SAFE, False, np.sign),
    "sigmoid": (_SAFE, True, lambda x: 1 / (1 + np.exp(-x))),
    "reciprocal": (_POS, True, np.reciprocal),
    "erf": (_SAFE, True, _erf_np),
    "erfinv": (_UNIT, True, None),
    "lgamma": (_POS, True, _gamma_ln),
    "digamma": (_POS, True, None),
    "i0": (_SAFE, True, np.i0),
    "rad2deg": (_SAFE, True, np.rad2deg),
    "deg2rad": (_SAFE, True, np.deg2rad),
}

#: binary: name -> (per-input domains, diff, ref)
_BINARY_META = {
    "add": ((_SAFE, _SAFE), True, np.add),
    "subtract": ((_SAFE, _SAFE), True, np.subtract),
    "multiply": ((_SAFE, _SAFE), True, np.multiply),
    "divide": ((_SAFE, _POS), True, np.divide),
    "floor_divide": ((_SAFE, _POS), False, np.floor_divide),
    "mod": ((_SAFE, _POS), False, np.mod),
    "pow": ((_POS, _SAFE), True, np.power),
    "maximum": ((_SAFE, _SAFE), True, np.maximum),
    "minimum": ((_SAFE, _SAFE), True, np.minimum),
    "fmax": ((_SAFE, _SAFE), True, np.fmax),
    "fmin": ((_SAFE, _SAFE), True, np.fmin),
    "atan2": ((_SAFE, _POS), True, np.arctan2),
    "heaviside": ((_SAFE, _SAFE), False, np.heaviside),
    "hypot": ((_SAFE, _SAFE), True, np.hypot),
    "copysign": ((_SAFE, _SAFE), True, np.copysign),
    "nextafter": ((_SAFE, _SAFE), False, np.nextafter),
    "logaddexp": ((_SAFE, _SAFE), True, np.logaddexp),
    "ldexp": ((_SAFE, (-2.0, 2.0)), True, None),
}

#: logical / comparison (never differentiable); int-valued ops get int inputs
_LOGICAL_META = {
    "equal": np.equal, "not_equal": np.not_equal,
    "less_than": np.less, "less_equal": np.less_equal,
    "greater_than": np.greater, "greater_equal": np.greater_equal,
    "logical_and": None, "logical_or": None, "logical_xor": None,
    "logical_not": None,
    "isnan": np.isnan, "isinf": np.isinf, "isfinite": np.isfinite,
    "signbit": np.signbit,
}
_INT_LOGICAL = {"bitwise_and": np.bitwise_and, "bitwise_or": np.bitwise_or,
                "bitwise_xor": np.bitwise_xor, "bitwise_not": np.invert,
                "gcd": np.gcd, "lcm": np.lcm,
                "left_shift": np.left_shift, "right_shift": np.right_shift}


def _populate():
    import paddle_tpu_torch as pd

    from . import linalg as la
    from . import manipulation as mp
    from . import math as m
    from . import reduction as r

    for name, (dom, diff, ref) in _UNARY_META.items():
        register(OpSpec(name, getattr(m, name), 1, diff, domain=dom, ref=ref,
                        tags=("unary",)))
    for name, (doms, diff, ref) in _BINARY_META.items():
        register(OpSpec(name, getattr(m, name), 2, diff, domains=doms,
                        ref=ref, tags=("binary",)))
    for name, ref in _LOGICAL_META.items():
        n = 1 if name in ("logical_not", "isnan", "isinf", "isfinite",
                          "signbit") else 2
        register(OpSpec(name, getattr(m, name), n, False, ref=ref,
                        bf16=False, tags=("logical",)))
    for name, ref in _INT_LOGICAL.items():
        n = 1 if name == "bitwise_not" else 2
        register(OpSpec(name, getattr(m, name), n, False, ref=ref,
                        int_inputs=tuple(range(n)), bf16=False,
                        tags=("logical",)))

    # ---- reductions
    for name, ref in (("sum", np.sum), ("mean", np.mean),
                      ("prod", np.prod), ("max", np.max), ("min", np.min),
                      ("amax", np.max), ("amin", np.min)):
        register(OpSpec(name, getattr(r, name), 1, True, ref=ref,
                        shape=(3, 4), tags=("reduction",)))
    register(OpSpec("logsumexp", r.logsumexp, 1, True,
                    ref=lambda x: np.log(np.sum(np.exp(x))), shape=(3, 4),
                    tags=("reduction",)))
    register(OpSpec("all", r.all, 1, False, ref=np.all, bf16=False,
                    int_inputs=(0,), tags=("reduction",)))
    register(OpSpec("any", r.any, 1, False, ref=np.any, bf16=False,
                    int_inputs=(0,), tags=("reduction",)))
    register(OpSpec("nansum", r.nansum, 1, True, ref=np.nansum,
                    tags=("reduction",)))
    register(OpSpec("nanmean", r.nanmean, 1, True, ref=np.nanmean,
                    tags=("reduction",)))
    register(OpSpec("median", r.median, 1, True, ref=np.median,
                    shape=(3, 5), tags=("reduction",)))
    register(OpSpec("std", r.std, 1, True,
                    ref=lambda x: np.std(x, ddof=1), shape=(3, 4),
                    rtol=1e-4, tags=("reduction",)))
    register(OpSpec("var", r.var, 1, True,
                    ref=lambda x: np.var(x, ddof=1), shape=(3, 4),
                    rtol=1e-4, tags=("reduction",)))

    # ---- manipulation (shape ops; grads are pure data movement)
    register(OpSpec("reshape", lambda x: mp.reshape(x, [3, 2]), 1, True,
                    ref=lambda x: np.reshape(x, (3, 2)),
                    tags=("manipulation",)))
    register(OpSpec("transpose", lambda x: mp.transpose(x, [1, 0]), 1, True,
                    ref=lambda x: np.transpose(x, (1, 0)),
                    tags=("manipulation",)))
    register(OpSpec("flatten", mp.flatten, 1, True,
                    ref=lambda x: np.reshape(x, (-1,)),
                    tags=("manipulation",)))
    register(OpSpec("squeeze", lambda x: mp.squeeze(x, 0), 1, True,
                    shape=(1, 4), ref=lambda x: np.squeeze(x, 0),
                    tags=("manipulation",)))
    register(OpSpec("unsqueeze", lambda x: mp.unsqueeze(x, 0), 1, True,
                    ref=lambda x: x[None], tags=("manipulation",)))
    register(OpSpec("flip", lambda x: mp.flip(x, [0]), 1, True,
                    ref=lambda x: np.flip(x, 0), tags=("manipulation",)))
    register(OpSpec("roll", lambda x: mp.roll(x, 1), 1, True,
                    ref=lambda x: np.roll(x, 1), tags=("manipulation",)))
    register(OpSpec("tile", lambda x: mp.tile(x, [2, 1]), 1, True,
                    ref=lambda x: np.tile(x, (2, 1)), tags=("manipulation",)))
    register(OpSpec("concat", lambda x, y: mp.concat([x, y]), 2, True,
                    ref=lambda x, y: np.concatenate([x, y]),
                    tags=("manipulation",)))
    register(OpSpec("stack", lambda x, y: mp.stack([x, y]), 2, True,
                    ref=lambda x, y: np.stack([x, y]),
                    tags=("manipulation",)))
    register(OpSpec("split", lambda x: mp.split(x, 2, axis=1)[0], 1, True,
                    shape=(2, 4), ref=lambda x: np.split(x, 2, axis=1)[0],
                    tags=("manipulation",)))
    register(OpSpec("chunk", lambda x: mp.chunk(x, 2, axis=0)[1], 1, True,
                    shape=(4, 3),
                    ref=lambda x: np.split(x, 2, axis=0)[1],
                    tags=("manipulation",)))
    register(OpSpec("cast", lambda x: x.astype("float64").astype("float32"),
                    1, True, ref=lambda x: x, tags=("manipulation",)))
    register(OpSpec("clip", lambda x: x.clip(-1.0, 1.0), 1, True,
                    ref=lambda x: np.clip(x, -1, 1), tags=("manipulation",)))
    register(OpSpec("cumsum", lambda x: pd.cumsum(x, 0), 1, True,
                    ref=lambda x: np.cumsum(x, 0), tags=("manipulation",)))
    register(OpSpec("cumprod", lambda x: pd.cumprod(x, 0), 1, True,
                    domain=_POS, ref=lambda x: np.cumprod(x, 0),
                    tags=("manipulation",)))
    register(OpSpec("gather", lambda x, i: mp.gather(x, i), 2, True,
                    shapes=((4, 3), (2,)), int_inputs=(1,), int_high=4,
                    ref=lambda x, i: x[i], tags=("manipulation",)))
    register(OpSpec("index_select",
                    lambda x, i: mp.index_select(x, i, axis=0), 2, True,
                    shapes=((4, 3), (2,)), int_inputs=(1,), int_high=4,
                    ref=lambda x, i: x[i], tags=("manipulation",)))
    register(OpSpec("broadcast_to", lambda x: mp.broadcast_to(x, [4, 2, 3]),
                    1, True, ref=lambda x: np.broadcast_to(x, (4, 2, 3)),
                    tags=("manipulation",)))

    # ---- linalg
    register(OpSpec("matmul", la.matmul, 2, True,
                    shapes=((2, 3), (3, 4)),
                    ref=lambda a, b: a @ b, tags=("linalg",)))
    register(OpSpec("matmul_batched", la.matmul, 2, True,
                    shapes=((2, 2, 3), (2, 3, 4)),
                    ref=lambda a, b: a @ b, tags=("linalg",)))
    register(OpSpec("dot", la.dot, 2, True, shapes=((4,), (4,)),
                    ref=np.dot, tags=("linalg",)))
    register(OpSpec("t", lambda x: mp.t(x), 1, True,
                    ref=lambda x: x.T, tags=("linalg",)))
    register(OpSpec("norm_fro", lambda x: la.norm(x), 1, True,
                    ref=np.linalg.norm, tags=("linalg",)))
    register(OpSpec("outer", la.outer, 2, True, shapes=((3,), (4,)),
                    ref=np.outer, tags=("linalg",)))

    # ---- more linalg / tensor algebra
    register(OpSpec("bmm", pd.bmm, 2, True, shapes=((2, 2, 3), (2, 3, 4)),
                    ref=lambda a, b: a @ b, tags=("linalg",)))
    register(OpSpec("mv", pd.mv, 2, True, shapes=((3, 4), (4,)),
                    ref=lambda a, b: a @ b, tags=("linalg",)))
    register(OpSpec("kron", pd.kron, 2, True, shapes=((2, 2), (2, 3)),
                    ref=np.kron, tags=("linalg",)))
    register(OpSpec("cross", lambda a, b: pd.cross(a, b, axis=-1), 2, True,
                    shapes=((2, 3), (2, 3)),
                    ref=lambda a, b: np.cross(a, b), tags=("linalg",)))
    register(OpSpec("trace_op", pd.trace, 1, True, shape=(3, 3),
                    ref=np.trace, tags=("linalg",)))
    register(OpSpec("diag", pd.diag, 1, True, shape=(4,),
                    ref=np.diag, tags=("linalg",)))
    register(OpSpec("diagonal", pd.diagonal, 1, True, shape=(3, 3),
                    ref=np.diagonal, tags=("linalg",)))
    register(OpSpec("tril", pd.tril, 1, True, shape=(3, 3),
                    ref=np.tril, tags=("linalg",)))
    register(OpSpec("triu", pd.triu, 1, True, shape=(3, 3),
                    ref=np.triu, tags=("linalg",)))
    register(OpSpec("einsum_ij_jk", lambda a, b: pd.einsum("ij,jk->ik", a, b),
                    2, True, shapes=((2, 3), (3, 4)),
                    ref=lambda a, b: a @ b, tags=("linalg",)))
    register(OpSpec("addmm", lambda x, a, b: pd.addmm(x, a, b), 3, True,
                    shapes=((2, 4), (2, 3), (3, 4)),
                    ref=lambda x, a, b: x + a @ b, tags=("linalg",)))

    # ---- losses / similarity (functional)

    # ---- more manipulation
    register(OpSpec("take_along_axis",
                    lambda x, i: pd.take_along_axis(x, i, axis=1), 2, True,
                    shapes=((3, 4), (3, 2)), int_inputs=(1,), int_high=4,
                    ref=lambda x, i: np.take_along_axis(x, i, 1),
                    tags=("manipulation",)))
    register(OpSpec("repeat_interleave",
                    lambda x: pd.repeat_interleave(x, 2, axis=0), 1, True,
                    ref=lambda x: np.repeat(x, 2, axis=0),
                    tags=("manipulation",)))
    register(OpSpec("searchsorted", lambda s, v: pd.searchsorted(s, v), 2,
                    False, shapes=((5,), (3,)),
                    domains=((0.0, 1.0), (0.0, 1.0)), bf16=False, ref=None,
                    tags=("search",)))
    register(OpSpec("masked_fill",
                    lambda x, m: pd.masked_fill(x, m > 2, 0.5), 2, True,
                    int_inputs=(1,),
                    ref=lambda x, m: np.where(m > 2, 0.5, x),
                    tags=("manipulation",)))

    # sort/search (grads flow through sort)
    register(OpSpec("sort", lambda x: mp.sort(x, axis=-1), 1, True,
                    ref=lambda x: np.sort(x, axis=-1), tags=("search",)))
    register(OpSpec("argsort", lambda x: mp.argsort(x, axis=-1), 1, False,
                    ref=lambda x: np.argsort(x, axis=-1), bf16=False,
                    tags=("search",)))
    register(OpSpec("argmax", lambda x: pd.argmax(x, axis=-1), 1, False,
                    ref=lambda x: np.argmax(x, -1), bf16=False,
                    tags=("search",)))
    register(OpSpec("argmin", lambda x: pd.argmin(x, axis=-1), 1, False,
                    ref=lambda x: np.argmin(x, -1), bf16=False,
                    tags=("search",)))
    register(OpSpec("topk", lambda x: pd.topk(x, 2)[0], 1, True,
                    shape=(3, 5),
                    ref=lambda x: np.sort(x, -1)[:, ::-1][:, :2],
                    tags=("search",)))
    register(OpSpec("kthvalue", lambda x: pd.kthvalue(x, 2)[0], 1, True,
                    shape=(3, 5),
                    ref=lambda x: np.sort(x, -1)[:, 1], tags=("search",)))
    register(OpSpec("where", lambda c, x, y: mp.where((c > 2), x, y), 3,
                    True, int_inputs=(0,),
                    ref=lambda c, x, y: np.where(c > 2, x, y),
                    tags=("search",)))

    # ---- nn.functional (ROADMAP.md Queue 1 item 1e)
    from ..nn import functional as F

    # ---- activations / nn functional
    def _np_softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    acts = [
        ("relu", F.relu, _SAFE, lambda x: np.maximum(x, 0)),
        ("relu6", F.relu6, (-8.0, 8.0),
         lambda x: np.clip(x, 0, 6)),
        ("elu", F.elu, _SAFE,
         lambda x: np.where(x > 0, x, np.exp(x) - 1)),
        ("selu", F.selu, _SAFE, None),
        ("celu", F.celu, _SAFE, None),
        ("gelu", F.gelu, _SAFE, None),
        ("silu", F.silu, _SAFE, lambda x: x / (1 + np.exp(-x))),
        ("mish", F.mish, _SAFE, None),
        ("softplus", F.softplus, _SAFE,
         lambda x: np.log1p(np.exp(x))),
        ("softsign", F.softsign, _SAFE, lambda x: x / (1 + np.abs(x))),
        ("hardtanh", F.hardtanh, _SAFE, lambda x: np.clip(x, -1, 1)),
        ("hardsigmoid", F.hardsigmoid, (-8.0, 8.0), None),
        ("hardswish", F.hardswish, (-8.0, 8.0), None),
        ("leaky_relu", F.leaky_relu, _SAFE,
         lambda x: np.where(x > 0, x, 0.01 * x)),
        ("log_sigmoid", F.log_sigmoid, _SAFE,
         lambda x: -np.log1p(np.exp(-x))),
        ("tanhshrink", F.tanhshrink, _SAFE, lambda x: x - np.tanh(x)),
        ("softshrink", F.softshrink, _SAFE, None),
        ("hardshrink", F.hardshrink, _SAFE, None),
        ("softmax", F.softmax, _SAFE, _np_softmax),
        ("log_softmax", F.log_softmax, _SAFE,
         lambda x: np.log(_np_softmax(x))),
    ]
    for name, fn, dom, ref in acts:
        register(OpSpec(f"act_{name}", fn, 1, True, domain=dom, ref=ref,
                        tags=("activation",)))
    register(OpSpec("mse_loss", F.mse_loss, 2, True,
                    ref=lambda a, b: np.mean((a - b) ** 2), tags=("loss",)))
    register(OpSpec("l1_loss", F.l1_loss, 2, True,
                    ref=lambda a, b: np.mean(np.abs(a - b)), tags=("loss",)))
    register(OpSpec("smooth_l1", F.smooth_l1_loss, 2, True, ref=None,
                    tags=("loss",)))
    register(OpSpec("kl_div", lambda a, b: F.kl_div(a, b), 2, True,
                    domains=(((-3.0, -0.1)), (0.1, 1.0)), ref=None,
                    tags=("loss",)))
    register(OpSpec("cosine_similarity",
                    lambda a, b: F.cosine_similarity(a, b), 2, True,
                    ref=lambda a, b: np.sum(a * b, -1) /
                    (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)),
                    tags=("loss",)))
    register(OpSpec("normalize", lambda x: F.normalize(x), 1, True,
                    ref=lambda x: x / np.linalg.norm(x, axis=-1,
                                                     keepdims=True),
                    tags=("loss",)))
    register(OpSpec("pad", lambda x: pd.nn.functional.pad(x, [1, 1]), 1,
                    True, ref=lambda x: np.pad(x, ((0, 0), (1, 1))),
                    tags=("manipulation",)))

_populated = False


def ensure_populated():
    global _populated
    if not _populated:
        _populated = True
        _populate()
        from .op_table_ext import populate_ext

        populate_ext()
        from .op_table_more import populate_more

        populate_more()


#: The rows that reach `nn.functional` (ROADMAP.md Queue 1 item 1e, the
#: nn half of the Tensor surface): the CPU tests hold them in files of
#: their own (tests/test_torch_op_table_nn.py, _tape_nn.py).
NN_ROWS = frozenset(
    [f"act_{n}" for n in (
        "celu elu gelu hardshrink hardsigmoid hardswish hardtanh leaky_relu "
        "log_sigmoid log_softmax mish relu relu6 selu silu softmax softplus "
        "softshrink softsign tanhshrink").split()]
    + ("adaptive_avg_pool2d_op affine_grid_op avg_pool2d_op bce bce_logits "
       "bce_loss bilinear_op channel_shuffle_op conv1d_op conv2d_op "
       "conv2d_transpose_op conv3d_op conv3d_transpose_op cosine_similarity "
       "cross_entropy_op dice_loss dropout_eval embedding_op fold_op "
       "fractional_max_pool2d_op fractional_max_pool3d_op gather_tree "
       "gaussian_nll glu_op grid_sample_op group_norm_op huber_loss "
       "instance_norm_op interpolate_op kl_div l1_loss l2_normalize_axis "
       "label_smooth_op layer_norm_op linear_op log_loss lp_pool2d_op "
       "margin_ranking max_pool2d_mask max_pool2d_op max_pool3d_with_index "
       "max_unpool2d_op maxout mse_loss multi_label_soft_margin nll "
       "nll_loss_op normalize npair one_hot one_hot_op pad pad_reflect "
       "pixel_shuffle_op pixel_unshuffle_op poisson_nll pool3d prelu_op "
       "rms_norm_op sequence_mask_op sigmoid_cross_entropy_with_logits "
       "smooth_l1 soft_margin softmax_axis0 softplus_beta "
       "square_error_cost swiglu_op swish temporal_shift_op "
       "thresholded_relu triplet_margin unfold_op unpool3d_op "
       "zeropad2d_op").split())

#: The rows that reach fft, signal, geometric, incubate and text.viterbi
#: (ROADMAP.md Queue 1 item 1f, the long tail): the CPU tests hold them
#: in a file of their own (tests/test_torch_op_table_tail.py).
TAIL_ROWS = frozenset(
    "fft_abs fft2_abs fftshift rfft_abs frame_op overlap_add_op "
    "segment_max segment_mean segment_sum identity_loss_op "
    "viterbi_decode".split())

#: The reference's rows this table leaves out (none: all 418 are here).
DEFERRED: dict[str, str] = {}
