"""Mixed precision: the per-op cast rule (`auto_cast`, O1 and O2, custom
lists), `decorate` and `GradScaler`.

Port of paddle_tpu/amp/__init__.py. The reference's AMP is one rule,
consulted at dispatch for every op by its name (`amp_dtype_for`): at O1
the ops of WHITE_LIST (matmuls, convolutions, attention) have their
floating inputs cast to the AMP dtype and those of BLACK_LIST
(exponentials, reductions, losses, norms) to f32, the rest left alone; at
O2 every op outside the black list is cast to the AMP dtype; custom white
and black lists override both. The casts are part of the recorded graph,
so gradients arrive in the parameters' dtypes.

Where the port applies it:

  * torch's own ops: `auto_cast` (enabled) installs a
    `TorchFunctionMode` (`_AmpMode`) that maps each torch callable to the
    reference's op name (`_op_names`: `F.linear` -> "linear",
    `torch.matmul` and `Tensor.__matmul__` -> "matmul", `F.softmax` ->
    "softmax", `F.cross_entropy` -> "cross_entropy", ...) and casts its
    floating tensor arguments by `amp_dtype_for`; at O2 every other op
    is "an op outside the black list", except what only reads metadata,
    converts dtypes or devices, or writes in place (`_passes`). With AMP
    off no mode is installed.
  * the port's own ops (`nn.functional`'s fused norms, rotary, SwiGLU,
    dropout + add, the flash op, the fused linear cross-entropy): each
    runs through `amp_op` under the reference's name for it
    ("rms_norm", "fused_add_rms_norm", "layer_norm",
    "fused_add_layer_norm", "rope_qk" / "rope", "swiglu",
    "fused_dropout_add", "scaled_dot_product_attention",
    "fused_linear_cross_entropy"): one thread-local read when AMP is off;
    otherwise its inputs are cast by the rule and its body runs as one
    op, which the mode does not look into (as the reference's op body
    runs on raw arrays).

The port's models at O2 run their forward under the rule for the port's
own ops alone (`model_scope`, `SUSPEND_O2_IN_MODELS`): the mode passes
torch's ops through (`AmpState.torch_ops` False), while the `nn` layers'
ops follow the O2 rule (the norms of the black list write f32, linear,
rotary, SwiGLU, dropout + add and attention run in the AMP dtype). On an
H100 the mode made the 1B LLaMA's eager O2 step 12% slower (PERF.md: the
black list's f32 upcasts of the norms' inputs; its host time moved by
less than the run-to-run spread). A model that `decorate` put at O2 runs
so with `auto_cast` off as well (`_amp_o2_dtype`), as its parameters'
dtypes ask. A test holds the dtypes and values with the mode on and
suspended. At O1 they run under the mode, and the rule decides every
op's dtype, as in the reference.

The black list's norms that take an `out_dtype` (`_F32_OUT_NORMS`: the
port's `rms_norm` and `layer_norm`, whose bodies compute in f32 from any
input dtype) are not handed f32 copies of their inputs: the rule's f32
reaches them as `out_dtype`, which gives the values of the upcast (an
exact one) without its copies.

Recompute re-runs its region under the forward's AMP state
(`amp_state_guard`; `distributed.fleet.utils.recompute`), as the
reference's PyLayer context saves it.

`GradScaler` keeps its scale and counters on the device. `step` takes the
reference's eager branch (a host read of `found_inf`, skipping the
update on overflow) outside a compiled call, and its traced branch (the
gradients zeroed on overflow, then the step) inside one
(`jit.api.compiled_call_active`: discovery, capture and the CPU's
compiled call alike), so the card and the CPU follow one rule.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..core.flags import flag
from ..jit.api import compiled_call_active
from ..ops._cuda_common import resolve_device

_tls = threading.local()

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}

# ops cast to low precision in O1 (matmul/conv)
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "scaled_dot_product_attention", "addmm",
}
# ops kept in fp32 in O1 (reductions / losses / norms / exp-family)
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "mse_loss", "l1_loss",
    "binary_cross_entropy", "bce_with_logits", "kl_div", "mean", "sum",
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "rms_norm",
    "cumsum", "logsumexp", "norm", "cosine_similarity",
}
#: last-axis norms that accumulate in f32 internally: under
#: FLAGS_residual_dtype=bfloat16 their inputs stay bf16 in the reference
#: (the port accepts only "float32", so this never applies; kept for the
#: rule's shape)
_F32_INTERNAL_NORMS = {"rms_norm", "layer_norm"}

#: whether the port's models run their forward with the mode suspended
#: at O2 (module note)
SUSPEND_O2_IN_MODELS = True

#: the black list's norms whose body takes `out_dtype` as its last
#: positional argument and computes in f32 (module note)
_F32_OUT_NORMS = frozenset(("rms_norm", "layer_norm"))


def _amp_dtype(dtype) -> torch.dtype:
    from ..core.dtype import DType

    if isinstance(dtype, DType):
        dtype = dtype.torch
    if isinstance(dtype, torch.dtype) and dtype in _DTYPES.values():
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


def _check_level(level):
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp level must be 'O0', 'O1' or 'O2', got "
                         f"{level!r}")


class AmpState:
    """The rule in force. `torch_ops` False: the mode passes torch's own
    ops through, and only the port's ops (`amp_op`) are cast."""

    __slots__ = ("enable", "level", "dtype", "custom_white", "custom_black",
                 "torch_ops")

    def __init__(self, enable, level, dtype, custom_white, custom_black,
                 torch_ops=True):
        self.enable = enable
        self.level = level
        self.dtype = dtype
        self.custom_white = custom_white or set()
        self.custom_black = custom_black or set()
        self.torch_ops = torch_ops


def amp_state() -> AmpState | None:
    return getattr(_tls, "amp", None)


def _bf16_residual_stream() -> bool:
    return str(flag("FLAGS_residual_dtype")).lower() in ("bf16", "bfloat16")


def amp_dtype_for(opname, st=None) -> torch.dtype | None:
    """The dtype op `opname`'s floating inputs are cast to under the AMP
    state `st` (the current one when None), or None (no cast)."""
    if st is None:
        st = amp_state()
    if st is None or not st.enable:
        return None
    if opname in _F32_INTERNAL_NORMS and opname not in st.custom_black \
            and _bf16_residual_stream():
        return st.dtype if st.level == "O2" else None
    if st.level == "O2":
        if opname in BLACK_LIST or opname in st.custom_black:
            return torch.float32
        return st.dtype
    # O1 (and O0, which the reference's rule reads as O1)
    if opname in st.custom_black or (opname in BLACK_LIST
                                     and opname not in st.custom_white):
        return torch.float32
    if opname in WHITE_LIST or opname in st.custom_white:
        return st.dtype
    return None


# ------------------------------------------------------------- the mode

#: operator stats ({op: {output dtype: count}}) while `debugging`
#: collects them, else None
_STATS = [None]


def _record(name, out):
    """Count op `name` under its (first) output's dtype."""
    o = out[0] if isinstance(out, (list, tuple)) and out else out
    if isinstance(o, torch.Tensor):
        dt = str(o.dtype).replace("torch.", "")
        per = _STATS[0].setdefault(name, {})
        per[dt] = per.get(dt, 0) + 1


def _cast(x, dt):
    """x with every floating tensor (in lists and tuples too) cast to
    dt."""
    if isinstance(x, torch.Tensor):
        return x.to(dt) if x.is_floating_point() and x.dtype != dt else x
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dt) for v in x)
    return x


_NAMES = None


def _op_names() -> dict:
    """{torch callable: the reference's op name} for the white and black
    lists' ops."""
    global _NAMES
    if _NAMES is None:
        F, T, la = torch.nn.functional, torch.Tensor, torch.linalg
        by_name = {
            "linear": [F.linear],
            "matmul": [torch.matmul, T.matmul, T.__matmul__,
                       T.__rmatmul__],
            "mm": [torch.mm, T.mm], "bmm": [torch.bmm, T.bmm],
            "mv": [torch.mv, T.mv], "addmm": [torch.addmm, T.addmm],
            "einsum": [torch.einsum],
            "conv1d": [F.conv1d], "conv2d": [F.conv2d],
            "conv3d": [F.conv3d], "conv2d_transpose": [F.conv_transpose2d],
            "scaled_dot_product_attention": [
                F.scaled_dot_product_attention],
            "exp": [torch.exp, T.exp], "log": [torch.log, T.log],
            "log2": [torch.log2, T.log2], "log10": [torch.log10, T.log10],
            "log1p": [torch.log1p, T.log1p],
            "pow": [torch.pow, T.pow, T.__pow__, T.__rpow__],
            "square": [torch.square, T.square],
            "sqrt": [torch.sqrt, T.sqrt], "rsqrt": [torch.rsqrt, T.rsqrt],
            "softmax": [F.softmax, torch.softmax, T.softmax],
            "log_softmax": [F.log_softmax, torch.log_softmax,
                            T.log_softmax],
            "cross_entropy": [F.cross_entropy], "mse_loss": [F.mse_loss],
            "l1_loss": [F.l1_loss],
            "binary_cross_entropy": [F.binary_cross_entropy],
            "bce_with_logits": [F.binary_cross_entropy_with_logits],
            "kl_div": [F.kl_div], "mean": [torch.mean, T.mean],
            "sum": [torch.sum, T.sum], "layer_norm": [F.layer_norm],
            "batch_norm": [F.batch_norm], "group_norm": [F.group_norm],
            "instance_norm": [F.instance_norm],
            "rms_norm": [getattr(F, "rms_norm", None)],
            "cumsum": [torch.cumsum, T.cumsum],
            "logsumexp": [torch.logsumexp, T.logsumexp],
            "norm": [torch.norm, T.norm, la.norm, la.vector_norm],
            "cosine_similarity": [F.cosine_similarity],
        }
        _NAMES = {fn: name for name, fns in by_name.items() for fn in fns
                  if fn is not None}
    return _NAMES


#: methods and functions that are no op of the rule at O2: metadata,
#: dtype and device conversion, host reads, autograd plumbing
_PASS_NAMES = {
    "__get__", "__set__", "to", "float", "double", "half", "bfloat16",
    "type", "type_as", "cpu", "cuda", "size", "dim", "numel", "data_ptr",
    "is_contiguous", "stride", "element_size", "storage_offset", "item",
    "tolist", "numpy", "detach", "requires_grad_", "backward",
    "register_hook", "retain_grad", "__setitem__", "__len__", "__repr__",
    "__format__", "__bool__", "__index__", "__int__", "__float__",
    "__deepcopy__", "__reduce_ex__", "untyped_storage", "is_floating_point",
    "get_device", "__hash__", "__eq__", "__ne__", "__contains__",
}


def _passes(func) -> bool:
    """Whether `func` is left alone at O2: a name of `_PASS_NAMES`, or an
    in-place method (its result's dtype is its target's)."""
    name = getattr(func, "__name__", "")
    return name in _PASS_NAMES or (name.endswith("_")
                                   and not name.startswith("__")) \
        or (name.startswith("__i") and name.endswith("__"))


class _AmpMode(TorchFunctionMode):
    """Casts the floating arguments of torch's ops by `amp_dtype_for` of
    their reference op name (module note)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        st = amp_state()
        if st is None or not st.enable or not st.torch_ops \
                or getattr(_tls, "depth", 0):
            return func(*args, **kwargs)
        name = _op_names().get(func)
        if name is None:
            passes = _passes(func)
            if passes or (st.level != "O2" and not st.custom_white
                          and not st.custom_black):
                out = func(*args, **kwargs)
                if _STATS[0] is not None and not passes:
                    _record(getattr(func, "__name__", "").strip("_"), out)
                return out
            # at O2, or named by a custom list: the op's own name
            name = getattr(func, "__name__", "").strip("_")
        target = amp_dtype_for(name)
        if target is not None:
            args = _cast(args, target)
            kwargs = {k: v if k == "out" else _cast(v, target)
                      for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        if _STATS[0] is not None:
            _record(name, out)
        return out


@contextlib.contextmanager
def _mode_installed():
    """Push the AMP mode unless this thread already runs under it."""
    if getattr(_tls, "mode", False):
        yield
        return
    _tls.mode = True
    try:
        with _AmpMode():
            yield
    finally:
        _tls.mode = False


def _cast_args(args, dt):
    """`_cast` of each of an op's operands, in one call."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.dtype != dt and a.is_floating_point():
                a = a.to(dt)
        elif isinstance(a, (list, tuple)):
            a = _cast(a, dt)
        out.append(a)
    return out


def cast_for(opname, x):
    """x cast as the rule casts the inputs of op `opname` (x itself with
    AMP off): for an activation that several such ops read, as q, k and v
    read the input norm's output, so that it is cast once and kept once
    for the backward."""
    target = amp_dtype_for(opname)
    return x if target is None else _cast(x, target)


def _f32_out(name, args):
    """args with the rule's f32 given as `out_dtype` where op `name` is
    one of `_F32_OUT_NORMS` called without one, else None. `rms_norm`'s
    kernel reads the weight in x's dtype, so a weight of another dtype
    takes the upcast instead."""
    if name not in _F32_OUT_NORMS or args[-1] is not None:
        return None
    if name == "rms_norm" and args[1] is not None \
            and args[1].dtype != args[0].dtype:
        return None
    return (*args[:-1], torch.float32)


def amp_op(name, fn, *args, **kwargs):
    """Run the port's op `fn` as the reference's op `name`: its floating
    tensor arguments (positional, and the elements of a positional list
    or tuple, which the reference unpacks into its operands: `concat`,
    `stack`, `add_n`, ...) cast by `amp_dtype_for(name)`, its body out of
    the mode's sight. With AMP off, `fn(*args, **kwargs)` after one
    thread-local read."""
    st = getattr(_tls, "amp", None)
    if st is None or not st.enable:
        return fn(*args, **kwargs)
    depth = getattr(_tls, "depth", 0)
    if depth == 0:
        target = amp_dtype_for(name, st)
        f32_out = target is torch.float32 and _f32_out(name, args)
        if f32_out:
            args = f32_out
        elif target is not None:
            args = _cast_args(args, target)
    _tls.depth = depth + 1
    try:
        out = fn(*args, **kwargs)
    finally:
        _tls.depth = depth
    if depth == 0 and _STATS[0] is not None:
        _record(name, out)
    return out


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """The reference's autocast context: the cast rule for the ops run
    inside it (module note)."""
    if enable:
        _check_level(level)
    old = amp_state()
    _tls.amp = AmpState(enable, level, _amp_dtype(dtype) if enable
                        else torch.bfloat16, set(custom_white_list or ()),
                        set(custom_black_list or ()))
    try:
        if enable:
            with _mode_installed():
                yield
        else:
            yield
    finally:
        _tls.amp = old


amp_guard = auto_cast


@contextlib.contextmanager
def amp_state_guard(state: AmpState | None):
    """Reinstall a captured AmpState (recompute re-runs its block in the
    backward under the forward's state, as the reference's PyLayer
    context saves it)."""
    old = amp_state()
    _tls.amp = state
    try:
        if state is not None and state.enable and state.torch_ops:
            with _mode_installed():
                yield
        else:
            yield
    finally:
        _tls.amp = old


def model_scope(model=None):
    """The context a model's forward runs in (module note): at O2 (with
    `SUSPEND_O2_IN_MODELS`) the rule for the port's ops alone; a `model`
    that `decorate` put at O2 runs so with AMP off too; otherwise
    nothing."""
    st = amp_state()
    if st is not None and st.enable:
        if st.level != "O2" or not SUSPEND_O2_IN_MODELS \
                or not st.torch_ops:
            return contextlib.nullcontext()
        return amp_state_guard(AmpState(True, "O2", st.dtype,
                                        st.custom_white, st.custom_black,
                                        torch_ops=False))
    dt = getattr(model, "_amp_o2_dtype", None)
    if dt is None:
        return contextlib.nullcontext()
    return amp_state_guard(AmpState(True, "O2", dt, None, None,
                                    torch_ops=False))


def model_forward(fn):
    """Decorate a model's `forward` to run in `model_scope`."""

    @functools.wraps(fn)
    def forward(self, *args, **kwargs):
        with model_scope(self):
            return fn(self, *args, **kwargs)

    return forward


# ------------------------------------------------------------- decorate

def _save_dtype_hook(dt):
    def hook(module, state_dict, prefix, local_metadata):
        for k, v in state_dict.items():
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                state_dict[k] = v.to(dt)
        return state_dict

    return hook


def _is_layer(m) -> bool:
    """Whether m is an `nn.Layer` (the Tensor API's layers; the models
    are torch modules)."""
    return hasattr(m, "_sub_layers") and not isinstance(m, torch.nn.Module)


def _layer_save_hook(dt):
    def hook(dest):
        out = collections.OrderedDict()
        for k, v in dest.items():
            out[k] = v.astype(dt) if hasattr(v, "astype") and \
                v.dtype.is_floating_point else v
        return out

    return hook


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters and floating buffers to `dtype` in
    place (the parameters of BatchNorm/LayerNorm layers stay f32) and set
    each optimizer's multi_precision (f32 master weights) to
    `master_weight is not False`; an `nn.Layer` and its sublayers are
    marked (`_amp_o2_dtype`), so that a model's forward runs the O2 rule
    for the port's ops with `auto_cast` off too (`model_scope`).
    `save_dtype`: the models' `state_dict`
    values come out in that dtype (a state-dict hook; the training dtypes
    are untouched). Returns `models`, or `(models, optimizers)` when
    optimizers are given. O0 and O1 change nothing else (O1 casts per op,
    in `auto_cast`). A model is a torch module (the port's models) or an
    `nn.Layer`, whose parameters keep their torch leaves (an optimizer
    built before still updates them), as the reference's decorate
    does."""
    from ..core.dtype import convert_dtype

    _check_level(level)
    target = _amp_dtype(dtype)
    ms = models if isinstance(models, (list, tuple)) else [models]
    if save_dtype is not None:
        sd = convert_dtype(save_dtype)
        for m in ms:
            if _is_layer(m):
                if not hasattr(m, "_state_dict_hooks"):
                    m._state_dict_hooks = {}
                m._state_dict_hooks[len(m._state_dict_hooks)] = \
                    _layer_save_hook(sd)
            else:
                m._register_state_dict_hook(_save_dtype_hook(sd))
    if level == "O2":
        for m in ms:
            if _is_layer(m):
                m._to_dtype(target)
                for sub in m.sublayers(include_self=True):
                    sub._amp_o2_dtype = target
                    if type(sub).__name__.startswith(("BatchNorm",
                                                      "LayerNorm")):
                        sub._apply_to_tensors(lambda t: t.float(),
                                              buffers=False)
                continue
            m.to(target)
            for sub in m.modules():
                if type(sub).__name__.startswith(("BatchNorm", "LayerNorm")):
                    sub.float()
        opts = optimizers if isinstance(optimizers, (list, tuple)) \
            else [optimizers]
        for opt in opts:
            if opt is not None:
                opt._multi_precision = master_weight is not False
    if optimizers is None:
        return models
    return models, optimizers


def is_float16_supported(device=None) -> bool:
    """Whether the device computes in float16: a CUDA card does (the
    reference answers for its default backend: a TPU or GPU, not the
    CPU)."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def is_bfloat16_supported(device=None) -> bool:
    return True


# ---------------------------------------------------------- GradScaler

class GradScaler:
    """Dynamic loss scaling with the reference's rule. The scale, the
    good and bad step counters and `found_inf` are tensors on `device`
    ("cuda" unless the caller asks for another; no card -> RuntimeError),
    so a captured train step reads and updates them on the card."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True,
                 device=None):
        dev = resolve_device(device)
        self._enable = enable
        self._scale = torch.tensor(float(init_loss_scaling),
                                   dtype=torch.float32, device=dev)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = torch.zeros((), dtype=torch.int32, device=dev)
        self._bad = torch.zeros((), dtype=torch.int32, device=dev)
        self._found_inf = torch.zeros((), dtype=torch.bool, device=dev)
        self._unscaled: set = set()   # optimizers unscaled this step

    def is_enable(self):
        return self._enable

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale.to(var.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale (in f32, rounded back to
        the gradient's dtype) and set `found_inf` on the device when one
        is not finite; once per optimizer per step."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        inv = 1.0 / self._scale
        found = torch.zeros_like(self._found_inf)
        for p in optimizer._parameters:
            if p.grad is not None:
                g = p.grad.float() * inv
                found = found | ~torch.isfinite(g).all()
                p.grad.copy_(g.to(p.grad.dtype))
        self._found_inf.copy_(found)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if compiled_call_active():
            # the reference's traced branch: the update masked by zeroed
            # gradients on overflow
            with torch.no_grad():
                for p in optimizer._parameters:
                    if p.grad is not None:
                        p.grad.copy_(torch.where(
                            self._found_inf, torch.zeros_like(p.grad),
                            p.grad))
            optimizer.step()
        elif not bool(self._found_inf):
            optimizer.step()

    @torch.no_grad()
    def update(self):
        self._unscaled.clear()
        if not self._enable or not self._dynamic:
            return
        found = self._found_inf
        good = torch.where(found, 0, self._good + 1)
        bad = torch.where(found, self._bad + 1, 0)
        scale = self._scale
        shrink = bad >= self._decr_every
        scale = torch.where(shrink, scale * self._decr_ratio, scale)
        bad = torch.where(shrink, 0, bad)
        grow = good >= self._incr_every
        scale = torch.where(grow, scale * self._incr_ratio, scale)
        good = torch.where(grow, 0, good)
        self._scale.copy_(torch.clamp_min(scale, 1.0))
        self._good.copy_(good)
        self._bad.copy_(bad)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def get_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale.fill_(float(v))

    def state_dict(self):
        return {"scale": np.asarray(self._scale.cpu().numpy()),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every}

    def load_state_dict(self, state):
        self._scale.copy_(torch.as_tensor(state["scale"],
                                          dtype=torch.float32))


# ------------------------------------------------------------ debugging

class debugging:
    """Port of paddle_tpu/amp/debug_tools.py: operator stats (each op the
    AMP rule sees while `auto_cast` is on, by its reference name, counted
    by its (first) output's dtype) and `compare_accuracy` (a callable in f32 and under
    AMP, each output's largest divergence)."""

    @staticmethod
    def enable_operator_stats_collection():
        _STATS[0] = {}

    @staticmethod
    def disable_operator_stats_collection() -> dict:
        """Stop collecting; returns {op name: {dtype: count}}."""
        out = _STATS[0] or {}
        _STATS[0] = None
        return out

    @staticmethod
    @contextlib.contextmanager
    def collect_operator_stats():
        """Collect inside the block; the dict it yields is filled at the
        end."""
        result = {}
        debugging.enable_operator_stats_collection()
        try:
            yield result
        finally:
            result.update(debugging.disable_operator_stats_collection())

    @staticmethod
    def compare_accuracy(func, args=(), dtype="bfloat16", level="O1",
                         rtol=1e-2, atol=1e-2, raise_on_mismatch=False):
        """func(*args) in f32 and under auto_cast(dtype, level): per
        output {"index", "max_abs", "max_rel", "ok"}."""
        ref = func(*args)
        with auto_cast(enable=True, dtype=dtype, level=level):
            got = func(*args)
        refs = ref if isinstance(ref, (list, tuple)) else [ref]
        gots = got if isinstance(got, (list, tuple)) else [got]
        report = []
        for i, (r, g) in enumerate(zip(refs, gots)):
            r, g = r.detach().double(), g.detach().double()
            diff = (r - g).abs()
            max_abs = diff.max().item() if diff.numel() else 0.0
            max_rel = (diff / r.abs().clamp_min(1e-12)).max().item() \
                if diff.numel() else 0.0
            ok = bool(torch.all(diff <= atol + rtol * r.abs()))
            report.append({"index": i, "max_abs": max_abs,
                           "max_rel": max_rel, "ok": ok})
            if raise_on_mismatch and not ok:
                raise AssertionError(f"amp accuracy mismatch at output {i}: "
                                     f"max_abs {max_abs}, max_rel {max_rel}")
        return report
