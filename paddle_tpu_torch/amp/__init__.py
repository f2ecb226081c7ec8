"""Mixed precision: `decorate` and `auto_cast`.

Port of paddle_tpu/amp/__init__.py `decorate` and `auto_cast`. At O2, the
level the training path uses, `decorate` casts every parameter (and
floating buffer, such as the rope tables) of the models to bf16 — RMSNorm
weights included; only BatchNorm/LayerNorm layers stay f32, as the
reference keeps them — and sets the optimizer's `multi_precision` to
`master_weight is not False`; at O1 (the default, as the reference's)
and O0 it changes nothing, as the reference's does. The ops the reference
keeps in f32 under O2 (its BLACK_LIST: norms, softmax, cross-entropy) are
computed in f32 by the port's forward itself (the RMSNorms, in f32 inside
the fused kernel or the composition, with the input and final norms
writing f32 when `FLAGS_pallas_fused_ops` is on; the flash attention's
f32 softmax; the f32 logits of the loss), so
`auto_cast` at O2 casts nothing and only checks its arguments. `auto_cast`
at O1 (casting per op at dispatch) and GradScaler are not ported yet
(ROADMAP Queue 1 item 1c).
"""
from __future__ import annotations

import contextlib

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _amp_dtype(dtype) -> torch.dtype:
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


def _check_level(level):
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp level must be 'O0', 'O1' or 'O2', got "
                         f"{level!r}")


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None):
    """O2: cast the models' parameters and floating buffers to `dtype` in
    place (BatchNorm/LayerNorm layers stay f32) and set each optimizer's
    multi_precision (f32 master weights) to `master_weight is not False`.
    Returns `models`, or `(models, optimizers)` when optimizers are given.
    O0 and O1 change nothing (O1 casts per op, in `auto_cast`)."""
    _check_level(level)
    target = _amp_dtype(dtype)
    if level == "O2":
        for m in models if isinstance(models, (list, tuple)) else [models]:
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


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """The reference's autocast context. At O2 (or disabled) it casts
    nothing: the decorated parameters carry the dtype and the forward keeps
    the reference's f32 ops in f32. Custom lists and O1 are not ported."""
    if enable:
        _check_level(level)
        if level == "O1":
            raise NotImplementedError(
                "amp level O1 (per-op casting at dispatch) is not ported "
                "yet (ROADMAP Queue 1 item 1c); use O2")
        _amp_dtype(dtype)
        if custom_white_list or custom_black_list:
            raise NotImplementedError(
                "custom amp op lists are not ported yet (ROADMAP Queue 1 "
                "item 1c)")
    yield
