"""The Paddle dtype names over torch dtypes.

Port of paddle_tpu/core/dtype.py. The reference's dtypes are numpy
dtypes (what jax consumes); the port's are torch dtypes, so a `Tensor`'s
`dtype` compares equal to `paddle_tpu_torch.float32` and to
`torch.float32` alike. `convert_dtype` takes the reference's spellings:
a name ("float32", "bf16", ...), a numpy dtype or scalar type, or a torch
dtype.
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_STR2DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn, "float8_e5m2": float8_e5m2,
    "fp16": float16, "bf16": bfloat16, "fp32": float32, "fp64": float64,
    "bool_": bool_, "half": float16, "float": float32, "double": float64,
    "int": int64, "long": int64,
}

_FLOATING = {float16, bfloat16, float32, float64, float8_e4m3fn,
             float8_e5m2}
_COMPLEX = {complex64, complex128}
_INTEGER = {uint8, int8, int16, int32, int64}

_TO_NUMPY = {bool_: np.bool_, uint8: np.uint8, int8: np.int8,
             int16: np.int16, int32: np.int32, int64: np.int64,
             float16: np.float16, float32: np.float32, float64: np.float64,
             complex64: np.complex64, complex128: np.complex128}


def convert_dtype(dtype) -> torch.dtype | None:
    """Normalize a name / numpy dtype / torch dtype to a torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        d = _STR2DTYPE.get(dtype)
        if d is not None:
            return d
        return _STR2DTYPE[np.dtype(dtype).name]
    return _STR2DTYPE[np.dtype(dtype).name]


def dtype_name(dtype) -> str:
    """The reference's name of a dtype ("float32", "bool", ...)."""
    return str(convert_dtype(dtype)).replace("torch.", "")


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in _FLOATING


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in _COMPLEX


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d in _INTEGER or d == bool_


_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype():
    return _default_dtype


def promote_types(a, b):
    return torch.promote_types(convert_dtype(a), convert_dtype(b))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))
