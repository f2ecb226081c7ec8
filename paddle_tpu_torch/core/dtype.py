"""The Paddle dtypes.

Port of paddle_tpu/core/dtype.py. The reference's dtypes are numpy
dtypes: `str(t.dtype)` is "float32", and a dtype compares equal to its
name and to the numpy dtype. The port's are `DType` objects over torch
dtypes that print and compare the same way and also equal the torch
dtype (`t.dtype == "float32"`, `== np.float32`, `== torch.float32` and
`== paddle_tpu_torch.float32` all hold); a DType hashes as its torch
dtype, so dicts keyed by torch dtypes find it. `Tensor.dtype` and the
public names (`float32`, `bfloat16`, ...) are DTypes; the op boundary
(`core.dispatch.op`) turns a DType argument into its torch dtype before
any op body runs, so no op body or kernel wrapper sees one.
`convert_dtype` takes the reference's spellings (a name such as
"float32" or "bf16", a numpy dtype or scalar type, a DType or a torch
dtype) and gives the torch dtype.
"""
from __future__ import annotations

import numpy as np
import torch


class DType:
    """A Paddle dtype over torch dtype `torch` (module note). Other
    attributes (`is_floating_point`, `itemsize`, ...) are the torch
    dtype's."""

    __slots__ = ("torch", "name")

    def __init__(self, t: torch.dtype):
        self.torch = t
        self.name = str(t).replace("torch.", "")

    def __str__(self):
        return self.name

    def __repr__(self):
        return f"paddle.{self.name}"

    def __hash__(self):
        # as the torch dtype, so dicts keyed by torch dtypes find it. It
        # equals its name too, but a set or dict keyed by names misses it,
        # as it misses the reference's numpy dtype: look names up by
        # str(dtype) (or `convert_dtype` first)
        return hash(self.torch)

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.torch == other.torch
        if isinstance(other, torch.dtype):
            return self.torch == other
        try:
            return convert_dtype(other) == self.torch
        except (TypeError, KeyError, ValueError):
            return False

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "torch"), name)

    def __reduce__(self):
        return (_by_name, (self.name,))


_BY_TORCH: dict = {}


def of(t: torch.dtype) -> DType:
    """The DType of torch dtype t."""
    d = _BY_TORCH.get(t)
    if d is None:
        d = _BY_TORCH[t] = DType(t)
    return d


def _by_name(name):
    return of(convert_dtype(name))


bool_ = of(torch.bool)
uint8 = of(torch.uint8)
int8 = of(torch.int8)
int16 = of(torch.int16)
int32 = of(torch.int32)
int64 = of(torch.int64)
float16 = of(torch.float16)
bfloat16 = of(torch.bfloat16)
float32 = of(torch.float32)
float64 = of(torch.float64)
complex64 = of(torch.complex64)
complex128 = of(torch.complex128)
float8_e4m3fn = of(torch.float8_e4m3fn)
float8_e5m2 = of(torch.float8_e5m2)

_STR2DTYPE = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32,
    "fp64": torch.float64, "bool_": torch.bool, "half": torch.float16,
    "float": torch.float32, "double": torch.float64, "int": torch.int64,
    "long": torch.int64,
}

_FLOATING = {torch.float16, torch.bfloat16, torch.float32, torch.float64,
             torch.float8_e4m3fn, torch.float8_e5m2}
_COMPLEX = {torch.complex64, torch.complex128}
_INTEGER = {torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64}

_TO_NUMPY = {torch.bool: np.bool_, torch.uint8: np.uint8,
             torch.int8: np.int8, torch.int16: np.int16,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.float16: np.float16, torch.float32: np.float32,
             torch.float64: np.float64, torch.complex64: np.complex64,
             torch.complex128: np.complex128}


def convert_dtype(dtype) -> torch.dtype | None:
    """Normalize a name / numpy dtype / DType / torch dtype to a torch
    dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, DType):
        return dtype.torch
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
    return d in _INTEGER or d == torch.bool


_default_dtype = torch.float32


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype():
    """The default floating dtype as a torch dtype (what the ops below
    the boundary pass to torch)."""
    return _default_dtype


def promote_types(a, b):
    return of(torch.promote_types(convert_dtype(a), convert_dtype(b)))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))
