"""paddle.fft: discrete Fourier transforms.

Port of paddle_tpu/fft.py (its 22 names). The reference's transforms are
`jnp.fft` (XLA FFT HLOs; no Pallas kernel), so each is an op of the
Tensor API over `torch.fft` (cuFFT on the card). Result dtypes are
jnp's, not torch's: a real input of float64 or int64 transforms in
float64 (complex128 out), every other real input (float32, bfloat16,
float16, the narrower ints, bool) in float32 (complex64 out). The real
to complex transforms (`rfft`, `rfft2`, `rfftn`, `ihfft`) refuse a
complex input and a bfloat16 or float16 one with ValueError, as jnp's
do. `hfftn` / `ihfftn` compose the last axis's hermitian transform with
a complex transform over the other axes, as the reference does.
"""
from __future__ import annotations

import torch

from .core import dtype as dtypes
from .core.device import device_of
from .core.dispatch import op
from .core.tensor import Tensor

__all__ = [
    'fft', 'ifft', 'rfft', 'irfft', 'hfft', 'ihfft',
    'fft2', 'ifft2', 'rfft2', 'irfft2', 'hfft2', 'ihfft2',
    'fftn', 'ifftn', 'rfftn', 'irfftn', 'hfftn', 'ihfftn',
    'fftfreq', 'rfftfreq', 'fftshift', 'ifftshift',
]

_NORMS = ("backward", "ortho", "forward")
_HALF = (torch.bfloat16, torch.float16)


def _norm(norm):
    norm = norm or "backward"
    if norm not in _NORMS:
        raise ValueError(
            f"Unexpected norm: {norm!r}. Norm should be forward, backward "
            "or ortho")
    return norm


def _inexact(a):
    """a as jnp's transforms take it: complex as it is, float64 and int64
    as float64, every other real dtype as float32."""
    if a.is_complex():
        return a
    if a.dtype in (torch.float64, torch.int64):
        return a.to(torch.float64)
    return a.to(torch.float32)


def _real_in(a, what="rfft"):
    """The input of a real-to-complex transform (jnp's refusals)."""
    if a.is_complex():
        raise ValueError(f"only real valued inputs supported for {what}")
    if a.dtype in _HALF:
        raise ValueError(f"RFFT input must be float32 or float64, got "
                         f"{dtypes.dtype_name(dtypes.of(a.dtype))}")
    return _inexact(a)


def _axes(axes):
    return None if axes is None else tuple(axes)


@op("fft")
def fft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.fft(_inexact(x), n=n, dim=axis, norm=_norm(norm))


@op("ifft")
def ifft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.ifft(_inexact(x), n=n, dim=axis, norm=_norm(norm))


@op("rfft")
def rfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.rfft(_real_in(x), n=n, dim=axis, norm=_norm(norm))


@op("irfft")
def irfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.irfft(_inexact(x), n=n, dim=axis, norm=_norm(norm))


@op("hfft")
def hfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.hfft(_inexact(x), n=n, dim=axis, norm=_norm(norm))


@op("ihfft")
def ihfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.ihfft(_real_in(x, "ihfft"), n=n, dim=axis,
                           norm=_norm(norm))


@op("fftn")
def fftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.fftn(_inexact(x), s=s, dim=_axes(axes),
                          norm=_norm(norm))


@op("ifftn")
def ifftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.ifftn(_inexact(x), s=s, dim=_axes(axes),
                           norm=_norm(norm))


@op("rfftn")
def rfftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.rfftn(_real_in(x), s=s, dim=_axes(axes),
                           norm=_norm(norm))


@op("irfftn")
def irfftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.irfftn(_inexact(x), s=s, dim=_axes(axes),
                            norm=_norm(norm))


def _split_last(ndim, s, axes):
    """(s, axes) -> (the other axes' sizes, the other axes, the last
    axis's size, the last axis)."""
    if axes is None:
        axes = list(range(ndim)) if s is None else \
            list(range(ndim - len(s), ndim))
    axes = [a % ndim for a in axes]
    if s is None:
        s = [None] * len(axes)
    elif len(s) != len(axes):
        raise ValueError(
            f"Shape and axes have different lengths: {len(s)} vs "
            f"{len(axes)}")
    return list(s[:-1]), axes[:-1], s[-1], axes[-1]


@op("hfftn")
def hfftn(x, s=None, axes=None, norm="backward", name=None):
    """n-dim FFT of a signal hermitian along the last given axis: the
    complex transform over the other axes first, then the hermitian
    transform on the last one (real output)."""
    norm = _norm(norm)
    a = _inexact(x)
    so, axo, n_last, ax_last = _split_last(a.dim(), s, axes)
    if axo:
        sizes = [m if m is not None else a.shape[ax]
                 for m, ax in zip(so, axo)]
        a = torch.fft.fftn(a, s=sizes, dim=axo, norm=norm)
    return torch.fft.hfft(a, n=n_last, dim=ax_last, norm=norm)


@op("ihfftn")
def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    """The inverse of `hfftn`: the inverse complex transform over the
    other axes, then the last axis's inverse transform, of which the half
    spectrum is kept (any input dtype, as the reference's)."""
    norm = _norm(norm)
    a = _inexact(x)
    so, axo, n_last, ax_last = _split_last(a.dim(), s, axes)
    if axo:
        sizes = [m if m is not None else a.shape[ax]
                 for m, ax in zip(so, axo)]
        a = torch.fft.ifftn(a, s=sizes, dim=axo, norm=norm)
    n = n_last if n_last is not None else a.shape[ax_last]
    full = torch.fft.ifft(a, n=n, dim=ax_last, norm=norm)
    return full.narrow(ax_last, 0, n // 2 + 1)


def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return fftn(x, s=s, axes=axes, norm=norm)


def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return ifftn(x, s=s, axes=axes, norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return rfftn(x, s=s, axes=axes, norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return irfftn(x, s=s, axes=axes, norm=norm)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return hfftn(x, s=s, axes=axes, norm=norm)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return ihfftn(x, s=s, axes=axes, norm=norm)


def _freq(fn, n, d, dtype):
    dt = dtypes.convert_dtype(dtype or "float32")
    f = fn(n, d=d, dtype=torch.float64, device=device_of(None))
    return Tensor._wrap(f.to(dt))


def fftfreq(n, d=1.0, dtype=None, name=None):
    """The sample frequencies of an n-point transform (float32 unless
    `dtype` says otherwise), on the current device."""
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


@op("fftshift")
def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(x, dim=_axes(axes))


@op("ifftshift")
def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(x, dim=_axes(axes))
