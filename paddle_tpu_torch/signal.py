"""paddle.signal: frame / overlap_add / stft / istft.

Port of paddle_tpu/signal.py. The reference's are XLA compositions (a
gather of frames, a scatter-add, `jnp.fft`), so each is an op of the
Tensor API in plain torch: `unfold` takes the frames (a strided view),
`index_add` sums the overlaps, `torch.fft` (cuFFT on the card)
transforms. Shapes, checks, the window's centre padding, the least
squares overlap-add of `istft` and its result dtypes are the
reference's. On the card the overlap sums are atomic adds, whose order
(and so the last bits of a float sum) may change from run to run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .core.dispatch import op
from .fft import _inexact, _real_in

__all__ = ['stft', 'istft']

#: the reference's `jnp.pad` modes as torch's `F.pad` names them
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "replicate": "replicate",
              "wrap": "circular", "circular": "circular"}


def _check_pos_int(v, what):
    if not isinstance(v, int) or v <= 0:
        raise ValueError(
            f'Unexpected {what}: {v}. It should be an positive integer.')


def _check_axis(axis):
    if axis not in (0, -1):
        raise ValueError(f'Unexpected axis: {axis}. It should be 0 or -1.')


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Slice into overlapping frames. axis=-1: [..., L] -> [...,
    frame_length, num_frames]; axis=0: [L, ...] -> [num_frames,
    frame_length, ...]."""
    _check_axis(axis)
    _check_pos_int(frame_length, 'frame_length')
    _check_pos_int(hop_length, 'hop_length')
    n = x.shape[axis]
    if frame_length > n:
        raise ValueError(
            f'Attribute frame_length should be less equal than sequence '
            f'length, but got ({frame_length}) > ({n}).')
    return _frame(x, frame_length, hop_length, axis)


@op("frame")
def _frame(x, frame_length, hop_length, axis):
    fr = x.unfold(axis, frame_length, hop_length)
    if axis == -1:
        return fr.transpose(-1, -2)       # [..., frame_length, n_frames]
    return fr.movedim(-1, 1)              # [n_frames, frame_length, ...]


def _segments(n_frames, length, hop, device):
    """The output position of each element of [n_frames, length] frames,
    flattened."""
    return (torch.arange(n_frames, device=device)[:, None] * hop
            + torch.arange(length, device=device)[None, :]).reshape(-1)


def overlap_add(x, hop_length, axis=-1, name=None):
    """Sum overlapping frames back into a signal (the inverse of `frame`):
    axis=-1: [..., frame_length, n_frames] -> [..., output_len]."""
    _check_axis(axis)
    _check_pos_int(hop_length, 'hop_length')
    return _overlap_add(x, hop_length, axis)


@op("overlap_add")
def _overlap_add(x, hop_length, axis):
    if axis == -1:
        frame_length, n_frames = x.shape[-2], x.shape[-1]
        fr = x.transpose(-1, -2)          # [..., n_frames, frame_length]
        lead = x.shape[:-2]
    else:
        n_frames, frame_length = x.shape[0], x.shape[1]
        fr = x.movedim(1, -1).movedim(0, -2)
        lead = x.shape[2:]
    out_len = (n_frames - 1) * hop_length + frame_length
    flat = fr.reshape(*lead, n_frames * frame_length)
    seg = _segments(n_frames, frame_length, hop_length, x.device)
    out = x.new_zeros(*lead, out_len).index_add(-1, seg, flat)
    return out if axis == -1 else out.movedim(-1, 0)


def _window(window, win_length):
    if window is None:
        return None
    wshape = tuple(window.shape)
    if wshape != (win_length,):
        raise ValueError(f'Unexpected window shape: {wshape}, expected '
                         f'({win_length},)')
    return window


def _centre(w, win_length, n_fft):
    """The window zero-padded to n_fft, centred."""
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = F.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """Short-time Fourier transform; output [..., freq, num_frames]."""
    _check_pos_int(n_fft, 'n_fft')
    hop_length = hop_length if hop_length is not None else n_fft // 4
    win_length = win_length if win_length is not None else n_fft
    _check_pos_int(hop_length, 'hop_length')
    if not 0 < win_length <= n_fft:
        raise ValueError(f'Unexpected win_length: {win_length}.')
    complex_input = x.dtype in (torch.complex64, torch.complex128)
    if complex_input and onesided:
        raise ValueError(
            'onesided should be False when input is a complex Tensor.')
    if pad_mode not in _PAD_MODES:
        raise ValueError(f'Unexpected pad_mode: {pad_mode!r}.')
    window = _window(window, win_length)
    seq_len = x.shape[-1] + (2 * (n_fft // 2) if center else 0)
    if seq_len < n_fft:
        raise ValueError(
            f'Input too short: {x.shape[-1]} samples with n_fft={n_fft} '
            f'(center={center}) yields no complete frame.')
    return _stft(x, window, n_fft, hop_length, win_length, center,
                 _PAD_MODES[pad_mode], normalized, onesided, complex_input)


@op("stft")
def _stft(a, w, n_fft, hop, win_length, center, pad_mode, normalized,
          onesided, complex_input):
    if w is None:
        w = torch.ones(win_length, dtype=torch.float32, device=a.device)
    w = _centre(w, win_length, n_fft)
    if center:
        pad = n_fft // 2
        lead = a.shape[:-1]
        a = F.pad(a.reshape(-1, 1, a.shape[-1]), (pad, pad),
                  mode=pad_mode).reshape(*lead, -1)
    fr = a.unfold(-1, n_fft, hop) * w          # [..., n_frames, n_fft]
    if complex_input:
        spec = torch.fft.fft(fr, dim=-1)
    elif onesided:
        spec = torch.fft.rfft(_real_in(fr), dim=-1)
    else:
        spec = torch.fft.fft(fr.to(torch.complex64), dim=-1)
    if normalized:
        spec = spec / torch.sqrt(torch.tensor(
            float(n_fft), dtype=spec.real.dtype, device=spec.device))
    return spec.transpose(-1, -2)              # [..., freq, n_frames]


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse STFT (least-squares overlap-add); input [..., freq,
    frames]."""
    _check_pos_int(n_fft, 'n_fft')
    hop_length = hop_length if hop_length is not None else n_fft // 4
    win_length = win_length if win_length is not None else n_fft
    if return_complex and onesided:
        raise ValueError(
            'onesided should be False when return_complex is True.')
    n_freq = x.shape[-2]
    expected = n_fft // 2 + 1 if onesided else n_fft
    if n_freq != expected:
        raise ValueError(
            f'Unexpected freq dim: {n_freq}, expected {expected}.')
    window = _window(window, win_length)
    return _istft(x, window, n_fft, hop_length, win_length, center,
                  normalized, onesided, length, return_complex)


@op("istft")
def _istft(a, w, n_fft, hop, win_length, center, normalized, onesided,
           length, return_complex):
    if w is None:
        w = torch.ones(win_length, dtype=torch.float32, device=a.device)
    w = _centre(w, win_length, n_fft)
    n_frames = a.shape[-1]
    spec = _inexact(a).transpose(-1, -2)       # [..., n_frames, freq]
    if normalized:
        spec = spec * torch.sqrt(torch.tensor(
            float(n_fft), dtype=spec.real.dtype, device=spec.device))
    if onesided:
        fr = torch.fft.irfft(spec, n=n_fft, dim=-1)
    else:
        fr = torch.fft.ifft(spec, dim=-1)
        if not return_complex:
            fr = fr.real
    fr = fr * w                                 # windowed frames
    out_len = (n_frames - 1) * hop + n_fft
    seg = _segments(n_frames, n_fft, hop, fr.device)
    lead = fr.shape[:-2]
    num = fr.new_zeros(*lead, out_len).index_add(
        -1, seg, fr.reshape(*lead, n_frames * n_fft))
    den = w.new_zeros(out_len).index_add(0, seg, (w * w).repeat(n_frames))
    out = num / torch.where(den > 1e-11, den, 1.0)
    if center:
        out = out[..., n_fft // 2: out_len - n_fft // 2]
    if length is not None:
        if length > out.shape[-1]:   # zero-pad the tail, as the reference
            out = F.pad(out, (0, length - out.shape[-1]))
        else:
            out = out[..., :length]
    return out
