"""The port's `signal` held to paddle_tpu's on the CPU (ROADMAP.md Queue
1 item 1f; the `fft` half is test_torch_fft_signal.py, whose helpers and
tolerances this file shares).

`frame` / `overlap_add` on both axes, `stft` / `istft` across their
options, and the window's gradient, against the reference; the
reference's own cases (tests/test_fft_signal_geometric.py) on the port;
`Tensor.stft` / `istft`.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from test_torch_fft_signal import _both, _close, _np, _setup  # noqa: F401

# ------------------------------------------------------------------ signal
@pytest.mark.parametrize("axis,shape", [(-1, (3, 20)), (-1, (20,)),
                                        (0, (20, 3)), (0, (20, 2, 2))])
def test_frame_and_overlap_add(axis, shape):
    x = np.random.RandomState(5).randn(*shape).astype("float32")
    got, want = _both(lambda pkg, t: pkg.signal.frame(t, 6, 4, axis=axis),
                      x)
    _close(got, want, 0)
    fr = _np(want)
    got, want = _both(lambda pkg, t: pkg.signal.overlap_add(t, 4,
                                                            axis=axis), fr)
    _close(got, want, 1e-6)
    for pkg in (pt, paddle):
        with pytest.raises(ValueError):
            pkg.signal.frame(pkg.to_tensor(x), 64, 4, axis=axis)
        with pytest.raises(ValueError):
            pkg.signal.frame(pkg.to_tensor(x), 4, 2, axis=1)


def test_frame_and_overlap_add_gradients():
    x = np.random.RandomState(6).randn(2, 20).astype("float32")
    for fn in (lambda pkg, t: pkg.signal.frame(t, 6, 4),
               lambda pkg, t: pkg.signal.overlap_add(
                   pkg.reshape(t, [2, 4, 5]), 3)):
        grads = []
        for pkg in (pt, paddle):
            t = pkg.to_tensor(x, stop_gradient=False)
            out = fn(pkg, t)
            (out * out).sum().backward()
            grads.append(t.grad)
        _close(*grads, 1e-6)


STFT_CASES = {
    "default": dict(n_fft=32, hop_length=8),
    "window": dict(n_fft=32, hop_length=8, window="hann"),
    "short window": dict(n_fft=32, hop_length=8, win_length=20,
                         window="hann20"),
    "no centre": dict(n_fft=32, hop_length=8, center=False),
    "constant pad": dict(n_fft=32, hop_length=8, pad_mode="constant"),
    "normalized two-sided": dict(n_fft=32, normalized=True, onesided=False),
}


def _window(pkg, kw):
    kw = dict(kw)
    w = kw.pop("window", None)
    if w is not None:
        n = 20 if w == "hann20" else kw["n_fft"]
        kw["window"] = pkg.to_tensor(np.hanning(n).astype("float32"))
    return kw


@pytest.mark.parametrize("case", list(STFT_CASES))
def test_stft_istft_match_reference(case):
    x = np.random.RandomState(8).randn(3, 160).astype("float32")
    kw = STFT_CASES[case]
    specs = _both(lambda pkg, t: pkg.signal.stft(t, **_window(pkg, kw)), x)
    _close(*specs, 1e-5)
    ikw = {k: v for k, v in kw.items() if k != "pad_mode"}
    if "onesided" in ikw:
        ikw["return_complex"] = False
    backs = [pkg.signal.istft(s, length=160, **_window(pkg, ikw))
             for pkg, s in zip((pt, paddle), specs)]
    _close(*backs, 1e-5)


def test_stft_complex_input_and_refusals():
    rs = np.random.RandomState(9)
    c = (rs.randn(64) + 1j * rs.randn(64)).astype("complex64")
    got, want = _both(lambda pkg, t: pkg.signal.stft(t, 16, onesided=False),
                      c)
    _close(got, want, 1e-5)
    for pkg in (pt, paddle):
        with pytest.raises(ValueError):
            pkg.signal.stft(pkg.to_tensor(c), 16, onesided=True)
        with pytest.raises(ValueError, match="too short"):
            pkg.signal.stft(pkg.to_tensor(np.ones(5, "float32")), 8,
                            hop_length=4, center=False)
        with pytest.raises(ValueError):
            pkg.signal.istft(pkg.to_tensor(np.ones((5, 3), "complex64")),
                             16)


def test_stft_window_gradient_matches_the_reference_tape():
    x = np.random.RandomState(9).randn(64).astype("float32")
    w = np.hanning(16).astype("float32")
    grads = []
    for pkg in (pt, paddle):
        wt = pkg.to_tensor(w, stop_gradient=False)
        xt = pkg.to_tensor(x, stop_gradient=False)
        spec = pkg.signal.stft(xt, n_fft=16, hop_length=8, window=wt)
        (spec.real() ** 2 + spec.imag() ** 2).sum().backward()
        grads.append((wt.grad, xt.grad))
    for a, b in zip(*grads):
        _close(a, b, 1e-5)
    assert np.abs(_np(grads[0][0])).sum() > 0


def test_reference_signal_cases_on_the_port():
    """tests/test_fft_signal_geometric.py TestSignal on the port."""
    x = np.arange(8).astype("float32")
    y = pt.signal.frame(pt.to_tensor(x), 4, 2, axis=-1)
    np.testing.assert_allclose(y.numpy(), [[0, 2, 4], [1, 3, 5], [2, 4, 6],
                                           [3, 5, 7]])
    x1 = np.arange(16).reshape(8, 2).astype("float32")
    assert pt.signal.frame(pt.to_tensor(x1), 4, 2, axis=0).shape == \
        [3, 4, 2]
    x = np.random.RandomState(0).randn(32).astype("float32")
    fr = pt.signal.frame(pt.to_tensor(x), 4, 4, axis=-1)
    np.testing.assert_allclose(pt.signal.overlap_add(fr, 4).numpy(), x,
                               rtol=1e-6, atol=1e-6)
    x = np.random.RandomState(1).randn(2, 256).astype("float32")
    w = pt.to_tensor(np.hanning(64).astype("float32"))
    spec = pt.signal.stft(pt.to_tensor(x), n_fft=64, hop_length=16,
                          window=w)
    assert spec.shape[-2] == 33
    back = pt.signal.istft(spec, n_fft=64, hop_length=16, window=w,
                           length=256)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-3, atol=1e-3)
    spec = pt.signal.stft(pt.to_tensor(x[0, :128]), n_fft=32,
                          onesided=False, normalized=True)
    assert spec.shape[-2] == 32


def test_tensor_stft_methods_no_longer_refuse():
    """`paddle.stft` / `istft` (and the Tensor methods) are signal's, as
    the reference's tensor-level aliases."""
    x = np.random.RandomState(3).randn(2, 128).astype("float32")
    t = pt.to_tensor(x)
    spec = pt.stft(t, 32, 8)
    _close(spec, paddle.stft(paddle.to_tensor(x), 32, 8), 1e-5)
    back = pt.istft(spec, 32, 8, length=128)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    assert torch.is_tensor(pt.signal.stft(torch.from_numpy(x), 32, 8))
