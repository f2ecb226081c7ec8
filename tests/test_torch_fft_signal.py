"""The port's `fft` and `signal` held to paddle_tpu's on the CPU
(ROADMAP.md Queue 1 item 1f).

Every name of the reference's `fft.__all__` on the same seeded inputs:
values (1e-5 of the largest |value|, f64 1e-10), result dtypes by jnp's
rule (float32, int32, bool, bfloat16, float16 -> complex64 or float32;
float64, int64 -> complex128 or float64), the three `norm` modes, the
refusals (a complex or half input to a real-to-complex transform, an
unknown norm); gradients of each transform against the reference's tape
(5e-5 of the largest |value|), and the reference's complex gradient
convention (`abs` of a complex gives dout * x / |x|, |w|^2 gives 2w).
The reference's own fft cases (tests/test_fft_signal_geometric.py) on
the port. `signal` is in test_torch_signal.py.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as port_device

FFT_NAMES = ['fft', 'ifft', 'rfft', 'irfft', 'hfft', 'ihfft',
             'fft2', 'ifft2', 'rfft2', 'irfft2', 'hfft2', 'ihfft2',
             'fftn', 'ifftn', 'rfftn', 'irfftn', 'hfftn', 'ihfftn',
             'fftfreq', 'rfftfreq', 'fftshift', 'ifftshift']
TRANSFORMS = [n for n in FFT_NAMES if "freq" not in n]
#: the transforms of a real input to a complex spectrum (jnp's refusals)
R2C = ("rfft", "ihfft", "rfft2", "rfftn")


@pytest.fixture(autouse=True, scope="module")
def _setup():
    prev = port_device._current
    pt.set_device("cpu")
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    paddle.set_flags(old)
    port_device._current = prev


def _np(t):
    return np.asarray(t._data) if isinstance(t, paddle.Tensor) \
        else t.numpy()


def _close(got, want, tol=1e-5):
    """Same dtype name and shape; values within tol of the largest
    |value| (compared in complex128)."""
    assert str(got.dtype) == str(want.dtype)
    got, want = (_np(t).astype("complex128") for t in (got, want))
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def _both(fn, *arrays, **kw):
    """fn of the port and of the reference on the same arrays."""
    return (fn(pt, *[pt.to_tensor(a) for a in arrays], **kw),
            fn(paddle, *[paddle.to_tensor(a) for a in arrays], **kw))


def test_fft_exports_every_reference_name():
    assert pt.fft.__all__ == paddle.fft.__all__ == FFT_NAMES
    assert all(callable(getattr(pt.fft, n)) for n in FFT_NAMES)


@pytest.mark.parametrize("name", TRANSFORMS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "complex64"])
def test_transform_values_and_dtypes(name, dtype):
    rs = np.random.RandomState(1)
    x = rs.randn(4, 6) * 3
    if dtype == "complex64":
        x = (x + 1j * rs.randn(4, 6)).astype(dtype)
    else:
        x = x.astype(dtype)
    if dtype == "complex64" and name in R2C:
        for pkg in (pt, paddle):
            with pytest.raises(ValueError, match="real valued"):
                getattr(pkg.fft, name)(pkg.to_tensor(x))
        return
    got, want = (getattr(pkg.fft, name)(pkg.to_tensor(x, dtype=dtype))
                 for pkg in (pt, paddle))
    _close(got, want, 1e-10 if dtype in ("float64", "int64") else 1e-5)


@pytest.mark.parametrize("name", TRANSFORMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "bool"])
def test_narrow_inputs_follow_jnp(name, dtype):
    """bfloat16 / float16 transform in float32 except into a real-to-
    complex spectrum, which refuses them (ValueError) as jnp does; bool
    transforms as float32."""
    x = np.random.RandomState(2).randn(4, 6).astype("float32")
    if dtype == "bool":
        x = x > 0
    def run(pkg):
        t = pkg.to_tensor(x)
        if dtype != "bool":
            t = t.astype(dtype)
        return getattr(pkg.fft, name)(t)

    if dtype != "bool" and name in ("rfft", "ihfft", "rfft2", "rfftn"):
        for pkg in (pt, paddle):
            with pytest.raises(ValueError, match="float32 or float64"):
                run(pkg)
        return
    _close(run(pt), run(paddle), 1e-5)


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
@pytest.mark.parametrize("name", ["fft", "ifft", "rfft", "irfft", "hfft",
                                  "ihfft", "fftn", "rfftn", "irfftn",
                                  "hfftn", "ihfftn"])
def test_norm_modes_sizes_and_axes(name, norm):
    rs = np.random.RandomState(3)
    x = (rs.randn(3, 5, 8) + 1j * rs.randn(3, 5, 8)).astype("complex64")
    if name in R2C or name in ("rfftn", "ihfft"):
        x = x.real.copy()
    if name.endswith("n"):
        kw = dict(s=[4, 6], axes=[0, 2], norm=norm)
    else:
        kw = dict(n=6, axis=1, norm=norm)
    got, want = _both(lambda pkg, t: getattr(pkg.fft, name)(t, **kw), x)
    _close(got, want)


def test_norm_validation():
    for pkg in (pt, paddle):
        with pytest.raises(ValueError, match="Unexpected norm"):
            pkg.fft.fft(pkg.to_tensor(np.ones(4, "float32")), norm="bogus")


@pytest.mark.parametrize("name,kw", [("fftfreq", {}), ("rfftfreq", {}),
                                     ("fftfreq", {"d": 0.5}),
                                     ("rfftfreq", {"dtype": "float64"})])
def test_frequencies(name, kw):
    got = getattr(pt.fft, name)(9, **kw)
    want = getattr(paddle.fft, name)(9, **kw)
    _close(got, want, 0)
    assert got.stop_gradient


@pytest.mark.parametrize("name", ["fftshift", "ifftshift"])
@pytest.mark.parametrize("axes", [None, [1], (0, 1)])
def test_shifts(name, axes):
    x = np.arange(35, dtype="int64").reshape(5, 7)
    got, want = _both(lambda pkg, t: getattr(pkg.fft, name)(t, axes=axes),
                      x)
    _close(got, want, 0)


def _grad(pkg, name, x):
    t = pkg.to_tensor(x, stop_gradient=False)
    out = getattr(pkg.fft, name)(t)
    if out.dtype in (pkg.complex64, pkg.complex128):
        loss = (out.real() * 1.5 - out.imag() * 0.5).sum() + \
            (out.abs() ** 2).sum() * 0.1
    else:
        loss = (out * out).sum()
    loss.backward()
    return t.grad


@pytest.mark.parametrize("name", TRANSFORMS)
def test_gradients_match_the_reference_tape(name):
    """Real input for the real-to-complex transforms, complex input for
    the rest: the input's gradient equals the reference tape's
    (Paddle's convention for complex inputs)."""
    rs = np.random.RandomState(4)
    x = rs.randn(4, 6)
    if name not in R2C:
        x = x + 1j * rs.randn(4, 6)
    x = x.astype("complex64" if np.iscomplexobj(x) else "float32")
    _close(_grad(pt, name, x), _grad(paddle, name, x), 5e-5)


def test_complex_gradient_convention():
    """The reference's AbsGradFunctor<complex>: dout * x / |x|; and
    |w|^2 = re^2 + im^2 gives 2w."""
    for pkg in (pt, paddle):
        z = pkg.to_tensor(np.array([3 + 4j], dtype="complex64"),
                          stop_gradient=False)
        pkg.abs(z).sum().backward()
        np.testing.assert_allclose(_np(z.grad), [0.6 + 0.8j], rtol=1e-5)
        w = pkg.to_tensor(np.array([1 + 2j, 3 - 1j], dtype="complex64"),
                          stop_gradient=False)
        (w.real() ** 2 + w.imag() ** 2).sum().backward()
        np.testing.assert_allclose(_np(w.grad), 2 * _np(w), rtol=1e-5)


def test_reference_fft_cases_on_the_port():
    """tests/test_fft_signal_geometric.py TestFFT's numpy checks."""
    rs = np.random.RandomState(7)
    x = rs.randn(4, 16).astype("float32")
    c = (rs.randn(4, 16) + 1j * rs.randn(4, 16)).astype("complex64")
    for norm in ("backward", "ortho", "forward"):
        out = pt.fft.fft(pt.to_tensor(c), norm=norm)
        np.testing.assert_allclose(out.numpy(), np.fft.fft(c, norm=norm),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(pt.fft.ifft(out, norm=norm).numpy(), c,
                                   rtol=1e-4, atol=1e-4)
    t = pt.to_tensor(x)
    np.testing.assert_allclose(pt.fft.irfft(pt.fft.rfft(t)).numpy(),
                               np.fft.irfft(np.fft.rfft(x)), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pt.fft.hfft(pt.to_tensor(c)).numpy(),
                               np.fft.hfft(c), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pt.fft.ihfft(t).numpy(), np.fft.ihfft(x),
                               rtol=1e-4, atol=1e-4)
    got = pt.fft.hfftn(pt.to_tensor(c)).numpy()
    np.testing.assert_allclose(got, np.fft.hfft(np.fft.fftn(c, axes=[0]),
                                                axis=-1), rtol=1e-3,
                               atol=1e-3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        pt.fft.ihfftn(t).numpy(),
        np.fft.ifftn(np.fft.ihfft(x, axis=-1), axes=[0]), rtol=1e-4,
        atol=1e-5)
    t.stop_gradient = False
    y = pt.fft.rfft(t)
    (y.real() ** 2 + y.imag() ** 2).sum().backward()
    assert np.isfinite(t.grad.numpy()).all()
