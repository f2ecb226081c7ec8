"""The port's `jit.to_static` against paddle_tpu's: the reference's
contracts (`tests/test_jit.py`, save/load aside) on both packages from
the same numpy weights and inputs, and the port's own cases.

On the CPU the port's compiled call is the function run on its static
inputs (a card captures and replays a CUDA graph; tests/
test_torch_cuda_kernels.py holds that against eager steps): the phases,
keys, guards, breaks, outputs and the compiled-call marker are the same.
Tolerances: f32 results of the same function within 1e-6 (a compiled
reference program may fuse and reorder); the Adam + GradScaler step's
losses within rtol 2e-4, atol 1e-5 of each package's eager run and of
each other, as the reference's own test holds them.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
import paddle_tpu.nn as pnn
import paddle_tpu.nn.functional as PF

from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny_config


@pytest.fixture(autouse=True)
def ref_vjp():
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    paddle.set_flags(old)


def _seq_pair(seed=11):
    """Linear(6, 16) -> ReLU -> Linear(16, 3) in both packages, the same
    weights."""
    paddle.seed(seed)
    ref = pnn.Sequential(pnn.Linear(6, 16), pnn.ReLU(), pnn.Linear(16, 3))
    port = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 3))
    with torch.no_grad():
        for i in (0, 2):
            port[i].weight.copy_(torch.from_numpy(
                np.array(ref[i].weight._data).T))
            port[i].bias.copy_(torch.from_numpy(np.array(ref[i].bias._data)))
    return ref, port


def _np(t):
    """A result of either package as a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _data():
    rs = np.random.RandomState(3)
    return rs.randn(32, 6).astype("float32"), rs.randint(0, 3, (32,))


def test_matches_eager():
    rs = np.random.RandomState(0)
    xn, yn = rs.rand(8, 8).astype("float32"), rs.rand(8, 8).astype("float32")
    for lib in ("ref", "port"):
        if lib == "ref":
            x, y = paddle.to_tensor(xn), paddle.to_tensor(yn)

            def f(x, y):
                return paddle.matmul(x, y) + paddle.sin(x).sum()

            sf = paddle.jit.to_static(f)
        else:
            x, y = torch.from_numpy(xn), torch.from_numpy(yn)

            def f(x, y):
                return x @ y + torch.sin(x).sum()

            sf = jit.to_static(f)
        eager = _np(f(x, y))
        outs = [_np(sf(x, y)) for _ in range(4)]
        assert len(sf._cache) == 1, lib
        for o in outs:
            np.testing.assert_allclose(o, eager, rtol=1e-6)


def test_non_tensor_args_are_guards():
    for to_static, x in ((paddle.jit.to_static,
                          paddle.to_tensor(np.ones((2, 2), "float32"))),
                         (jit.to_static, torch.ones(2, 2))):
        @to_static
        def f(x, flip):
            return -x if flip else x

        for _ in range(3):
            a = f(x, True)
            b = f(x, False)
        np.testing.assert_allclose(a.numpy(), -np.ones((2, 2)))
        np.testing.assert_allclose(b.numpy(), np.ones((2, 2)))
        assert len(f._cache) == 2


def test_layer_decorated():
    ref, port = _seq_pair()
    xn = np.random.RandomState(5).rand(5, 6).astype("float32")
    eager = port(torch.from_numpy(xn)).detach().numpy()
    ref_eager = ref(paddle.to_tensor(xn)).numpy()
    np.testing.assert_allclose(eager, ref_eager, rtol=1e-5, atol=1e-6)
    for lib, layer, x in (("ref", paddle.jit.to_static(ref),
                           paddle.to_tensor(xn)),
                          ("port", jit.to_static(port),
                           torch.from_numpy(xn))):
        for _ in range(4):
            out = layer(x)
            np.testing.assert_allclose(_np(out), eager, rtol=1e-5,
                                       atol=1e-6)
        assert isinstance(layer.forward, (jit.CompiledFunction,
                                          paddle.jit.CompiledFunction))


def test_captures_recorded():
    ref, port = _seq_pair()
    for lin, to_static, x in ((ref[0], paddle.jit.to_static,
                               paddle.rand([2, 6])),
                              (port[0], jit.to_static, torch.rand(2, 6))):
        sf = to_static(lin.forward)
        for _ in range(3):
            sf(x)
        spec = next(iter(sf._cache.values()))
        assert len(spec.ro_caps) + len(spec.mut_caps) >= 2
    # the port records the weight and bias themselves, read-only
    ids = {id(t) for t in spec.ro_caps}
    assert {id(port[0].weight), id(port[0].bias)} <= ids
    assert not spec.mut_caps


def _adam_scaler_losses(lib, static):
    ref, port = _seq_pair()
    xn, yn = _data()
    if lib == "ref":
        model, x, y = ref, paddle.to_tensor(xn), paddle.to_tensor(yn)
        opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                    parameters=model.parameters())
        scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 10)
        ce, to_static = PF.cross_entropy, paddle.jit.to_static
    else:
        model, x, y = port, torch.from_numpy(xn), torch.from_numpy(yn)
        opt = Adam(learning_rate=1e-2, parameters=model.parameters())
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10, device="cpu")
        ce, to_static = F.cross_entropy, jit.to_static

    def body(x, y):
        loss = ce(model(x), y)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    step = to_static(body) if static else body
    losses = [float(_np(step(x, y))) for _ in range(8)]
    return losses, step


def test_adam_gradscaler_write_back():
    got = {}
    for lib in ("ref", "port"):
        eager, _ = _adam_scaler_losses(lib, False)
        static, step = _adam_scaler_losses(lib, True)
        assert len(step._cache) == 1, lib
        np.testing.assert_allclose(static, eager, rtol=2e-4, atol=1e-5)
        assert static[-1] < static[0]
        got[lib] = static
    np.testing.assert_allclose(got["port"], got["ref"], rtol=2e-4, atol=1e-5)


def test_mutated_params_written_back():
    ref, port = _seq_pair()
    xn, yn = _data()
    for lib in ("ref", "port"):
        if lib == "ref":
            model, x, y = ref, paddle.to_tensor(xn), paddle.to_tensor(yn)
            opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                        parameters=model.parameters())
            ce, to_static = PF.cross_entropy, paddle.jit.to_static
            w_before = np.array(model[0].weight._data)
        else:
            model, x, y = port, torch.from_numpy(xn), torch.from_numpy(yn)
            opt = Adam(learning_rate=1e-2, parameters=model.parameters())
            ce, to_static = F.cross_entropy, jit.to_static
            w_before = model[0].weight.detach().numpy().T.copy()

        @to_static
        def step(x, y):
            loss = ce(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        for _ in range(5):
            step(x, y)
        spec = next(iter(step._cache.values()))
        assert len(spec.mut_caps) > 0, lib
        w = np.asarray(model[0].weight._data) if lib == "ref" \
            else model[0].weight.detach().numpy().T
        assert not np.allclose(w, w_before), lib
    np.testing.assert_allclose(port[0].weight.detach().numpy().T,
                               np.asarray(ref[0].weight._data), rtol=1e-4,
                               atol=1e-6)


def test_new_shape_and_dtype_are_keys():
    for to_static, mk in ((paddle.jit.to_static,
                           lambda a: paddle.to_tensor(a)),
                          (jit.to_static, torch.from_numpy)):
        @to_static
        def f(x):
            return (x * 2).sum()

        for _ in range(3):
            f(mk(np.ones((4, 4), "float32")))
        assert len(f._cache) == 1
        for _ in range(3):
            f(mk(np.ones((16, 4), "float32")))
        assert len(f._cache) == 2
        out = f(mk(np.ones((4, 4), "float32")))
        np.testing.assert_allclose(np.asarray(out.numpy()), 32.0)

        @to_static
        def g(x):
            return x + x

        for _ in range(3):
            g(mk(np.ones((2,), "float32")))
        for _ in range(3):
            g(mk(np.ones((2,), "int64")))
        assert len(g._cache) == 2


def _breaker(lib):
    if lib == "ref":
        def f(x):
            if float(x.sum().numpy()) > 0:
                return x * 2
            return x * 3
    else:
        def f(x):
            if float(x.sum()) > 0:
                return x * 2
            return x * 3
    return f


def _mk(lib, a):
    return paddle.to_tensor(a) if lib == "ref" else torch.from_numpy(a)


@pytest.mark.parametrize("lib", ["ref", "port"])
def test_graph_break_goes_segmented(lib):
    to_static = paddle.jit.to_static if lib == "ref" else jit.to_static
    f = to_static(_breaker(lib), full_graph=False)
    x = _mk(lib, np.ones((3,), "float32"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        outs = [f(x) for _ in range(4)]
    assert f._segmented
    assert any("graph break" in str(m.message) for m in w)
    for o in outs:
        np.testing.assert_allclose(np.asarray(o.numpy()), 2 * np.ones(3))
    if lib == "port":
        rep = f.graph_break_report()
        assert rep["segmented"] and not rep["compiled"]
        assert rep["graphs"] == 0 and rep["break_sites"]
        assert "test_torch_jit.py" in rep["break_reason"]


@pytest.mark.parametrize("lib", ["ref", "port"])
def test_full_graph_true_raises(lib):
    to_static = paddle.jit.to_static if lib == "ref" else jit.to_static
    f = to_static(_breaker(lib), full_graph=True)
    x = _mk(lib, np.ones((3,), "float32"))
    f(x)
    f(x)
    with pytest.raises(RuntimeError, match="full_graph=True"):
        f(x)


@pytest.mark.parametrize("lib", ["ref", "port"])
def test_fallback_still_correct_after_break(lib):
    to_static = paddle.jit.to_static if lib == "ref" else jit.to_static
    f = to_static(_breaker(lib))
    pos = _mk(lib, np.ones((3,), "float32"))
    neg = _mk(lib, -np.ones((3,), "float32"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            f(pos)
    np.testing.assert_allclose(np.asarray(f(neg).numpy()), -3 * np.ones(3))


# ------------------------------------------------------- the port's own

def test_bucket_axis_gives_log_keys():
    f = jit.to_static(lambda x: x.sum(), bucket_axes={0: 0})
    for n in (3, 5, 9, 17, 30, 100, 200, 300):
        for _ in range(3):
            assert f(torch.ones(n)).item() == n
    assert len(f._cache) == len({jit.default_buckets(n) for n in
                                 (3, 5, 9, 17, 30, 100, 200, 300)}) == 7
    spec = jit.BucketAxis(1, pad_value=-1, buckets=[8, 16])
    assert (spec.round_up(3), spec.round_up(9), spec.round_up(20)) \
        == (8, 16, 20)
    g = jit.to_static(lambda x: (x >= 0).sum(), bucket_axes={0: spec})
    assert g(torch.zeros(2, 5)).item() == 10


def test_share_discovery_skips_both_eager_calls():
    """A new key with share_discovery goes straight to the compiled call:
    the marker is set on its first call (no eager warm-up)."""
    seen = []

    def f(x):
        seen.append(jit.compiled_call_active())
        return x * 2

    sf = jit.to_static(f, share_discovery=True)
    for _ in range(2):
        sf(torch.ones(1, 4))
    assert seen == [False, True]          # warm-up, discovery
    sf(torch.ones(8, 4))
    assert seen[-1] is True and len(sf._cache) == 1
    assert torch.equal(sf(torch.ones(8, 4)), 2 * torch.ones(8, 4))


def test_output_valid_after_next_call():
    sf = jit.to_static(lambda x: x + 1)
    for _ in range(3):
        sf(torch.zeros(3))
    a = sf(torch.zeros(3))
    b = sf(torch.ones(3))
    assert torch.equal(a, torch.ones(3)) and torch.equal(b, 2 * torch.ones(3))
    assert not a.requires_grad


def test_rebound_parameter_recaptures():
    lin = torch.nn.Linear(4, 4)
    sf = jit.to_static(lin.forward)
    x = torch.ones(1, 4)
    for _ in range(3):
        sf(x)
    spec = next(iter(sf._cache.values()))
    assert spec.guard_ok()
    with torch.no_grad():
        lin.weight.data = torch.zeros(4, 4)     # a new storage
    assert not spec.guard_ok()
    out = sf(x)
    assert torch.equal(out, lin.bias.detach()[None])
    assert next(iter(sf._cache.values())) is not spec


def test_tiny_llama_o2_step_equals_eager():
    """The bench's step (auto_cast(O2) inside, backward, step, clear_grad)
    under to_static(share_discovery=True), primed at 1 x 16, then 4 steps
    at 2 x 33: the losses equal the eager steps' bit for bit, one key
    compiled, the optimizer's device step count advanced."""
    ids_small = torch.randint(0, 256, (1, 16),
                              generator=torch.Generator().manual_seed(1))
    ids = torch.randint(0, 256, (2, 33),
                        generator=torch.Generator().manual_seed(2))
    runs = []
    for static in (False, True):
        torch.manual_seed(0)
        model = LlamaForCausalLM(llama_tiny_config(), device="cpu")
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                                  master_weight=False)

        def step(x):
            with amp.auto_cast(enable=True, dtype="bfloat16", level="O2"):
                loss = model(x, labels=x)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        fn = jit.to_static(step, share_discovery=True) if static else step
        fn(ids_small)
        fn(ids_small)
        runs.append([fn(ids).item() for _ in range(4)])
        assert int(opt._step_t.item()) == 6
        assert opt.state_dict()["step"] == 6
        if static:
            assert len(fn._cache) == 1
    assert runs[0] == runs[1]
    assert runs[1][-1] < runs[1][0]


def test_enable_to_static_false_runs_eagerly():
    seen = []

    def f(x):
        seen.append(jit.compiled_call_active())
        return x

    sf = jit.to_static(f)
    jit.enable_to_static(False)
    try:
        for _ in range(4):
            sf(torch.ones(2))
    finally:
        jit.enable_to_static(True)
    assert seen == [False] * 4 and not sf._cache
    assert flag("FLAGS_enable_to_static") is True


def test_unported_surface_names_its_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jit.to_static(lambda x: x, in_shardings={0: None})
    sf = jit.to_static(lambda x: x)
    for meth in (sf.program_text, sf.program_jaxpr, sf.program_index):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            meth()
    for call in (lambda: jit.save(None, "p"), lambda: jit.load("p"),
                 jit.TranslatedLayer,
                 lambda: jit.dy2static.convert_to_static(lambda: 0)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    jit.set_code_level(50)
    jit.set_verbosity(1, also_to_stdout=True)
    assert flag("FLAGS_jit_code_level") == 50
    jit.set_code_level(100)
    jit.set_verbosity(0)
    assert jit.not_to_static(len) is len and jit.ignore_module([]) is None
    assert sf.function is not None and sf.concrete_program() is None
