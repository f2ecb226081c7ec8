"""The port's `quantization` package held to paddle_tpu's on the CPU.

The reference's contracts (tests/test_new_packages.py TestQuantization,
TestQuantizedExecution and TestWeightOnlyLinear, test_param_audit_fixes
`test_quantize_not_inplace`, test_quantized.py TestPTQRoundTrip) run on
the port, and where both packages compute the same thing on the same
seeded inputs the port's result is the reference's: PTQ's converted
model within 1e-5 of the largest |value| in f32 (its int8 codes equal),
the full-int8 QuantizedLinear's int32 product exact, fake quantization and
its straight-through gradient equal, and a `ptq_state_dict` saved by
either package restores in the other with identical codes and serves the
same greedy tokens.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.quantization as RQ
from paddle_tpu.inference.engine import generate_paged as ref_generate_paged
from paddle_tpu.text.models import LlamaConfig as RConfig
from paddle_tpu.text.models import LlamaForCausalLM as RLlama

import paddle_tpu_torch as pt
import paddle_tpu_torch.quantization as PQ
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.inference.engine import generate_paged
from paddle_tpu_torch.quantization.ptq import QuantizedLinear
from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.text.models import llama_from_numpy

TOL = 1e-5
_LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=64)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port_device._current
    pt.set_device("cpu")
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    paddle.set_flags(old)
    port_device._current = prev


def _close(got, want, tol=TOL):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _mlp_pair():
    """nn.Sequential(Linear(8, 16), ReLU, Linear(16, 4)) in both packages
    with the reference's seeded weights."""
    paddle.seed(0)
    ref = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                               paddle.nn.Linear(16, 4))
    port = pnn.Sequential(pnn.Linear(8, 16), pnn.ReLU(), pnn.Linear(16, 4))
    port.set_state_dict({k: np.asarray(v._data)
                         for k, v in ref.state_dict().items()})
    return ref, port


def _x(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype("float32")


def test_package_surface():
    assert PQ.__all__ == RQ.__all__
    for name in PQ.__all__:
        assert getattr(PQ, name) is not None, name
    assert pt.quantization is PQ


@pytest.mark.parametrize("observer", ["AbsmaxObserver", "MinMaxObserver"])
def test_ptq_flow_accuracy_and_reference(observer):
    x = _x(16, 8)
    outs = []
    for pkg, Q, (m) in ((paddle, RQ, _mlp_pair()[0]),
                        (pt, PQ, _mlp_pair()[1])):
        xt = pkg.to_tensor(x)
        ref_out = m(xt).numpy()
        obs = getattr(Q, observer)
        cfg = Q.QuantConfig(activation=obs, weight=obs)
        ptq = Q.PTQ(cfg)
        q = ptq.quantize(m)
        for _ in range(3):                 # calibration
            q(xt)
        q = ptq.convert(q)
        qlayers = [lay for _n, lay in q.named_sublayers()
                   if type(lay).__name__ == "QuantizedLinear"]
        assert len(qlayers) == 2
        assert str(qlayers[0].w_int8.dtype).endswith("int8")
        out = q(xt).numpy()
        # int8 error stays small on calibrated ranges
        assert np.abs(out - ref_out).max() < np.abs(ref_out).max() * 0.1
        outs.append((out, [np.asarray(getattr(lay.w_int8, "_data",
                                              lay.w_int8))
                           for lay in qlayers]))
    (po, pw), (ro, rw) = outs
    _close(po, ro)
    for a, b in zip(pw, rw):
        np.testing.assert_array_equal(a, b)


def test_qat_trains_through_fake_quant():
    _, model = _mlp_pair()
    cfg = PQ.QuantConfig(activation=PQ.FakeQuanterWithAbsMax,
                         weight=PQ.FakeQuanterWithAbsMax)
    model = PQ.QAT(cfg).quantize(model)
    opt = pt.optimizer.Adam(learning_rate=5e-3,
                            parameters=model.parameters())
    rs = np.random.RandomState(0)
    X = pt.to_tensor(rs.randn(32, 8).astype("float32"))
    Y = pt.to_tensor(rs.randint(0, 4, (32,)).astype("int64"))
    losses = []
    for _ in range(15):
        loss = pt.nn.functional.cross_entropy(model(X), Y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    assert losses[-1] < losses[0] * 0.8, losses
    conv = PQ.QAT(cfg).convert(model)
    assert sum(isinstance(lay, QuantizedLinear)
               for _n, lay in conv.named_sublayers()) == 2
    assert np.isfinite(conv(X).numpy()).all()


def test_fake_quant_ste_gradient_matches_reference():
    x = np.array([0.5, -0.25, 10.0, 1.275, -1.285], "float32")
    grads = []
    for pkg, Q in ((pt, PQ), (paddle, RQ)):
        t = pkg.to_tensor(x)
        t.stop_gradient = False
        y = Q.fake_quant(t, scale=0.01)    # 10.0 is out of range: clipped
        y.sum().backward()
        grads.append((np.asarray(y.numpy()), np.asarray(t.grad.numpy())))
    (py, pg), (ry, rg) = grads
    np.testing.assert_array_equal(py, ry)
    np.testing.assert_array_equal(pg, rg)
    np.testing.assert_array_equal(pg, [1.0, 1.0, 0.0, 1.0, 0.0])


def test_quantize_not_inplace_and_warnings():
    m = pnn.Sequential(pnn.Linear(4, 4), pnn.ReLU())
    cfg = PQ.QuantConfig(activation=None, weight=None)
    cfg.add_type_config(pnn.Linear, activation=PQ.AbsmaxObserver(),
                        weight=PQ.AbsmaxObserver())
    q = PQ.PTQ(cfg).quantize(m, inplace=False)
    assert type(m[0]).__name__ == "Linear"   # the original untouched
    assert type(q[0]).__name__ != "Linear"
    cfg.add_type_config(pnn.ReLU, weight=PQ.AbsmaxObserver)
    with pytest.warns(UserWarning, match="only Linear"):
        PQ.PTQ(cfg).quantize(m)
    by_name = PQ.QuantConfig()
    by_name.add_name_config("0", weight=PQ.MinMaxObserver)
    assert by_name.config_for("0", m[0]).weight is PQ.MinMaxObserver
    assert by_name.config_for("1", m[1]) is None
    by_layer = PQ.QuantConfig(weight=PQ.AbsmaxObserver)
    by_layer.add_layer_config(m[0], activation=PQ.MinMaxObserver)
    assert by_layer.config_for("0", m[0]).activation is PQ.MinMaxObserver


def _linear_pair(seed):
    paddle.seed(seed)
    ref = paddle.nn.Linear(16, 8)
    port = pnn.Linear(16, 8)
    port.set_state_dict({k: np.asarray(v._data)
                         for k, v in ref.state_dict().items()})
    return ref, port


@pytest.mark.parametrize("case", ["weight_only", "full_int8",
                                  "per_channel", "per_channel_int8"])
def test_quantized_linear_paths(case):
    ref, port = _linear_pair(1)
    w = np.asarray(ref.weight._data)
    x = np.random.RandomState(1).randn(4, 16).astype("float32")
    per_channel = case.startswith("per_channel")
    ws = np.abs(w).max(axis=0) / 127.0 if per_channel \
        else float(np.abs(w).max() / 127.0)
    a_s = float(np.abs(x).max() / 127.0) \
        if case in ("full_int8", "per_channel_int8") else None
    from paddle_tpu.quantization.ptq import QuantizedLinear as RQL

    rq = RQL(ref, ws, a_s)
    pq = QuantizedLinear(port, ws, a_s)
    np.testing.assert_array_equal(pq.w_int8.numpy(), np.asarray(rq.w_int8))
    assert pq.per_channel == rq.per_channel == per_channel
    got = pq(pt.to_tensor(x)).numpy()
    want = np.asarray(rq(paddle.to_tensor(x))._data)
    _close(got, want)
    full = ref(paddle.to_tensor(x)).numpy()
    assert np.abs(got - full).max() < 0.1 * np.abs(full).max() + 0.05
    if a_s is not None:
        # the int32 accumulation of the full-int8 path is exact
        x8 = np.clip(np.round(x / a_s), -128, 127).astype(np.int64)
        acc = x8 @ pq.w_int8.numpy().astype(np.int64)
        _close(got, acc.astype("float32") * (a_s * np.asarray(
            ws, "float32")) + np.asarray(ref.bias._data))


def test_quantized_linear_bias_gradient():
    """x and the bias take gradients (the reference's n_diff), the codes
    none."""
    _, port = _linear_pair(2)
    pq = QuantizedLinear(port, np.abs(port.weight.numpy()).max(0) / 127.0)
    x = pt.to_tensor(_x(3, 16), stop_gradient=False)
    pq(x).sum().backward()
    assert x.grad is not None and port.bias.grad is not None
    np.testing.assert_allclose(port.bias.grad.numpy(), np.full(8, 3.0))


def _llama_pair(seed=0):
    paddle.seed(seed)
    ref = RLlama(RConfig(**_LLAMA))
    ref.eval()
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    return ref, llama_from_numpy(LlamaConfig(**_LLAMA), state, device="cpu")


@pytest.mark.parametrize("algo,mode", [("weight_only_int8", "int8"),
                                       ("weight_only_int4", "int4")])
def test_export_restore_serve_identical(algo, mode, tmp_path):
    _, m = _llama_pair()
    prompt = np.random.RandomState(12).randint(0, 128, (1, 5))
    want = generate_paged(m, prompt, 4, weight_quant=mode, device="cpu")
    state = PQ.ptq_state_dict(m, algo=algo)
    path = str(tmp_path / "ptq.pdparams")
    pt.save(state, path)
    torch.manual_seed(123)          # a different init to restore over
    fresh = LlamaForCausalLM(LlamaConfig(**_LLAMA), device="cpu")
    PQ.load_ptq_state_dict(fresh, pt.load(path))
    got = generate_paged(fresh, prompt, 4, weight_quant=mode, device="cpu")
    # restored weights are the lattice: requantizing at serve time
    # re-derives the same integers, so decoding is token-identical
    np.testing.assert_array_equal(got, want)


def test_calibration_records_act_scales():
    ref, m = _llama_pair()
    rs = np.random.RandomState(13)
    batches = [rs.randint(0, 128, (1, 8)).astype("int64") for _ in range(2)]
    state = PQ.ptq_state_dict(m, sample_inputs=[pt.to_tensor(b)
                                                for b in batches])
    acts = sorted(k for k in state if k.endswith(".act_scale"))
    scales = [k for k in state if k.endswith(".weight_scale")]
    assert acts and len(acts) == len(scales)
    rstate = RQ.ptq_state_dict(ref, sample_inputs=[paddle.to_tensor(b)
                                                   for b in batches])
    assert acts == sorted(k for k in rstate if k.endswith(".act_scale"))
    for k in acts:
        assert float(state[k].numpy()) > 0
        _close(state[k].numpy(), np.asarray(rstate[k]._data))


def test_unknown_algo_rejected():
    with pytest.raises(ValueError):
        PQ.ptq_state_dict(_llama_pair()[1], algo="weight_only_int2")


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("algo,mode", [("weight_only_int8", "int8"),
                                       ("weight_only_int4", "int4")])
def test_ptq_state_dict_restores_across_packages(writer, algo, mode,
                                                 tmp_path):
    ref, port = _llama_pair()
    rstate = RQ.ptq_state_dict(ref, algo=algo)
    pstate = PQ.ptq_state_dict(port, algo=algo)
    assert sorted(rstate) == sorted(pstate)
    for k in rstate:               # identical codes and scales
        np.testing.assert_array_equal(pstate[k].numpy(),
                                      np.asarray(rstate[k]._data))
    path = str(tmp_path / "ptq.pdparams")
    if writer == "reference":
        paddle.save(rstate, path)
        loaded = pt.load(path)
    else:
        pt.save(pstate, path)
        loaded = paddle.load(path)
    _, pfresh = _llama_pair(5)
    paddle.seed(5)
    rfresh = RLlama(RConfig(**_LLAMA))
    rfresh.eval()
    if writer == "reference":
        PQ.load_ptq_state_dict(pfresh, loaded)
        RQ.load_ptq_state_dict(rfresh, rstate)
    else:
        RQ.load_ptq_state_dict(rfresh, loaded)
        PQ.load_ptq_state_dict(pfresh, pstate)
    rsd, psd = rfresh.state_dict(), pfresh.state_dict()
    for k in psd:
        np.testing.assert_array_equal(psd[k].numpy(),
                                      np.asarray(rsd[k]._data))
    prompt = np.random.RandomState(7).randint(0, 128, (1, 6))
    np.testing.assert_array_equal(
        generate_paged(pfresh, prompt, 4, weight_quant=mode, device="cpu"),
        ref_generate_paged(rfresh, prompt, 4, weight_quant=mode,
                           prefix_cache=False))


def test_weight_only_linear_surface_contracts():
    """tests/test_new_packages.py TestWeightOnlyLinear on the port: the
    int8 round trip within 1/100 of the largest |w|, weight_only_linear
    within 2% of x @ w, llm_int8_linear with an outlier column within 3%,
    and a finite gradient through weight_only_linear."""
    import paddle_tpu_torch.incubate.nn.functional as IF

    rs = np.random.RandomState(0)
    w = rs.randn(16, 8).astype("float32")
    x = rs.randn(4, 16).astype("float32")
    qw, sc = IF.weight_quantize(pt.to_tensor(w))
    assert str(qw.dtype).endswith("int8")
    wd = IF.weight_dequantize(qw, sc, out_dtype="float32")
    assert np.abs(wd.numpy() - w).max() < np.abs(w).max() / 100
    ref = x @ w
    out = IF.weight_only_linear(pt.to_tensor(x), qw, weight_scale=sc)
    assert np.abs(out.numpy() - ref).max() < 0.02 * np.abs(ref).max()
    x2 = x.copy()
    x2[:, 3] *= 20.0                   # the outlier column runs in float
    out = IF.llm_int8_linear(pt.to_tensor(x2), qw, weight_scale=sc,
                             threshold=6.0)
    ref2 = x2 @ w
    assert np.abs(out.numpy() - ref2).max() < 0.03 * np.abs(ref2).max()
    xt = pt.to_tensor(x, stop_gradient=False)
    IF.weight_only_linear(xt, qw, weight_scale=sc).sum().backward()
    assert np.isfinite(xt.grad.numpy()).all()
