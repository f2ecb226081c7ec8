"""The port's hapi, metric and the Model API's loop held to paddle_tpu's
on the CPU.

The same tiny networks in both packages, weights carried across by
`state_dict`: `Model.fit` of an MLP with `Accuracy` (shuffled and
unshuffled, 0 and 2 workers on the port) and of a tiny LLaMA (`Model(net,
inputs=[ids, labels])`, the loss the network's own) give per-step losses
within 1e-5 of the reference's; `evaluate` and `predict` agree; the
metrics (`Accuracy` top-k, `Precision`, `Recall`, `Auc`, `accuracy`)
accumulate alike; `summary` and `flops` count alike; save / load round
trips; `mesh=` waits for the distributed entry.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi.callbacks import Callback as RCallback
from paddle_tpu.text.models import LlamaForCausalLM as PLlama
from paddle_tpu.text.models.llama import llama_tiny_config as p_tiny

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.hapi.callbacks import Callback
from paddle_tpu_torch.text.models import llama_from_numpy, llama_tiny_config


@pytest.fixture(autouse=True)
def _cpu_plain():
    pt.set_device("cpu")
    old = paddle.get_flags(["FLAGS_pallas_fused_ops",
                            "FLAGS_eager_defer_vjp"])
    port_old = flag("FLAGS_pallas_fused_ops")
    paddle.set_flags({"FLAGS_pallas_fused_ops": False,
                      "FLAGS_eager_defer_vjp": False})
    set_flags({"FLAGS_pallas_fused_ops": False})
    yield
    paddle.set_flags(old)
    set_flags({"FLAGS_pallas_fused_ops": port_old})


def _data(pkg, n=24):
    class Cls(pkg.io.Dataset):
        def __init__(self):
            rs = np.random.RandomState(1)
            self.x = rs.randn(n, 8).astype("float32")
            self.y = (self.x[:, :3].argmax(1)).astype("int64")[:, None]

        def __len__(self):
            return n

        def __getitem__(self, i):
            return self.x[i], self.y[i]

    return Cls()


def _recorder(base):
    class Rec(base):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"][0]))

    return Rec()


def _mlp_pair():
    paddle.seed(0)
    rnet = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                                paddle.nn.Linear(16, 3))
    pnet = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                            pt.nn.Linear(16, 3))
    pnet.set_state_dict({k: np.asarray(v._data)
                         for k, v in rnet.state_dict().items()})
    out = []
    for pkg, net in ((paddle, rnet), (pt, pnet)):
        m = pkg.Model(net)
        m.prepare(pkg.optimizer.AdamW(learning_rate=1e-2,
                                      parameters=net.parameters()),
                  pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        out.append(m)
    return out


@pytest.mark.parametrize("shuffle,workers", [(False, 0), (True, 0),
                                             (True, 2)])
def test_mlp_fit_evaluate_predict_equal_the_reference(shuffle, workers):
    rm, pm = _mlp_pair()
    rrec, prec = _recorder(RCallback), _recorder(Callback)
    np.random.seed(3)
    rm.fit(_data(paddle), batch_size=4, epochs=2, verbose=0,
           shuffle=shuffle, callbacks=[rrec])
    np.random.seed(3)
    pm.fit(_data(pt), batch_size=4, epochs=2, verbose=0, shuffle=shuffle,
           num_workers=workers, callbacks=[prec])
    assert len(prec.losses) == len(rrec.losses) == 12
    np.testing.assert_allclose(prec.losses, rrec.losses, rtol=1e-5)
    rev = rm.evaluate(_data(paddle), batch_size=8, verbose=0)
    pev = pm.evaluate(_data(pt), batch_size=8, verbose=0)
    assert pev.keys() == rev.keys()
    np.testing.assert_allclose(pev["acc"], rev["acc"])
    np.testing.assert_allclose(pev["eval_loss"], rev["eval_loss"],
                               rtol=1e-5)
    rp = rm.predict(_data(paddle), batch_size=8, verbose=0,
                    stack_outputs=True)
    pp = pm.predict(_data(pt), batch_size=8, verbose=0, stack_outputs=True)
    np.testing.assert_allclose(pp[0], rp[0], rtol=1e-5, atol=1e-6)


def test_llama_fit_losses_equal_the_reference():
    paddle.seed(0)
    ref = PLlama(p_tiny(num_key_value_heads=2))
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    port = llama_from_numpy(llama_tiny_config(num_key_value_heads=2), state,
                            device="cpu")
    ids = np.random.RandomState(0).randint(0, 256, (8, 17))

    def tokens(pkg):
        class Tok(pkg.io.Dataset):
            def __len__(self):
                return len(ids)

            def __getitem__(self, i):
                return ids[i], ids[i]

        return Tok()

    losses = []
    for pkg, net, base in ((paddle, ref, RCallback), (pt, port, Callback)):
        m = pkg.Model(net, inputs=["input_ids", "labels"])
        m.prepare(pkg.optimizer.AdamW(learning_rate=1e-3,
                                      parameters=net.parameters()))
        rec = _recorder(base)
        m.fit(tokens(pkg), batch_size=2, epochs=1, shuffle=False,
              verbose=0, callbacks=[rec])
        losses.append(rec.losses)
    assert len(losses[1]) == 4
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_amp_configs_fit_runs_under_auto_cast():
    from paddle_tpu_torch import amp

    seen = []

    class Probe(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(8, 3)

        def forward(self, x):
            seen.append(amp.amp_state() is not None)
            return self.fc(x)

    net = Probe()
    m = pt.Model(net)
    m.prepare(pt.optimizer.AdamW(parameters=net.parameters()),
              pt.nn.CrossEntropyLoss(), amp_configs={"level": "O1"})
    m.fit(_data(pt, 8), batch_size=4, verbose=0)
    assert seen == [True, True]
    with pytest.raises(ValueError):
        m.prepare(amp_configs="O3")


# --------------------------------------------------------------- metrics
def _metric_run(pkg):
    rs = np.random.RandomState(9)
    pred = rs.rand(12, 5).astype("float32")
    lab = rs.randint(0, 5, (12, 1)).astype("int64")
    prob = rs.rand(12).astype("float32")
    blab = rs.randint(0, 2, (12,)).astype("int64")
    t = pkg.to_tensor
    acc = pkg.metric.Accuracy(topk=(1, 3))
    c = acc.compute(t(pred), t(lab))
    step = acc.update(c)
    prec, rec, auc = (pkg.metric.Precision(), pkg.metric.Recall(),
                      pkg.metric.Auc(num_thresholds=63))
    for m in (prec, rec, auc):
        m.update(t(prob), t(blab))
    a1 = pkg.metric.accuracy(t(pred), t(lab), k=2)
    return (step, acc.accumulate(), acc.name(), prec.accumulate(),
            rec.accumulate(), auc.accumulate(), float(a1.numpy()),
            prec.name(), auc.name())


def test_metrics_equal_the_reference():
    got, want = _metric_run(pt), _metric_run(paddle)
    np.testing.assert_allclose(np.asarray(got[:2], dtype=float),
                               np.asarray(want[:2], dtype=float))
    assert got[2] == want[2] == ["acc_top1", "acc_top3"]
    np.testing.assert_allclose(got[3:7], want[3:7], rtol=1e-6)
    assert got[7:] == want[7:]
    with pytest.raises(ValueError):
        pt.metric.Auc(curve="PR")


# ------------------------------------------------------ summary and flops
def _nets():
    paddle.seed(0)
    r = paddle.nn.Sequential(paddle.nn.Linear(8, 32), paddle.nn.ReLU(),
                             paddle.nn.Linear(32, 4))
    p = pt.nn.Sequential(pt.nn.Linear(8, 32), pt.nn.ReLU(),
                         pt.nn.Linear(32, 4))
    return r, p


def test_summary_and_flops_equal_the_reference(capsys):
    r, p = _nets()
    assert pt.summary(p, (2, 8)) == paddle.summary(r, (2, 8))
    out = capsys.readouterr().out.split("Layer (type)")
    assert out[1] == out[2]
    assert pt.flops(p, [2, 8]) == paddle.flops(r, [2, 8]) == \
        2 * 2 * 8 * 32 + 2 * 2 * 32 * 4
    assert pt.Model(p).summary() == paddle.Model(r).summary()


def test_save_load_round_trip(tmp_path):
    _, pm = _mlp_pair()
    pm.fit(_data(pt, 8), batch_size=4, verbose=0)
    path = str(tmp_path / "m" / "ck")
    pm.save(path)
    _, pm2 = _mlp_pair()
    pm2.load(path)
    for (k, a), (_, b) in zip(pm.network.state_dict().items(),
                              pm2.network.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert pm2._optimizer.state_dict()["step"] == 2


def test_mesh_waits_for_the_distributed_entry():
    _, pm = _mlp_pair()
    with pytest.raises(NotImplementedError, match="Distributed"):
        pm.prepare(mesh=object())
    with pytest.raises(NotImplementedError, match="Distributed"):
        pm.fit(_data(pt, 8), mesh=object())


def test_batches_follow_the_model_device():
    """Inputs land on the network's device (a Tensor there); nothing is
    moved elsewhere."""
    _, pm = _mlp_pair()
    got = []

    class Spy(pt.nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            got.append(x._data.device)
            return self.inner(x)

    pm.network = Spy(pm.network)
    pm.predict(_data(pt, 4), batch_size=4, verbose=0)
    assert got == [torch.device("cpu")]
