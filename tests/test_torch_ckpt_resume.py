"""Kill-and-resume on the port, and train states across the packages.

The resume cases of tests/test_ckpt.py on the port (the toy model with
dropout, a stepped LR schedule and a shuffled loader: a run killed at
step k and resumed into fresh objects from another seed reproduces the
uninterrupted losses bitwise; hapi's CheckpointCallback with a real
SIGTERM mid-epoch, periodic async saves, retention), then the same on a
tiny LLaMA through `Model.fit`, and a train state written by either
package continued by the other: params, AdamW moments, step and numpy
state restore across, and the next two losses lie within 1e-5 of the
writer's own continuation (the framework RNG stream is each package's
own, ROADMAP Queue 3).
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ckpt as ref_ckpt
from paddle_tpu.text.models import LlamaForCausalLM as PLlama
from paddle_tpu.text.models.llama import llama_tiny_config as p_tiny

import paddle_tpu_torch as pt
from paddle_tpu_torch import ckpt
from paddle_tpu_torch import nn
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.hapi.callbacks import (Callback, CheckpointCallback,
                                             ModelCheckpoint)
from paddle_tpu_torch.io import DataLoader, Dataset
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import (LlamaForCausalLM, llama_from_numpy,
                                          llama_tiny_config)


@pytest.fixture(autouse=True)
def _cpu_plain():
    """CPU tensors, the plain compositions on both sides (the reference's
    eager VJPs taken directly: its deferred-VJP pass reads a jax API this
    jax lacks)."""
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


class _ToyData(Dataset):
    def __init__(self, n=16):
        rs = np.random.RandomState(42)
        self.x = rs.randn(n, 8).astype("float32")
        self.y = rs.randn(n, 4).astype("float32")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _build(seed):
    pt.seed(seed)
    np.random.seed(seed)
    model = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Dropout(0.3),
                          nn.Linear(16, 4))
    sched = pt.optimizer.lr.StepDecay(0.01, step_size=3, gamma=0.5)
    opt = pt.optimizer.AdamW(learning_rate=sched,
                             parameters=model.parameters())
    loader = ckpt.ResumableLoader(
        DataLoader(_ToyData(), batch_size=2, shuffle=True))
    return model, opt, sched, loader, nn.MSELoss()


def _train(model, opt, sched, loader, loss_fn, n_steps, start_step=0):
    model.train()
    losses = []

    def stream():
        while True:
            yield from loader

    it = stream()
    for _ in range(start_step, n_steps):
        x, y = next(it)
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.numpy()))
    return losses


@pytest.mark.parametrize("kill_at", [3, 8, 9])
def test_bitwise_loss_parity(tmp_path, kill_at):
    """Killed at step k (8 is an epoch boundary, 9 one past it), restored
    into fresh objects from another seed: the losses are the
    uninterrupted run's bitwise — dropout draws, shuffle order and LR
    schedule included."""
    total = 12
    full = _train(*_build(0), total)
    model, opt, sched, loader, loss_fn = _build(0)
    prefix = _train(model, opt, sched, loader, loss_fn, kill_at)
    assert prefix == full[:kill_at]
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, kill_at, ckpt.capture_train_state(
        model, opt, step=kill_at, data_state=loader.state_dict()))
    del model, opt, sched, loader
    model2, opt2, sched2, loader2, loss_fn2 = _build(123)
    meta = ckpt.restore_train_state(ckpt.restore_checkpoint(root).tree,
                                    model2, opt2)
    assert meta["step"] == kill_at and meta["rng"] == ["torch", "numpy"]
    loader2.set_state_dict(meta["data"])
    suffix = _train(model2, opt2, sched2, loader2, loss_fn2, total,
                    start_step=kill_at)
    assert prefix + suffix == full


def test_resume_restores_lr_schedule(tmp_path):
    root = str(tmp_path)
    model, opt, sched, loader, loss_fn = _build(0)
    _train(model, opt, sched, loader, loss_fn, 7)
    lr_at_7 = sched.last_lr
    ckpt.save_checkpoint(root, 7, ckpt.capture_train_state(
        model, opt, step=7, data_state=loader.state_dict()))
    model2, opt2, sched2, _, _ = _build(1)
    assert sched2.last_lr != lr_at_7
    ckpt.restore_train_state(ckpt.restore_checkpoint(root).tree, model2,
                             opt2)
    assert sched2.last_lr == lr_at_7
    assert opt2._step_count == opt._step_count


# --------------------------------------------------- hapi loop integration
class _LossRecorder(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        loss = (logs or {}).get("loss")
        self.losses.append(float(loss[0] if isinstance(loss, (list, tuple))
                                 else loss))


class _SigtermAt(Callback):
    """A real SIGTERM at the start of the n-th global batch: the batch
    completes, then CheckpointCallback saves synchronously and stops."""

    def __init__(self, n):
        self.n = n
        self.count = 0

    def on_train_batch_begin(self, step, logs=None):
        self.count += 1
        if self.count == self.n:
            os.kill(os.getpid(), signal.SIGTERM)


def _hapi_model(seed):
    pt.seed(seed)
    np.random.seed(seed)
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Dropout(0.3),
                        nn.Linear(16, 4))
    m = pt.Model(net)
    m.prepare(AdamW(learning_rate=0.01, parameters=net.parameters()),
              nn.MSELoss())
    return m


def _fit(model, callbacks, data=None, epochs=2, batch_size=2):
    rec = _LossRecorder()
    model.fit(data or _ToyData(8), batch_size=batch_size, epochs=epochs,
              shuffle=True, verbose=0, callbacks=[rec] + callbacks)
    return rec.losses


def test_sigterm_mid_epoch_saves_and_resume_is_bitwise(tmp_path):
    root = str(tmp_path / "ck")
    full = _fit(_hapi_model(0), [])
    cb = CheckpointCallback(root, save_freq_steps=0, save_freq_epochs=0)
    prefix = _fit(_hapi_model(0), [cb, _SigtermAt(3)])
    assert cb.preempted and len(prefix) == 3 and prefix == full[:3]
    assert ckpt.list_checkpoints(root)
    resume_cb = CheckpointCallback(root, save_freq_steps=0,
                                   save_freq_epochs=0, resume=True)
    suffix = _fit(_hapi_model(7), [resume_cb])
    assert resume_cb.last_restore is not None
    assert prefix + suffix == full


def test_sigterm_handler_restored_after_fit(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    _fit(_hapi_model(0), [CheckpointCallback(str(tmp_path),
                                             save_freq_epochs=0)])
    assert signal.getsignal(signal.SIGTERM) is prev


def test_periodic_async_saves_land(tmp_path):
    root = str(tmp_path)
    cb = CheckpointCallback(root, save_freq_steps=3, save_freq_epochs=0,
                            keep_last_n=2)
    _fit(_hapi_model(0), [cb])
    assert ckpt.list_checkpoints(root) == [ckpt.step_dir_name(3),
                                           ckpt.step_dir_name(6)]
    r = ckpt.restore_checkpoint(root)
    assert r.step == 6 and r.tree["data"]["epoch"] in (0, 1)


def test_resume_from_empty_dir_is_cold_start(tmp_path):
    cb = CheckpointCallback(str(tmp_path / "none"), resume=True,
                            save_freq_epochs=0)
    assert len(_fit(_hapi_model(0), [cb])) == 8 and cb.last_restore is None


def test_preemption_skips_eval_pass(tmp_path):
    evals = []

    class EvalSpy(Callback):
        def on_eval_begin(self, logs=None):
            evals.append(1)

    m = _hapi_model(0)
    cb = CheckpointCallback(str(tmp_path), save_freq_steps=0,
                            save_freq_epochs=0)
    m.fit(_ToyData(8), eval_data=_ToyData(8), batch_size=2, epochs=2,
          verbose=0, callbacks=[cb, _SigtermAt(2), EvalSpy()])
    assert cb.preempted and not evals


@pytest.mark.parametrize("mode", ["keep_last_n", "sparse", "legacy"])
def test_model_checkpoint(tmp_path, mode):
    root = str(tmp_path)
    kw = {"keep_last_n": 2} if mode != "legacy" else {}
    if mode == "sparse":
        kw["save_freq"] = 3
    epochs = 2 if mode == "legacy" else 5
    _hapi_model(0).fit(_ToyData(8), batch_size=4, epochs=epochs, verbose=0,
                       callbacks=[ModelCheckpoint(save_dir=root, **kw)])
    if mode == "legacy":
        assert os.path.exists(os.path.join(root, "final.pdparams"))
        assert os.path.exists(os.path.join(root, "0.pdparams"))
        return
    names = ckpt.list_checkpoints(root)
    assert ckpt.step_dir_name(4) in names
    if mode == "keep_last_n":
        assert names == [ckpt.step_dir_name(3), ckpt.step_dir_name(4)]
    r = ckpt.restore_checkpoint(root)
    assert r.step == 4 and "model" in r.tree


# ------------------------------------------------------------ tiny LLaMA
class _Tokens(Dataset):
    def __init__(self, n=12, s=17, vocab=256):
        self.ids = np.random.RandomState(5).randint(0, vocab, (n, s))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.ids[i]


def _llama_model(seed):
    torch.manual_seed(seed)
    np.random.seed(seed)
    net = LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2),
                           device="cpu")
    m = pt.Model(net, inputs=["input_ids", "labels"])
    m.prepare(AdamW(learning_rate=1e-3, parameters=net.parameters()))
    return m


def test_llama_kill_and_resume_is_bitwise(tmp_path):
    """A tiny LLaMA through Model.fit: an async save every 2 steps, a
    SIGTERM at step 4, then a model from another seed resumed from the
    checkpoint reproduces the uninterrupted run's later losses bitwise."""
    root = str(tmp_path / "ck")
    full = _fit(_llama_model(0), [], data=_Tokens(), epochs=1, batch_size=2)
    cb = CheckpointCallback(root, save_freq_steps=2, save_freq_epochs=0,
                            async_save=True)
    prefix = _fit(_llama_model(0), [cb, _SigtermAt(4)], data=_Tokens(),
                  epochs=1, batch_size=2)
    assert prefix == full[:4] and cb.preempted
    resume = CheckpointCallback(root, save_freq_steps=2,
                                save_freq_epochs=0, resume=True)
    suffix = _fit(_llama_model(9), [resume], data=_Tokens(), epochs=1,
                  batch_size=2)
    assert resume.last_restore.step == 4
    assert prefix + suffix == full


# -------------------------------------------------------- across packages
def _batches(n):
    rs = np.random.RandomState(11)
    return [rs.randint(0, 256, (2, 17)) for _ in range(n)]


def _ref_pair():
    paddle.seed(0)
    ref = PLlama(p_tiny(num_key_value_heads=2))
    return ref, paddle.optimizer.AdamW(learning_rate=1e-3,
                                       parameters=ref.parameters())


def _port_pair(state):
    port = llama_from_numpy(llama_tiny_config(num_key_value_heads=2), state,
                            device="cpu")
    return port, AdamW(learning_rate=1e-3, parameters=port.parameters())


def _ref_step(m, opt, ids):
    x = paddle.to_tensor(ids)
    loss = m(x, x)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.numpy())


def _port_step(m, opt, ids):
    x = torch.from_numpy(ids)
    loss = m(x, labels=x)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.item()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_train_state_continues_in_the_other_package(writer, tmp_path):
    """Two AdamW steps in the writer, its TrainState saved; the reader
    restores it into a model of other weights and takes two more steps:
    its losses lie within 1e-5 of the writer's own next two."""
    root = str(tmp_path)
    batches = _batches(4)
    ref, ropt = _ref_pair()
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    if writer == "ref":
        for b in batches[:2]:
            _ref_step(ref, ropt, b)
        ref_ckpt.save_checkpoint(root, 2, ref_ckpt.capture_train_state(
            ref, ropt, step=2, data_state={"epoch": 0, "batch": 2}))
        want = [_ref_step(ref, ropt, b) for b in batches[2:]]
        port, popt = _port_pair({k: np.zeros_like(v)
                                 for k, v in state.items()})
        meta = ckpt.restore_train_state(ckpt.restore_checkpoint(root).tree,
                                        port, popt)
        assert meta["rng"] == ["numpy"]      # the jax key is not ours
        got = [_port_step(port, popt, b) for b in batches[2:]]
    else:
        port, popt = _port_pair(state)
        for b in batches[:2]:
            _port_step(port, popt, b)
        ckpt.save_checkpoint(root, 2, ckpt.capture_train_state(
            port, popt, step=2, data_state={"epoch": 0, "batch": 2}))
        want = [_port_step(port, popt, b) for b in batches[2:]]
        paddle.seed(5)
        ref2, ropt2 = _ref_pair()
        meta = ref_ckpt.restore_train_state(
            ref_ckpt.restore_checkpoint(root).tree, ref2, ropt2)
        assert meta["data"] == {"epoch": 0, "batch": 2}
        got = [_ref_step(ref2, ropt2, b) for b in batches[2:]]
    assert meta["step"] == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
