"""The port's MFU / goodput ledger and TelemetryCallback held to
paddle_tpu's on the CPU.

`GoodputLedger` through both packages from the same calls: the category
seconds, `to_dict()` (apart from the live elapsed wall), the hand-computed
MFU of tests/test_train_flight.py:323 (1 TFLOP/s peak, 1e12 flops in 2 s
-> 0.5), repeated dispatches summed per program, the hooks that book
only while a ledger is active, the replay netted out of the next data
wait, and `audit_train_steps` (D12: starvation streaks, MFU collapse)
over recorders driven alike. Then the port's TelemetryCallback across a
SIGTERM kill -> resume (replay and ckpt seconds booked), an aborted fit
(the process hooks restored), epoch-boundary waits, `flight=False`, the
metric families of an instrumented fit (the reference's names), the MFU
numerator of a `to_static` step (its cost-ledger flops) and the peaks'
CPU defaults.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import os
import signal
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import obs as ref_obs
from paddle_tpu.obs import goodput as ref_gp
from paddle_tpu.obs import train_flight as ref_tf

import paddle_tpu_torch as pt
from paddle_tpu_torch import obs as port_obs
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch.hapi.callbacks import (Callback, CheckpointCallback,
                                             TelemetryCallback)
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.obs import goodput as port_gp
from paddle_tpu_torch.obs import train_flight as port_tf

PKGS = {"ref": (ref_obs, ref_gp, ref_tf, paddle.set_flags,
                lambda k: paddle.get_flags(k)[k]),
        "port": (port_obs, port_gp, port_tf, port_flags.set_flags,
                 port_flags.flag)}


class _Flags:
    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: (paddle.get_flags(k)[k], port_flags.flag(k))
                    for k in self.kv}
        paddle.set_flags(self.kv)
        port_flags.set_flags(self.kv)

    def __exit__(self, *exc):
        paddle.set_flags({k: v[0] for k, v in self.old.items()})
        port_flags.set_flags({k: v[1] for k, v in self.old.items()})


def _both(fn):
    """fn(obs, goodput, train_flight) through each package."""
    return {name: fn(*mods[:3]) for name, mods in PKGS.items()}


def _secs(reg):
    return {labels[0]: c.value for labels, c in
            reg.get("train_goodput_seconds_total").samples()}


def test_mfu_hand_computed():
    def run(ob, gp, tf):
        reg = ob.Registry()
        led = gp.GoodputLedger(registry=reg)
        led.start()
        mfu = led.observe_step(2.0, data_wait_s=0.25, flops=1e12,
                               programs=[("to_static|step/abc", 5e11)])
        vals = {labels[0]: c.value for labels, c in
                reg.get("train_mfu").samples()}
        return (mfu, vals, reg.get("train_achieved_flops").value,
                reg.get("train_data_wait_seconds").count)

    with _Flags(FLAGS_obs_peak_tflops=1.0):
        got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0.5
    assert got["port"][1] == {"step": 0.5, "to_static|step/abc": 0.25}


def test_goodput_category_accounting_and_to_dict():
    def run(ob, gp, tf):
        reg = ob.Registry()
        led = gp.GoodputLedger(registry=reg)
        led.start()
        led.observe_step(2.0, data_wait_s=0.5)
        led.observe_step(3.0, data_wait_s=0.0)
        led.note_compile(1.5)
        led.note_ckpt(0.25)
        led.note_replay(0.75)
        led.stop()
        d = led.to_dict()
        d.pop("elapsed_s")
        d.pop("peak_tflops")
        return _secs(reg), d, led.take_window_skip()

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"productive": 5.0, "data_wait": 0.5,
                              "compile": 1.5, "ckpt": 0.25, "replay": 0.75}


def test_repeated_program_dispatch_sums_mfu():
    def run(ob, gp, tf):
        reg = ob.Registry()
        led = gp.GoodputLedger(registry=reg)
        led.start()
        led.observe_step(1.0, flops=1e12,
                         programs=[("p", 5e11), ("p", 5e11)])
        return {labels[0]: c.value for labels, c in
                reg.get("train_mfu").samples()}

    with _Flags(FLAGS_obs_peak_tflops=1.0):
        got = _both(run)
    assert got["port"] == got["ref"] == {"p": 1.0, "step": 1.0}


def test_hooks_only_fire_while_active():
    def run(ob, gp, tf):
        led = gp.GoodputLedger(registry=ob.Registry())
        gp.note_compile(5.0)                 # nothing active
        prev = gp.activate(led)
        try:
            gp.note_compile(7.0)             # active but not started
            led.start()
            gp.note_compile(9.0)
            gp.note_ckpt(0.5)
            gp.note_replay(0.25)
            return dict(led.seconds), gp.active_ledger() is led
        finally:
            gp.deactivate(led)
            if prev is not None:
                gp.activate(prev)

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][0]["compile"] == 9.0


def test_compile_event_books_into_the_active_ledger():
    led = port_gp.GoodputLedger(registry=port_obs.Registry())
    prev = port_gp.activate(led)
    try:
        led.start()
        port_obs.record_compile("to_static", "g", "k", wall_s=0.75)
        assert led.seconds["compile"] == 0.75
    finally:
        port_gp.deactivate(led)
        if prev is not None:
            port_gp.activate(prev)
        port_obs.clear_events()


def _recorder(ob, tf, waits, walls):
    rec = tf.TrainFlightRecorder(capacity=64, registry=ob.Registry())
    t = 100.0
    for i, (dw, wall) in enumerate(zip(waits, walls)):
        rec.step_begin(i, 0, t, t + dw)
        rec.step_end(t + dw + wall, wall_s=(t + dw + wall) - (t + dw))
        t += dw + wall
    return rec


@pytest.mark.parametrize("case", ["healthy", "starved", "collapse",
                                  "steady_mfu"])
def test_audit_train_steps_equals_reference(case):
    waits = [0.001] * 8
    if case == "starved":
        waits[2:6] = [0.5] * 4
    mfus = [0.4] * 20
    if case == "collapse":
        mfus[-6:] = [0.05] * 6

    def run(ob, gp, tf):
        rec = _recorder(ob, tf, waits, [0.01] * 8)
        led = gp.GoodputLedger(registry=ob.Registry())
        if case in ("collapse", "steady_mfu"):
            led.mfu_history.extend(mfus)
        return [f.to_dict() for f in gp.audit_train_steps(
            recorder=rec, ledger=led, data_wait_ms=100.0)]

    got = _both(run)
    assert got["port"] == got["ref"]
    sev = {f["detector"]: f["severity"] for f in got["port"]}
    assert sev["train-starvation"] == ("warning" if case == "starved"
                                       else "note")
    assert sev["train-mfu-collapse"] == ("warning" if case == "collapse"
                                         else "note")


def test_peaks_default_to_the_cpu_fallbacks():
    assert port_obs.peak_tflops() == port_gp.PEAK_TFLOPS_FALLBACK == \
        ref_gp.PEAK_TFLOPS_FALLBACK
    assert port_obs.peak_gbps() == 25.0
    assert port_gp.PEAK_TFLOPS_DEFAULTS == {"cuda": 989.0}
    with _Flags(FLAGS_obs_peak_tflops=2.5, FLAGS_obs_peak_gbps=7.0):
        assert port_obs.peak_tflops() == 2.5 and port_obs.peak_gbps() == 7.0


# ------------------------------------------------- the port's callback
class _ToyData(Dataset):
    def __init__(self, n=16):
        rs = np.random.RandomState(42)
        self.x = rs.randn(n, 8).astype("float32")
        self.y = rs.randn(n, 4).astype("float32")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _model(seed=0):
    pt.set_device("cpu")
    pt.seed(seed)
    np.random.seed(seed)
    net = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                           pt.nn.Linear(16, 4))
    m = pt.Model(net)
    m.prepare(pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters()),
              pt.nn.MSELoss())
    return m


class _SigtermAt(Callback):
    def __init__(self, n):
        self.n = n
        self.count = 0

    def on_train_batch_begin(self, step, logs=None):
        self.count += 1
        if self.count == self.n:
            os.kill(os.getpid(), signal.SIGTERM)


def test_kill_resume_accounts_replay_and_ckpt(tmp_path):
    root = str(tmp_path / "ck")
    reg = port_obs.Registry()
    ck1 = CheckpointCallback(root, save_freq_steps=0, save_freq_epochs=0)
    _model(0).fit(_ToyData(16), batch_size=2, epochs=2, verbose=0,
                  shuffle=True, callbacks=[TelemetryCallback(registry=reg),
                                           ck1, _SigtermAt(3)])
    assert ck1.preempted
    secs = _secs(reg)
    assert secs["ckpt"] > 0 and secs.get("replay", 0) == 0
    prod_before = secs["productive"]
    assert reg.get("train_steps_total").value == 3
    ck2 = CheckpointCallback(root, save_freq_steps=0, save_freq_epochs=0,
                             resume=True)
    tel2 = TelemetryCallback(registry=reg)
    _model(7).fit(_ToyData(16), batch_size=2, epochs=2, verbose=0,
                  shuffle=True, callbacks=[tel2, ck2])
    secs = _secs(reg)
    assert secs["replay"] > 0 and secs["productive"] > prod_before
    assert reg.get("train_steps_total").value == 16
    assert tel2.ledger.take_window_skip() == 0.0


def test_aborted_fit_restores_process_hooks():
    class _Boom(Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 1:
                raise RuntimeError("injected mid-fit failure")

    cb = TelemetryCallback(registry=port_obs.Registry())
    with pytest.raises(RuntimeError, match="injected"):
        _model().fit(_ToyData(16), batch_size=4, verbose=0, shuffle=False,
                     callbacks=[cb, _Boom()])
    assert port_tf.current() is None and port_gp.active_ledger() is None
    assert not cb.ledger.active


def test_epoch_boundary_work_not_counted_as_data_wait():
    cb = TelemetryCallback(registry=port_obs.Registry())
    cb.on_train_begin()
    try:
        cb.on_epoch_begin(0)
        cb.on_train_batch_begin(0)
        cb.on_train_batch_end(0, {"loss": 0.1})
        time.sleep(0.05)
        cb.on_epoch_begin(1)
        cb.on_train_batch_begin(1)
        assert cb._cur.data_wait_s < 0.04
        cb.on_train_batch_end(1, {"loss": 0.1})
    finally:
        cb.on_train_end()


def test_boundary_resume_books_replay():
    reg = port_obs.Registry()
    cb = TelemetryCallback(registry=reg)
    m = _model()
    m._ckpt_resume = {"epoch": 0, "batch": 4}
    m.fit(_ToyData(16), batch_size=4, epochs=2, verbose=0, shuffle=False,
          callbacks=[cb])
    assert _secs(reg)["replay"] > 0
    assert reg.get("train_steps_total").value == 4
    assert cb.ledger.take_window_skip() == 0.0


def test_flight_off_still_reports_data_wait():
    reg = port_obs.Registry()
    cb = TelemetryCallback(registry=reg, flight=False)
    cb.on_train_begin()
    try:
        cb.on_epoch_begin(0)
        cb.on_train_batch_begin(0)
        cb.on_train_batch_end(0, {"loss": 0.1})
        time.sleep(0.03)
        cb.on_train_batch_begin(1)
        cb.on_train_batch_end(1, {"loss": 0.1})
    finally:
        cb.on_train_end()
    h = reg.get("train_data_wait_seconds")
    assert cb.flight is None and h.count == 2 and max(h._exact) > 0.02


def test_telemetry_families_are_the_reference():
    """The metric families an instrumented fit leaves, names, types and
    help strings, are the reference's."""
    from paddle_tpu.hapi.callbacks import TelemetryCallback as RTelemetry

    def families(reg):
        return {name: (type(m).__name__, m.doc, m.labelnames)
                for name, m in reg._metrics.items()}

    rreg = ref_obs.Registry()
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    # the reference's eager VJPs taken directly (its deferred-VJP pass
    # reads a jax API this jax lacks)
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    paddle.seed(0)
    rnet = paddle.nn.Sequential(paddle.nn.Linear(8, 4))
    rm = paddle.Model(rnet)
    rm.prepare(paddle.optimizer.AdamW(learning_rate=1e-3,
                                      parameters=rnet.parameters()),
               paddle.nn.MSELoss())
    rm.fit(_RefData(), batch_size=4, verbose=0, shuffle=False,
           callbacks=[RTelemetry(registry=rreg, batch_tokens=8,
                                 step_flops=1e6)])
    paddle.set_flags(old)
    preg = port_obs.Registry()
    _model().fit(_ToyData(8), batch_size=4, verbose=0, shuffle=False,
                 callbacks=[TelemetryCallback(registry=preg, batch_tokens=8,
                                              step_flops=1e6)])
    assert families(preg) == families(rreg)


class _RefData(paddle.io.Dataset):
    def __init__(self, n=8):
        rs = np.random.RandomState(42)
        self.x = rs.randn(n, 8).astype("float32")
        self.y = rs.randn(n, 4).astype("float32")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def test_metrics_flag_attaches_telemetry():
    from paddle_tpu_torch.hapi.callbacks import config_callbacks

    assert not port_obs.metrics_enabled()
    with _Flags(FLAGS_obs_metrics=True):
        assert port_obs.metrics_enabled()
        cbks = config_callbacks(None, model=None, verbose=0)
        assert any(isinstance(c, TelemetryCallback) for c in cbks.callbacks)
    cbks = config_callbacks(None, model=None, verbose=0)
    assert not any(isinstance(c, TelemetryCallback) for c in cbks.callbacks)


def test_compiled_step_flops_feed_mfu():
    """A to_static train step's cost-ledger flops (counted at its
    discovery call) are the recorder's MFU numerator: the dispatch span
    carries them, and train_mfu has the program's child."""
    reg = port_obs.Registry()
    rec = port_tf.TrainFlightRecorder(registry=reg)
    led = port_gp.GoodputLedger(registry=reg)
    prev = port_tf.set_current(rec)
    try:
        pt.set_device("cpu")
        pt.seed(0)
        net = pt.nn.Linear(8, 4)
        opt = pt.optimizer.SGD(learning_rate=1e-3,
                               parameters=net.parameters())
        loss_fn = pt.nn.MSELoss()

        @pt.jit.to_static
        def train_step(x, y):
            loss = loss_fn(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        rs = np.random.RandomState(0)
        x = pt.to_tensor(rs.randn(4, 8).astype("float32"))
        y = pt.to_tensor(rs.randn(4, 4).astype("float32"))
        led.start()
        last = None
        for i in range(6):
            t0 = time.perf_counter()
            rec.step_begin(i, 0, t0, t0)
            train_step(x, y)
            end = time.perf_counter()
            last = rec.step_end(end, end - t0)
        assert last.flops > 0
        assert last.programs[0][0].startswith("to_static|")
        assert any(n.startswith("dispatch:") for n, _, _, _ in last.spans)
        assert led.observe_step(last.wall_s, flops=last.flops,
                                programs=last.programs) > 0
        programs = {labels[0] for labels, _ in
                    reg.get("train_mfu").samples()}
        assert "step" in programs
        assert any(p.startswith("to_static|") for p in programs)
    finally:
        port_tf.set_current(prev)
