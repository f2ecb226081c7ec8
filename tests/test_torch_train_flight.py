"""The port's training flight recorder held to paddle_tpu's on the CPU.

The same scripted `step_begin` / spans / marks / `step_end` calls go
through both packages' `TrainFlightRecorder`: the Chrome traces are
equal apart from the process name and the source tag; `validate_train_
trace` (and `obs.validate_trace`, which routes a training dump to it)
accepts both and rejects the reference's corrupted cases alike; the
ring, the span cap and the three anomaly postmortems (data starvation,
step spike, checkpoint stall) fire and stay quiet alike (the cases of
tests/test_train_flight.py, parametrized over both packages). Then an
instrumented `Model.fit` of the port dumps a trace whose steps tile
their recorded walls bitwise and carry the eager step's phase spans.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import json

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import obs as ref_obs
from paddle_tpu.obs import train_flight as ref_tf

import paddle_tpu_torch as pt
from paddle_tpu_torch import obs as port_obs
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch.hapi.callbacks import TelemetryCallback
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.obs import train_flight as port_tf

PKGS = {"ref": (ref_obs, ref_tf, paddle.set_flags,
                lambda k: paddle.get_flags(k)[k]),
        "port": (port_obs, port_tf, port_flags.set_flags, port_flags.flag)}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


class _Flags:
    def __init__(self, pkg, **kv):
        self.set, self.get = pkg[2], pkg[3]
        self.kv = kv

    def __enter__(self):
        self.old = {k: self.get(k) for k in self.kv}
        self.set(self.kv)

    def __exit__(self, *exc):
        self.set(self.old)


def _script(rec):
    """Three finished steps with phase spans, a dispatch, marks and an IO
    span, then an active step: fixed floats, so both packages see the
    same calls."""
    class _Entry:
        analyzed = True
        program = "to_static|step/abcd1234"
        flops = 2.5e9

    for i in range(3):
        t0 = 10.0 + i
        rec.step_begin(i, 0, t0, t0 + 0.125)
        rec.program_span("h2d", t0 + 0.125, t0 + 0.25, tensors=2)
        rec.program_span("forward", t0 + 0.25, t0 + 0.5)
        rec.program_dispatch("step", t0 + 0.5, t0 + 0.625, entry=_Entry())
        rec.mark("preemption", t=t0 + 0.7, step=i)
        end = t0 + 0.875
        rec.step_end(end, end - (t0 + 0.125), loss=1.5 - i, flushes=0)
    rec.io_span("ckpt_commit", 12.0, 13.5, step=2)
    rec.mark("epoch_begin", t=13.9, epoch=1)
    rec.step_begin(3, 1, 14.0, 14.25)
    rec.program_span("forward", 14.25, 14.5)


def _strip(doc):
    ev = [e for e in doc["traceEvents"] if e.get("name") != "process_name"]
    other = {k: v for k, v in doc["otherData"].items() if k != "source"}
    return ev, other


def test_scripted_calls_give_the_reference_trace():
    reg_r, reg_p = ref_obs.Registry(), port_obs.Registry()
    r = ref_tf.TrainFlightRecorder(capacity=8, registry=reg_r)
    p = port_tf.TrainFlightRecorder(capacity=8, registry=reg_p)
    _script(r)
    _script(p)
    dr, dp = r.to_chrome(), p.to_chrome()
    assert _strip(dp) == _strip(dr)
    assert dp["otherData"]["source"] == "paddle_tpu_torch.obs.train_flight"
    for o in (ref_tf, port_tf):
        assert o.validate_train_trace(dr) == o.validate_train_trace(dp)
    assert port_obs.validate_trace(dp) == ref_obs.validate_trace(dr)
    assert [s.flops for s in p.steps()] == [s.flops for s in r.steps()]
    assert reg_p.to_dict()["train_flight_steps"] == \
        reg_r.to_dict()["train_flight_steps"]


def test_tiling_violation_raises_at_dump(pkg):
    ob, tf = pkg[0], pkg[1]
    rec = tf.TrainFlightRecorder(capacity=8, registry=ob.Registry())
    rec.step_begin(0, 0, 10.0, 10.5)
    rec.step_end(11.0, wall_s=0.4)
    with pytest.raises(AssertionError, match="tile the recorded"):
        rec.to_chrome()


def test_nonmonotonic_lifecycle_raises(pkg):
    ob, tf = pkg[0], pkg[1]
    rec = tf.TrainFlightRecorder(capacity=8, registry=ob.Registry())
    rec.step_begin(0, 0, 10.6, 10.5)
    rec.step_end(11.0, wall_s=0.5)
    with pytest.raises(AssertionError, match="non-monotonic"):
        rec.to_chrome()


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("corruption", ["wall", "tear", "escape", "empty"])
def test_validate_rejects_corrupted_dumps(writer, corruption):
    """The reference's corrupted cases, on either package's dump, are
    refused by both validators with the same reason."""
    ob, tf = PKGS[writer][0], PKGS[writer][1]
    rec = tf.TrainFlightRecorder(capacity=8, registry=ob.Registry())
    rec.step_begin(0, 0, 10.0, 10.5)
    rec.program_span("forward", 10.5, 10.75)
    rec.step_end(11.0, wall_s=0.5)
    doc = json.loads(json.dumps(rec.to_chrome()))
    for e in doc["traceEvents"]:
        if corruption == "wall" and e.get("name") == "compute":
            e["args"]["wall_s"] = 0.123
        if corruption == "tear" and e.get("name") == "data_wait":
            e["args"]["t1_s"] += 1e-9
        if corruption == "escape" and e.get("name") == "forward":
            e["args"]["t1_s"] = 12.0
    if corruption == "empty":
        doc["traceEvents"] = []
    msgs = []
    for o in (ref_tf, port_tf):
        with pytest.raises(ValueError) as ei:
            o.validate_train_trace(doc)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError):
        port_obs.validate_trace(doc)


def test_active_step_dumps_without_tiling(pkg):
    ob, tf = pkg[0], pkg[1]
    rec = tf.TrainFlightRecorder(capacity=8, registry=ob.Registry())
    rec.step_begin(0, 0, 10.0, 10.5)
    rec.step_end(11.0, wall_s=0.5)
    rec.step_begin(1, 0, 11.0, 11.2)
    rec.program_span("forward", 11.3, 11.4)
    summary = tf.validate_train_trace(rec.to_chrome())
    assert summary["steps"] == 2 and summary["tiled_steps"] == 1


# ------------------------------------------------------------------- ring
def test_eviction_keeps_newest(pkg):
    ob, tf = pkg[0], pkg[1]
    rec = tf.TrainFlightRecorder(capacity=4, registry=ob.Registry())
    for i in range(10):
        rec.step_begin(i, 0, float(i), i + 0.25)
        rec.step_end(i + 1.0, wall_s=0.75)
    assert rec.evicted == 6
    assert [st.index for st in rec.steps()] == [6, 7, 8, 9]


def test_active_step_never_evicted(pkg):
    ob, tf = pkg[0], pkg[1]
    rec = tf.TrainFlightRecorder(capacity=2, registry=ob.Registry())
    for i in range(5):
        rec.step_begin(i, 0, float(i), i + 0.25)
        rec.step_end(i + 1.0, wall_s=0.75)
    rec.step_begin(99, 1, 50.0, 50.1)
    assert [st.index for st in rec.steps()] == [3, 4, 99]


def test_span_cap_counts_drops(pkg):
    ob, tf = pkg[0], pkg[1]
    rec = tf.TrainFlightRecorder(capacity=2, registry=ob.Registry())
    st = rec.step_begin(0, 0, 0.0, 0.1)
    for i in range(tf.STEP_SPAN_CAP + 50):
        rec.program_span("forward", 0.2, 0.3, i=i)
    assert len(st.spans) == tf.STEP_SPAN_CAP and st.spans_dropped == 50


def test_flight_steps_gauge_counts_active(pkg):
    ob, tf = pkg[0], pkg[1]
    reg = ob.Registry()
    rec = tf.TrainFlightRecorder(capacity=8, registry=reg)
    rec.step_begin(0, 0, 1.0, 1.25)
    assert reg.get("train_flight_steps").value == 1
    rec.step_end(2.0, wall_s=0.75)
    rec.step_begin(1, 0, 2.0, 2.25)
    assert reg.get("train_flight_steps").value == 2


# -------------------------------------------------------------- anomalies
def _drive(rec, dw, wall, n=1, start=0):
    for i in range(start, start + n):
        t0 = 100.0 + i
        begin, end = t0 + dw, t0 + dw + wall
        rec.step_begin(i, 0, t0, begin)
        rec.step_end(end, wall_s=end - begin)


def _count(reg, name, trigger):
    for labels, child in reg.get(name).samples():
        if labels == (trigger,):
            return child.value
    return 0.0


def test_data_starvation_fire_and_no_fire(pkg, tmp_path):
    ob, tf = pkg[0], pkg[1]
    reg = ob.Registry()
    with _Flags(pkg, FLAGS_obs_data_wait_ms=10.0,
                FLAGS_obs_flight_dir=str(tmp_path / "dumps")):
        rec = tf.TrainFlightRecorder(capacity=8, registry=reg)
        _drive(rec, dw=0.001, wall=0.05)
        assert _count(reg, "train_flight_anomalies_total",
                      "data_starvation") == 0
        _drive(rec, dw=0.05, wall=0.05, start=1)
        assert _count(reg, "train_flight_anomalies_total",
                      "data_starvation") == 1
        assert _count(reg, "train_flight_dumps_total",
                      "data_starvation") == 1
        tf.validate_train_trace(rec.autodump_paths[0])


def test_step_spike_fire_and_no_fire(pkg):
    ob, tf = pkg[0], pkg[1]
    reg = ob.Registry()
    with _Flags(pkg, FLAGS_obs_step_spike_factor=3.0,
                FLAGS_obs_data_wait_ms=0.0):
        rec = tf.TrainFlightRecorder(capacity=32, registry=reg)
        _drive(rec, dw=0.0, wall=0.01, n=10)
        assert _count(reg, "train_flight_anomalies_total",
                      "step_spike") == 0
        _drive(rec, dw=0.0, wall=0.1, n=1, start=10)
        assert _count(reg, "train_flight_anomalies_total",
                      "step_spike") == 1


def test_ckpt_stall_fire_and_no_fire(pkg):
    ob, tf = pkg[0], pkg[1]
    reg = ob.Registry()
    with _Flags(pkg, FLAGS_obs_data_wait_ms=0.0):
        rec = tf.TrainFlightRecorder(capacity=8, registry=reg)
        prev = tf.set_current(rec)
        try:
            ob.record_ckpt_save(step=1, wall_s=0.01, nbytes=10, result="ok")
            assert _count(reg, "train_flight_anomalies_total",
                          "ckpt_stall") == 0
            stall = pkg[3]("FLAGS_ckpt_stall_seconds") + 1.0
            ob.record_ckpt_save(step=2, wall_s=stall, nbytes=10,
                                result="ok")
            ob.record_ckpt_save(step=3, wall_s=0.01, nbytes=10,
                                result="error")
            assert _count(reg, "train_flight_anomalies_total",
                          "ckpt_stall") == 2
        finally:
            tf.set_current(prev)
            ob.clear_events()


def test_no_dump_without_dir_and_cap(pkg, tmp_path):
    ob, tf = pkg[0], pkg[1]
    reg = ob.Registry()
    rec = tf.TrainFlightRecorder(capacity=8, registry=reg)
    _drive(rec, dw=0.0, wall=0.01)
    assert rec.anomaly("step_spike") is None and rec.autodumps == 0
    with _Flags(pkg, FLAGS_obs_flight_dir=str(tmp_path / "d")):
        for _ in range(tf.AUTODUMP_CAP + 5):
            rec.anomaly("step_spike")
    assert rec.autodumps == tf.AUTODUMP_CAP
    assert _count(reg, "train_flight_anomalies_total",
                  "step_spike") == tf.AUTODUMP_CAP + 6


def test_flags_have_the_reference_defaults():
    from paddle_tpu.core import flags as ref_flags

    for name in ("FLAGS_obs_train_flight_steps", "FLAGS_obs_data_wait_ms",
                 "FLAGS_obs_step_spike_factor", "FLAGS_obs_peak_tflops",
                 "FLAGS_obs_metrics", "FLAGS_obs_cost_capture",
                 "FLAGS_obs_peak_gbps", "FLAGS_obs_cost_regress_pct",
                 "FLAGS_dataloader_use_shared_memory",
                 "FLAGS_ckpt_save_retries", "FLAGS_ckpt_retry_backoff_s",
                 "FLAGS_ckpt_async", "FLAGS_ckpt_max_in_flight",
                 "FLAGS_ckpt_keep_last_n", "FLAGS_ckpt_stall_seconds"):
        assert port_flags.flag(name) == ref_flags._REGISTRY[name][
            "default"], name


# ---------------------------------------------------- an instrumented fit
class _ToyData(Dataset):
    def __init__(self, n=16):
        rs = np.random.RandomState(42)
        self.x = rs.randn(n, 8).astype("float32")
        self.y = rs.randn(n, 4).astype("float32")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _port_model():
    pt.set_device("cpu")
    pt.seed(0)
    net = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                           pt.nn.Linear(16, 4))
    m = pt.Model(net)
    m.prepare(pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters()),
              pt.nn.MSELoss())
    return m


@pytest.mark.parametrize("workers", [0, 2])
def test_fit_dump_tiles_every_step_bitwise(tmp_path, workers):
    reg = port_obs.Registry()
    cb = TelemetryCallback(registry=reg, batch_tokens=32)
    _port_model().fit(_ToyData(16), batch_size=4, epochs=2, verbose=0,
                      shuffle=False, callbacks=[cb], num_workers=workers)
    path = str(tmp_path / "train_trace.json")
    cb.flight.dump(path)
    obj = json.load(open(path))
    summary = port_obs.validate_trace(path)
    assert summary["steps"] == summary["tiled_steps"] == 8
    computes = [e for e in obj["traceEvents"]
                if e.get("ph") == "X" and e["name"] == "compute"]
    for e in computes:
        assert (e["args"]["t1_s"] - e["args"]["t0_s"]) == e["args"]["wall_s"]
    hist = reg.get("train_step_seconds")
    assert sorted(e["args"]["wall_s"] for e in computes) == \
        sorted(hist._exact)
    names = {e["name"] for e in obj["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "program"}
    assert {"h2d", "forward", "backward", "optimizer_commit",
            "loss_fetch"} <= names
    assert reg.get("train_lazy_flushes_total").value == 0
