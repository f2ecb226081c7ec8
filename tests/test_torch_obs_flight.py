"""The port's request flight recorder held to paddle_tpu's on the CPU.

The port of tests/test_flight.py's recorder cases (the cost ledger and
its D8 audit wait for the ledger's port): a dumped trace re-parses and
validates; every request's queue_wait + prefill spans tile its TTFT
bitwise against stats() after a JSON round trip, through an admission
that blocks; chunk spans nest inside their prefill and count its
chunks; a corrupted TTFT makes the dump refuse; the ring evicts the
oldest finished flights (as the reference's, on the same stream), never
an active one, and caps each flight's spans; a mid-flight postmortem's
window covers its chunk spans; the anomaly triggers — a timeout, a TTFT
SLO breach and a capture forced after warmup — count and, with
FLAGS_obs_flight_dir, dump a trace that validates, and without it dump
nothing; and a chunk that emits no token keeps its span open until the
next read-back dates its end on the device (`_end_mark`, `_ended_at`),
once per such chunk, without the host waiting for it.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import json
import os

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import obs as ref_obs
from paddle_tpu.inference import engine as ref_engine
from paddle_tpu.text.models import LlamaConfig as RConfig
from paddle_tpu.text.models import LlamaForCausalLM as RLlama

from paddle_tpu_torch import obs
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch.inference import engine as port_engine
from paddle_tpu_torch.inference.engine import ServingEngine
from paddle_tpu_torch.obs.flight import REQUEST_SPAN_CAP
from paddle_tpu_torch.text.models import LlamaConfig, llama_from_numpy

_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)
_PAIR: list = []


def _pair():
    """The same tiny LLaMA in both packages, built once per module."""
    if not _PAIR:
        paddle.seed(0)
        ref = RLlama(RConfig(**_KW))
        ref.eval()
        state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
        _PAIR.append((ref, llama_from_numpy(LlamaConfig(**_KW), state,
                                            device="cpu")))
    return _PAIR[0]


def _engine(**kw):
    return ServingEngine(_pair()[1], device="cpu", **kw)


def _drive(eng, streams, seed=0):
    rs = np.random.RandomState(seed)
    for ln, nt in streams:
        eng.add_request(rs.randint(0, 128, (ln,)), max_new_tokens=nt)
    return eng.run()


def _counter(eng, name, trigger):
    for s in eng.metrics()[name]["samples"]:
        if s.get("labels", {}).get("trigger") == trigger:
            return s["value"]
    return 0


# ---------------------------------------------------------- trace shape
def test_dump_reparses_validates_and_tiles_ttft_bitwise(tmp_path):
    eng = _engine(max_slots=2, kv_block_size=8, num_kv_blocks=6)
    # the small pool blocks the second admission: queue_wait absorbs it
    _drive(eng, ((30, 8), (4, 4), (3, 2)))
    assert eng.stats()["admission_blocked"] >= 1
    path = str(tmp_path / "trace.json")
    assert eng.dump_trace(path) == path
    obj = json.load(open(path))
    summary = obs.validate_trace(path)
    assert summary["requests"] == summary["tiled_requests"] == 3
    assert summary["engine_spans"] >= 1
    by_tid = {}
    for e in obj["traceEvents"]:
        if e.get("ph") == "X":
            by_tid.setdefault(e["tid"], {})[e["name"]] = e["args"]
    ttfts, qws = [], []
    for spans in by_tid.values():
        if "queue_wait" in spans and "prefill" in spans:
            assert spans["queue_wait"]["t1_s"] == spans["prefill"]["t0_s"]
            ttfts.append(spans["prefill"]["t1_s"]
                         - spans["queue_wait"]["t0_s"])
            qws.append(spans["queue_wait"]["t1_s"]
                       - spans["queue_wait"]["t0_s"])
    st = eng.stats()
    assert sorted(ttfts) == sorted(st["ttft_s"])           # bitwise
    assert sorted(qws) == sorted(st["queue_wait_s"])


def test_chunk_spans_nest_inside_prefill(tmp_path):
    eng = _engine(max_slots=2, chunked_prefill_tokens=8)
    _drive(eng, ((20, 3),))
    path = str(tmp_path / "trace.json")
    eng.dump_trace(path)
    chunks, prefill = [], None
    for e in json.load(open(path))["traceEvents"]:
        if e.get("ph") != "X":
            continue
        if e["name"] == "prefill_chunk":
            chunks.append(e["args"])
        elif e["name"] == "prefill":
            prefill = e["args"]
    assert len(chunks) == 3 and prefill["chunks"] == 3
    for c in chunks:
        assert prefill["t0_s"] <= c["t0_s"] and c["t1_s"] <= prefill["t1_s"]
    assert [c["last"] for c in chunks] == [False, False, True]


def test_tiling_violation_raises_on_dump():
    eng = _engine(max_slots=1)
    _drive(eng, ((3, 2),))
    fl = eng.flight.flights()[0]
    fl.ttft_s = fl.ttft_s + 1e-9
    with pytest.raises(AssertionError):
        eng.flight.to_chrome()


# ----------------------------------------------------------------- ring
def test_ring_evicts_as_the_reference(tmp_path):
    ref, port = _pair()
    streams = tuple((3 + (i % 3), 2) for i in range(10))
    held = {}
    for name, set_flags, build in (
            ("ref", paddle.set_flags,
             lambda: ref_engine.ServingEngine(ref, max_slots=2)),
            ("port", port_flags.set_flags,
             lambda: ServingEngine(port, max_slots=2, device="cpu"))):
        set_flags({"FLAGS_obs_flight_requests": 4})
        try:
            eng = build()
        finally:
            set_flags({"FLAGS_obs_flight_requests": 256})
        _drive(eng, streams)
        assert len(eng.completed) == 10
        held[name] = (sorted(eng.flight._flights), eng.flight.evicted)
        if name == "port":
            assert len(held[name][0]) <= 4 and 0 not in held[name][0]
            path = str(tmp_path / "trace.json")
            eng.dump_trace(path)
            assert obs.validate_trace(path)["requests"] \
                == len(held[name][0])
            assert eng.metrics()["serving_flight_requests"]["samples"][0][
                "value"] == len(held[name][0])
    assert held["port"] == held["ref"]


def test_active_requests_never_evicted_and_span_cap():
    for o in (ref_obs, obs):
        rec = o.FlightRecorder(capacity=2)
        for rid in range(5):
            rec.begin(rid, 4, 4, float(rid))
        for rid in range(3):                 # 3 finish, 2 stay active
            rec.finish(rid, 10.0 + rid, "length")
        assert 3 in rec._flights and 4 in rec._flights
        assert sorted(rec._flights) == [1, 2, 3, 4] and rec.evicted == 1
        fl = rec.begin(9, 4, 4, 0.0)
        for i in range(700):
            fl.add_span("s", float(i), float(i) + 0.5)
        assert len(fl.spans) == REQUEST_SPAN_CAP
        assert fl.spans_dropped == 700 - REQUEST_SPAN_CAP


def test_midflight_dump_window_covers_chunk_spans():
    rec = obs.FlightRecorder(capacity=8)
    fl = rec.begin(0, 64, 8, 100.0)
    fl.admitted_s = 100.5
    fl.add_span("prefill_chunk", 100.6, 101.2, {"start": 0})
    fl.add_mark("admission_blocked", 101.3)
    doc = rec.to_chrome()
    assert obs.validate_trace(doc)["requests"] == 1
    req = [e for e in doc["traceEvents"]
           if e.get("ph") == "X" and e["name"] == "request"][0]
    assert req["args"]["t1_s"] >= 101.3
    ref_doc = ref_obs.FlightRecorder(capacity=8)
    rfl = ref_doc.begin(0, 64, 8, 100.0)
    rfl.admitted_s = 100.5
    rfl.add_span("prefill_chunk", 100.6, 101.2, {"start": 0})
    rfl.add_mark("admission_blocked", 101.3)
    assert [(e["ph"], e["name"]) for e in doc["traceEvents"]] \
        == [(e["ph"], e["name"]) for e in ref_doc.to_chrome()["traceEvents"]]


# ------------------------------------------------------------- anomalies
def test_timeout_auto_dumps_and_counts(tmp_path):
    d = str(tmp_path / "dumps")
    port_flags.set_flags({"FLAGS_obs_flight_dir": d})
    try:
        eng = _engine(max_slots=1)
        # 1 ms: 40 decode ticks cannot beat it
        eng.add_request(np.arange(4), max_new_tokens=40, max_time_ms=1.0)
        eng.run()
    finally:
        port_flags.set_flags({"FLAGS_obs_flight_dir": ""})
    assert eng.finish_reasons[0] == "timeout"
    assert _counter(eng, "serving_flight_anomalies_total", "timeout") >= 1
    assert eng.metrics()["serving_requests_timeout_total"]["samples"][0][
        "value"] == 1
    dumps = [f for f in os.listdir(d) if f.startswith("flight_timeout")]
    assert dumps
    assert _counter(eng, "serving_flight_dumps_total", "timeout") \
        == len(dumps)
    assert obs.validate_trace(os.path.join(d, dumps[0]))["requests"] >= 1


def test_no_dump_when_dir_unset():
    eng = _engine(max_slots=1)
    eng.add_request(np.arange(4), max_new_tokens=40, max_time_ms=1.0)
    eng.run()
    assert _counter(eng, "serving_flight_anomalies_total", "timeout") >= 1
    assert _counter(eng, "serving_flight_dumps_total", "timeout") == 0
    assert eng.flight.autodumps == 0


def test_slo_breach_counts_and_dumps(tmp_path):
    d = str(tmp_path / "dumps")
    port_flags.set_flags({"FLAGS_obs_flight_dir": d,
                          "FLAGS_obs_slo_ttft_ms": 0.001})
    try:
        eng = _engine(max_slots=1)
        _drive(eng, ((3, 2),))
    finally:
        port_flags.set_flags({"FLAGS_obs_flight_dir": "",
                              "FLAGS_obs_slo_ttft_ms": 0.0})
    assert _counter(eng, "serving_flight_anomalies_total", "slo_breach") == 1
    assert any(f.startswith("flight_slo_breach") for f in os.listdir(d))
    assert [m[0] for m in eng.flight.flights()[0].marks] \
        == ["admitted", "slo_breach"]


def test_post_warmup_capture_auto_dumps(tmp_path):
    d = str(tmp_path / "dumps")
    port_flags.set_flags({"FLAGS_obs_flight_dir": d})
    try:
        eng = _engine(max_slots=2)
        _drive(eng, ((3, 2),))
        eng.finish_warmup()
        eng._programs.clear()             # the next call builds anew
        _drive(eng, ((3, 2),), seed=1)
    finally:
        port_flags.set_flags({"FLAGS_obs_flight_dir": ""})
        obs.clear_events()
    assert _counter(eng, "serving_flight_anomalies_total",
                    "post_warmup_compile") >= 1
    assert any(f.startswith("flight_post_warmup_compile")
               for f in os.listdir(d))


def test_nonfinal_chunk_ends_after_a_device_sync(monkeypatch):
    """A chunk that emits no token reads nothing back: its span stays
    open (one `_end_mark` per such chunk) until the next read-back dates
    its end on the device (`_ended_at`), so that the host never waits for
    it; the final chunk ends at its token's read-back. The spans keep
    their order, and each chunk's trace-span record takes the dated
    end."""
    marks, dated = [], []
    real_mark, real_dated = port_engine._end_mark, port_engine._ended_at
    monkeypatch.setattr(port_engine, "_end_mark",
                        lambda dev: (marks.append(dev), real_mark(dev))[1])
    monkeypatch.setattr(
        port_engine, "_ended_at",
        lambda ms, dev: (dated.append(len(ms)), real_dated(ms, dev))[1])
    obs.clear_spans()
    eng = _engine(max_slots=1, chunked_prefill_tokens=16)
    eng.add_request(np.random.RandomState(3).randint(0, 128, (50,)),
                    max_new_tokens=2)
    eng.run()
    assert eng.stats()["prefill_chunks"] == 4
    assert len(marks) == 3 and all(str(d) == "cpu" for d in marks)
    # the single slot's chunks run one a tick and read nothing back until
    # the final one: the three open spans close together there
    assert dated == [3] and eng._open_chunks == []
    spans = [sp for sp in eng.flight.flights()[0].spans
             if sp[0] == "prefill_chunk"]
    assert [a["start"] for _, _, _, a in spans] == [0, 16, 32, 48]
    assert [a["last"] for _, _, _, a in spans] == [False] * 3 + [True]
    assert all(t0 <= t1 <= nxt for (_, t0, t1, _), (_, nxt, _, _)
               in zip(spans, spans[1:]))
    recs = [e for e in obs.span_events(clear=True)
            if e["name"] == "serving.chunk_prefill"]
    assert [r["seconds"] for r in recs[:3]] \
        == [t1 - t0 for _, t0, t1, _ in spans[:3]]


def test_validate_trace_refuses_a_training_trace():
    """A training flight recorder's dump (the `train_flight` source) is
    routed to `validate_train_trace`, as the reference routes it: a
    corrupted one is refused with the reference's reason, a trace without
    traceEvents is a ValueError as the reference's, and a sound one
    validates alike."""
    from paddle_tpu.obs import train_flight as ref_tf

    from paddle_tpu_torch.obs import train_flight

    for src in ("paddle_tpu.obs.train_flight",
                "paddle_tpu_torch.obs.train_flight"):
        doc = {"traceEvents": [
            {"ph": "X", "tid": 0, "name": "forward", "ts": 0, "dur": 1,
             "args": {"step": 0, "t0_s": 0.0, "t1_s": 1.0}}],
            "otherData": {"source": src}}
        msgs = []
        for o in (ref_obs, obs):
            with pytest.raises(ValueError) as ei:
                o.validate_trace(doc)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1] and "without a step window" in msgs[0]
    for o in (ref_obs, obs):
        with pytest.raises(ValueError, match="traceEvents"):
            o.validate_trace({"traceEvents": []})
    rec = train_flight.TrainFlightRecorder(registry=obs.Registry())
    rec.step_begin(0, 0, 1.0, 1.25)
    rec.step_end(2.0, 0.75)
    doc = rec.to_chrome()
    assert obs.validate_trace(doc) == ref_tf.validate_train_trace(doc) == {
        "events": 6, "steps": 1, "tiled_steps": 1, "io_spans": 0}
