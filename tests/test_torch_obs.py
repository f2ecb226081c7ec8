"""The port's obs package held to paddle_tpu's on the CPU: the registry,
the exporters, spans, the logger and the compile watchdog.

The port of tests/test_obs.py:30-300 and tests/test_flight.py:412-492,
each case run through both packages from the same operations: the
registry's semantics (labels, the cardinality cap, exact and bucket
quantiles, a second bucket ladder refused), `to_dict` and the Prometheus
exposition (equal text, escaping, float spellings), the JSONL event log
with its rotation that never tears a line, span nesting and histograms,
the VLOG gate, rate limiting and its suppression report, the watchdog's
events, counters and audit findings (storm, thrash, eager by design,
post-warmup). Besides: the public names are the reference's; the obs
flags have the reference's defaults; `capture_trace` writes a Chrome
trace.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import obs as ref_obs
from paddle_tpu.core import flags as ref_flags

from paddle_tpu_torch import obs
from paddle_tpu_torch.core import flags as port_flags


def _mods():
    return (("ref", ref_obs, paddle.set_flags),
            ("port", obs, port_flags.set_flags))


def _strip_t(rec):
    return {k: v for k, v in rec.items() if k != "t"}


# ------------------------------------------------------------- registry
def _registry_ops(o):
    r = o.Registry("t")
    c = r.counter("reqs_total", "requests", ("kind",))
    c.labels("a").inc()
    c.labels("a").inc(2)
    c.labels(kind="b").inc()
    with pytest.raises(ValueError):
        c.labels("a").inc(-1)          # counters are monotonic
    g = r.gauge("depth", "queue depth")
    g.set(5)
    g.inc()
    g.dec(2)
    assert r.counter("reqs_total", "requests", ("kind",)) is c
    with pytest.raises(ValueError):
        r.gauge("reqs_total", "boom")
    with pytest.raises(ValueError):
        r.counter("reqs_total", "boom", ("other",))
    with pytest.raises(ValueError):
        r.counter("x_total", "", ("a", "b")).labels("only-one")
    with pytest.raises(ValueError):
        r.counter("x_total", "", ("a", "b")).labels(a="1", c="2")
    bomb = r.counter("bomb_total", "", ("rid",), label_cap=4)
    for i in range(10):
        bomb.labels(str(i)).inc()
    h = r.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    assert r.histogram("h_seconds", "", buckets=(1.0, 0.1)) is h
    with pytest.raises(ValueError):
        r.histogram("h_seconds", "", buckets=(0.5, 2.0))
    r.counter("e_total", "", ("p",)).labels('a\\b"c\nd').inc()
    r.counter("m_total", "multi\nline \\ doc").inc()
    r.gauge("g_nan", "").set(float("nan"))
    r.gauge("g_inf", "").set(float("inf"))
    return r


def test_registry_semantics_and_exports_equal_reference():
    ref, port = _registry_ops(ref_obs), _registry_ops(obs)
    assert port.names() == ref.names()
    bomb = port.get("bomb_total")
    assert bomb.dropped_label_sets == 6
    assert dict(bomb.samples())[(obs.OVERFLOW,)].value == 6
    assert port.get("depth").value == 4
    # the snapshot (NaN compares by its spelling) and the exposition
    assert json.dumps(port.to_dict(), sort_keys=True) \
        == json.dumps(ref.to_dict(), sort_keys=True)
    text = port.render_prometheus()
    assert text == ref.render_prometheus()
    assert r'p="a\\b\"c\nd"' in text
    assert r"# HELP t_m_total multi\nline \\ doc" in text
    assert "t_g_nan NaN" in text and "t_g_inf +Inf" in text
    lines = dict(ln.rsplit(" ", 1) for ln in text.splitlines()
                 if ln and not ln.startswith("#"))
    assert lines['t_h_seconds_bucket{le="0.1"}'] == "1"
    assert lines['t_h_seconds_bucket{le="+Inf"}'] == "3"
    assert port.render_prometheus(extra_labels=(("engine", "e0"),)) \
        == ref.render_prometheus(extra_labels=(("engine", "e0"),))


def test_histogram_quantiles_equal_reference():
    """Exact quantiles while the population fits the ring, bucket
    interpolation past it: the same numbers as the reference's."""
    rs = np.random.RandomState(0)
    vals = rs.uniform(0.001, 2.0, size=2000)
    for cap in (4000, 100):
        hr = ref_obs.Histogram("a", "", exact_cap=cap)
        hp = obs.Histogram("a", "", exact_cap=cap)
        for v in vals:
            hr.observe(v)
            hp.observe(v)
        assert hp.exact == hr.exact == (cap == 4000)
        for q in (0.0, 0.5, 0.9, 0.95, 1.0):
            assert hp.quantile(q) == hr.quantile(q), (cap, q)
        assert hp.mean() == hr.mean()
    with pytest.raises(ValueError):
        hp.quantile(1.5)
    assert np.isnan(obs.Histogram("e", "").quantile(0.5))


def test_jsonl_event_log_round_trip_equals_reference(tmp_path):
    recs = {}
    for name, o, set_flags in _mods():
        path = str(tmp_path / f"{name}.jsonl")
        set_flags({"FLAGS_obs_log_path": path})
        try:
            assert o.log_event("compile", site="test", key="k1")
            r = o.Registry()
            r.counter("c_total", "").inc(7)
            assert o.dump_registry(r)
        finally:
            set_flags({"FLAGS_obs_log_path": ""})
        assert not o.log_event("compile", site="dropped")   # flag off
        recs[name] = [_strip_t(json.loads(ln)) for ln in open(path)]
    assert recs["port"] == recs["ref"]
    assert [r["kind"] for r in recs["port"]] == ["compile", "metrics"]


def test_rotation_never_tears_a_line(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    port_flags.set_flags({"FLAGS_obs_log_path": path,
                          "FLAGS_obs_log_max_mb": 1,
                          "FLAGS_obs_log_backups": 2})
    pad = "x" * 1024
    try:
        for i in range(2600):            # ~2.6 MB over a 1 MB cap
            assert obs.log_event("rot", i=i, pad=pad)
    finally:
        port_flags.set_flags({"FLAGS_obs_log_path": "",
                              "FLAGS_obs_log_max_mb": 64,
                              "FLAGS_obs_log_backups": 3})
    files = [path + ".2", path + ".1", path]
    assert all(os.path.exists(f) for f in files)
    assert not os.path.exists(path + ".3")   # the oldest deleted
    seen = []
    for f in files:
        assert os.path.getsize(f) <= 1024 * 1024 + 2048
        for ln in open(f).read().splitlines():
            seen.append(json.loads(ln)["i"])     # no torn line anywhere
    assert seen == list(range(2600 - len(seen), 2600))
    # cap 0 never rotates
    path0 = str(tmp_path / "ev0.jsonl")
    port_flags.set_flags({"FLAGS_obs_log_path": path0,
                          "FLAGS_obs_log_max_mb": 0})
    try:
        for i in range(50):
            obs.log_event("rot", i=i)
    finally:
        port_flags.set_flags({"FLAGS_obs_log_path": "",
                              "FLAGS_obs_log_max_mb": 64})
    assert not os.path.exists(path0 + ".1")
    assert len(open(path0).readlines()) == 50


# ---------------------------------------------------------------- spans
def test_spans_nest_and_feed_histograms_as_the_reference():
    got = {}
    for name, o, _ in _mods():
        o.clear_spans()
        h = o.Histogram("span_h", "")
        with o.span("outer"):
            with o.span("inner", histogram=h):
                pass
        with o.step_span(3):
            pass
        evs = o.span_events(clear=True)
        assert h.count == 1 and all(e["seconds"] >= 0 for e in evs)
        got[name] = [(e["name"], e["path"], e["depth"]) for e in evs]
        assert o.span_events() == []
    assert got["port"] == got["ref"] == [
        ("inner", "outer/inner", 1), ("outer", "outer", 0),
        ("train_step[3]", "train_step[3]", 0)]


def test_capture_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with obs.capture_trace(d) as out:
        with obs.span("captured"):
            torch.ones(8).sum()
    assert out == d
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    assert json.load(open(os.path.join(d, files[0])))["traceEvents"]


# -------------------------------------------------------------- logging
def test_logging_gate_rate_limit_and_warnings_as_the_reference(capsys):
    out = {}
    for name, o, set_flags in _mods():
        log = o.get_logger("tests.vlog")
        log.reset()
        set_flags({"FLAGS_log_level": 0})
        assert not log.vlog(1, "hidden")
        set_flags({"FLAGS_log_level": 2})
        try:
            assert log.vlog(2, "shown", key="s1")
            assert log.info("info line", key="i1")
        finally:
            set_flags({"FLAGS_log_level": 0})
        rate = o.get_logger("tests.rate")
        rate.reset()
        assert rate.warning("spam", key="k")
        for _ in range(5):
            assert not rate.warning("spam", key="k")
        assert rate.suppressed_total == 5
        rate._last["k"] -= 100.0
        assert rate.warning("spam", key="k")
        assert o.get_logger("tests.err").error("bad", key="e")
        assert o.get_logger("tests.err").error("bad", key="e")  # no limit
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            aw = o.get_logger("tests.alsowarn")
            aw.reset()
            aw.warning("graph break in 'f'", key="w1", also_warn=True)
            aw.warning("graph break in 'f'", key="w1", also_warn=True)
        assert sum("graph break" in str(m.message) for m in w) == 2
        out[name] = capsys.readouterr().err
    assert out["port"] == out["ref"]
    assert "[paddle_tpu:tests.vlog] V2: shown" in out["port"]
    assert "[5 similar suppressed]" in out["port"]
    assert obs.get_logger("paddle_tpu_torch.inference.engine").module \
        == "inference.engine"


# ------------------------------------------------------------- watchdog
def _findings(fs):
    """The findings as the audits' consumers read them (the message text
    is the port's own; the events' wall-clock stamps differ)."""
    return [(f.detector, f.severity, f.loc,
             {k: [_strip_t(e) for e in v] if k == "events" else v
              for k, v in f.data.items()}) for f in fs]


def test_record_compile_events_and_counters():
    for _, o, _ in _mods():
        o.clear_events()
        before = o.default_registry().counter(
            "compiles_total", "", ("site",)).labels("testsite").value
        ev = o.record_compile("testsite", "fam", "k1", bucket=4, wall_s=0.25,
                              donated=True)
        evs = o.compile_events("testsite")
        assert len(evs) == 1 and evs[0].bucket == 4
        assert o.compile_counts() == {"testsite": 1}
        assert o.default_registry().counter(
            "compiles_total", "", ("site",)).labels("testsite").value \
            == before + 1
        assert {k for k in ev.to_dict()} >= {"site", "group", "key",
                                             "bucket", "wall_s", "warm",
                                             "cost"}
        o.record_compile("testsite", "fam", "k2", warm=True)
        assert o.post_warmup_compiles() == 1
        o.clear_events()
        assert o.compile_counts() == {} and o.post_warmup_compiles() == 0


@pytest.mark.parametrize("case", ["storm", "under", "thrash", "eager",
                                  "eager-thrash", "warm"])
def test_audit_recompiles_equals_reference(case):
    def events(o):
        ce = o.CompileEvent
        return {"storm": ([ce("generate", "generate/llama", f"g{i}")
                           for i in range(6)], 3),
                "under": ([ce("generate", "generate/llama", f"g{i}")
                           for i in range(3)], 3),
                "thrash": ([ce("to_static", "step@1", "k")] * 2, 8),
                "eager": ([ce("eager", "matmul", f"k{i}")
                           for i in range(50)], 3),
                "eager-thrash": ([ce("eager", "matmul", f"k{i}")
                                  for i in range(50)]
                                 + [ce("eager", "matmul", "k0")], 3),
                "warm": ([ce("serving.decode", "d", "k", warm=True)], 8),
                }[case]

    got = {}
    for name, o, _ in _mods():
        evs, th = events(o)
        got[name] = _findings(o.audit_recompiles(evs, threshold=th))
    assert got["port"] == got["ref"]
    sev = {s for _, s, *_ in got["port"]}
    if case in ("under", "eager"):
        assert sev == {"note"}
    else:
        assert "warning" in sev


def test_jaxpr_size_counts_an_fx_graph():
    gm = torch.fx.symbolic_trace(torch.nn.Sequential(
        torch.nn.Linear(4, 4), torch.nn.ReLU()))
    assert obs.jaxpr_size(gm) == len(list(gm.graph.nodes)) == 4


# ------------------------------------------------------- public surface
def test_public_names_are_the_reference_less_the_unported():
    """Every public name of the reference's obs is the port's: the cost
    ledger, the training flight recorder and goodput, `metrics_enabled`
    and the checkpoint-save audit included (nothing is left unported)."""
    unported = set()
    assert set(obs.__all__) == set(ref_obs.__all__) - unported
    for name in obs.__all__:
        assert hasattr(obs, name), name
    assert obs.default_registry() is obs.default_registry()
    assert obs.render_prometheus() == obs.default_registry(
    ).render_prometheus()


def test_obs_flags_have_the_reference_defaults():
    for name in ("FLAGS_log_level",
                 "FLAGS_obs_log_path", "FLAGS_obs_log_max_mb",
                 "FLAGS_obs_log_backups",
                 "FLAGS_obs_compile_storm_threshold", "FLAGS_obs_http_port",
                 "FLAGS_obs_flight_requests", "FLAGS_obs_flight_dir",
                 "FLAGS_obs_slo_ttft_ms"):
        assert port_flags.flag(name) == ref_flags._REGISTRY[name][
            "default"], name


def test_finding_record_equals_reference():
    from paddle_tpu.analysis import Finding as RFinding

    from paddle_tpu_torch.analysis import Finding

    a = Finding("d", "warning", "loc", "msg", {"x": 1})
    b = RFinding("d", "warning", "loc", "msg", {"x": 1})
    assert a.to_dict() == b.to_dict() and repr(a) == repr(b)
    with pytest.raises(AssertionError):
        Finding("d", "fatal", "loc", "msg")
