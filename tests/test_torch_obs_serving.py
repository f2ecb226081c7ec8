"""The serving engine's telemetry in the port held to paddle_tpu's on the
CPU: the registry families, their values, the exposition, the flight
spans, the compile events and the shared /metrics endpoint.

After the same tiny LLaMA stream (8-token chunks, a small pool that
blocks an admission, a prefix hit) and the same tiny GPT stream (n-gram
speculation: verify windows) through both engines: every `serving_*`
family of the reference's exists with its kind, label names and help
string; counter and gauge values and histogram counts are equal; the
Prometheus exposition has the same families; every request's flight
spans and marks carry the same names in the same order, the engine
track the same tick names, and a dumped trace validates with every TTFT
tiled; the watchdog's compile events have the reference's sites, groups,
keys and buckets. Besides (the port of tests/test_obs.py:362-545):
stats() is the thin view over the registry, TTFT = queue wait +
prefill, 20 steady ticks after warmup record no compile, a capture
forced after warmup is a warm compile event, and engines share one
/metrics endpoint with /healthz a readiness probe.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import obs as ref_obs
from paddle_tpu.inference import engine as ref_engine
from paddle_tpu.text.models import LlamaConfig as RLConfig
from paddle_tpu.text.models import LlamaForCausalLM as RLlama
from paddle_tpu.text.models.gpt import GPTConfig as RGConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as RGPT

from paddle_tpu_torch import obs
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch.inference.engine import ServingEngine
from paddle_tpu_torch.text.models import (GPTConfig, LlamaConfig,
                                          gpt_from_numpy, llama_from_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

_LLAMA = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=64)
_GPT = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64)
_PAIRS: dict = {}


def _pair(arch):
    """The same tiny model in both packages, built once per module."""
    if arch not in _PAIRS:
        paddle.seed(0)
        if arch == "llama":
            ref = RLlama(RLConfig(**_LLAMA))
            conv = lambda st: llama_from_numpy(  # noqa: E731
                LlamaConfig(**_LLAMA), st, device="cpu")
        else:
            ref = RGPT(RGConfig(**_GPT))
            conv = lambda st: gpt_from_numpy(  # noqa: E731
                GPTConfig(**_GPT), st, device="cpu")
        ref.eval()
        state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
        _PAIRS[arch] = (ref, conv(state))
    return _PAIRS[arch]


def _stream(arch):
    """(engine kwargs, [(prompt, max_new_tokens)]) of each arch's run."""
    rs = np.random.RandomState(4)
    if arch == "llama":
        big = rs.randint(0, 128, (30,))
        return (dict(max_slots=2, kv_block_size=8, num_kv_blocks=7,
                     chunked_prefill_tokens=8),
                [(big, 8), (rs.randint(0, 128, (4,)), 4),
                 (rs.randint(0, 128, (12,)), 3), (big, 2)])
    motif = [np.tile(rs.randint(0, 96, (4,)), 5) for _ in range(3)]
    return (dict(max_slots=2, kv_block_size=8, spec_decode="ngram"),
            [(m, 12) for m in motif])


_RUNS: dict = {}


def _runs(arch):
    """Both engines after the same stream, run once per module, with the
    compile events each recorded from a clean window."""
    if arch not in _RUNS:
        ref, port = _pair(arch)
        kw, reqs = _stream(arch)
        saved = set(ref_engine._SEEN_SERVING_PROGRAMS)
        ref_engine._SEEN_SERVING_PROGRAMS.clear()
        ref_obs.clear_events()
        obs.clear_events()
        try:
            a = ref_engine.ServingEngine(ref, **kw)
            b = ServingEngine(port, device="cpu", **kw)
            for p, n in reqs:
                a.add_request(p, max_new_tokens=n)
                b.add_request(p, max_new_tokens=n)
            want, got = a.run(), b.run()
            events = (ref_obs.compile_events(), obs.compile_events())
        finally:
            ref_engine._SEEN_SERVING_PROGRAMS.update(saved)
            ref_obs.clear_events()
            obs.clear_events()
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])
        _RUNS[arch] = (a, b, events)
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_serving_families_and_values_equal_reference(arch):
    a, b, _ = _runs(arch)
    ra, rb = a.registry, b.registry
    fams = [n for n in ra.names() if n.startswith("serving_")]
    assert len(fams) == 32
    assert rb.names() == ra.names()
    sa, sb = a.metrics(), b.metrics()
    for name in fams:
        ma, mb = ra.get(name), rb.get(name)
        assert (mb.kind, mb.labelnames, mb.doc) \
            == (ma.kind, ma.labelnames, ma.doc), name
        rows_a, rows_b = sa[name]["samples"], sb[name]["samples"]
        assert [r.get("labels") for r in rows_b] \
            == [r.get("labels") for r in rows_a], name
        for x, y in zip(rows_a, rows_b):
            key = "count" if ma.kind == "histogram" else "value"
            assert y[key] == x[key], (name, x, y)
    if arch == "llama":
        assert sb["serving_admission_blocked_total"]["samples"][0][
            "value"] >= 1
        assert sb["serving_prefix_blocks_hit_total"]["samples"][0][
            "value"] >= 1
    else:
        assert sb["serving_spec_windows_total"]["samples"][0]["value"] > 0
    from graft_lint import (MUST_COUNT_SERVING_METRICS,
                            REQUIRED_SERVING_METRICS)

    assert not [m for m in REQUIRED_SERVING_METRICS if m not in sb]
    for m in MUST_COUNT_SERVING_METRICS:
        assert any(s.get("count") or s.get("value")
                   for s in sb[m]["samples"]), m


@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_exposition_has_the_reference_families(arch):
    a, b, _ = _runs(arch)
    ta, tb = a.render_prometheus(), b.render_prometheus()
    heads = [ln for ln in tb.splitlines() if ln.startswith("#")]
    assert heads == [ln for ln in ta.splitlines() if ln.startswith("#")]
    assert "# TYPE paddle_tpu_serving_ttft_seconds histogram" in heads
    samples = {ln.split("{")[0].split(" ")[0] for ln in tb.splitlines()
               if not ln.startswith("#")}
    assert samples == {ln.split("{")[0].split(" ")[0]
                       for ln in ta.splitlines() if not ln.startswith("#")}


@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_flight_spans_equal_reference_and_tile(arch, tmp_path):
    a, b, _ = _runs(arch)
    fa, fb = a.flight.flights(), b.flight.flights()
    assert [f.rid for f in fb] == [f.rid for f in fa]
    for x, y in zip(fa, fb):
        assert [s[0] for s in y.spans] == [s[0] for s in x.spans], x.rid
        assert [m[0] for m in y.marks] == [m[0] for m in x.marks], x.rid
        for f in ("tokens", "chunks", "blocked_ticks", "cached_blocks",
                  "cow", "reason"):
            assert getattr(y, f) == getattr(x, f), (x.rid, f)
    assert [t[0] for t in b.flight._ticks] \
        == [t[0] for t in a.flight._ticks]
    path = str(tmp_path / "trace.json")
    assert b.dump_trace(path) == path
    summary = obs.validate_trace(path)
    assert summary["requests"] == summary["tiled_requests"] == len(fb)
    assert summary == ref_obs.validate_trace(a.flight.to_chrome())


@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_compile_events_equal_reference(arch):
    _, b, (ev_a, ev_b) = _runs(arch)

    def rows(evs):
        return sorted((e.site, e.group, e.key, str(e.bucket), e.warm)
                      for e in evs if e.site.startswith("serving"))

    assert rows(ev_b) == rows(ev_a) and rows(ev_b)
    assert len(rows(ev_b)) == len(b._programs)
    # each event carries its program's counted cost (obs/costs.py), as
    # the reference's carries XLA's analysis
    assert all(e.cost is not None and e.cost["bytes_accessed"] > 0
               and e.cost["flops"] > 0 and e.wall_s > 0 for e in ev_b)
    assert all(e.cost is not None for e in ev_a
               if e.site.startswith("serving"))


def test_stats_is_the_view_and_ttft_decomposes():
    _, b, _ = _runs("llama")
    snap, st = b.metrics(), b.stats()
    assert st["decode_tokens"] == int(
        snap["serving_decode_tokens_total"]["samples"][0]["value"])
    assert st["admission_blocked"] >= 1
    assert st["queue_wait_s"][1] > st["queue_wait_s"][0]
    tt = snap["serving_ttft_seconds"]["samples"][0]
    pf = snap["serving_prefill_seconds"]["samples"][0]
    qw = snap["serving_queue_wait_seconds"]["samples"][0]
    assert tt["sum"] == pytest.approx(pf["sum"] + qw["sum"], rel=1e-9)
    assert st["prefill_time_s"] == pf["sum"]


def _tiny_engine(**kw):
    return ServingEngine(_pair("llama")[1], device="cpu", **kw)


def test_zero_compiles_in_20_steady_steps_after_warmup():
    eng = _tiny_engine(max_slots=2)
    rs = np.random.RandomState(0)
    for ln, nt in ((3, 2), (6, 3)):
        eng.add_request(rs.randint(0, 128, (ln,)), max_new_tokens=nt)
    eng.run()
    eng.finish_warmup()
    obs.clear_events()
    for ln, nt in ((4, 25), (5, 22)):
        eng.add_request(rs.randint(0, 128, (ln,)), max_new_tokens=nt)
    steps = 0
    while eng.has_work() and steps < 30:
        eng.step()
        steps += 1
    assert steps >= 20
    assert [e for e in obs.compile_events()
            if e.site.startswith("serving")] == []
    assert obs.post_warmup_compiles() == 0
    assert eng._graph_stats()["captures_after_warmup"] == 0


def test_post_warmup_capture_forced_is_a_warm_compile():
    """Programs dropped after finish_warmup() are built again on the next
    call: warm compile events, a post-warmup-compile finding, the
    anomaly counted."""
    eng = _tiny_engine(max_slots=2)
    rs = np.random.RandomState(1)
    eng.add_request(rs.randint(0, 128, (3,)), max_new_tokens=2)
    eng.run()
    eng.finish_warmup()
    obs.clear_events()
    eng._programs.clear()
    try:
        eng.add_request(rs.randint(0, 128, (3,)), max_new_tokens=2)
        eng.run()
        warm = [e for e in obs.compile_events() if e.warm]
        assert warm and obs.post_warmup_compiles() == len(warm)
        assert any(f.detector == "post-warmup-compile"
                   and f.severity == "warning"
                   for f in obs.audit_recompiles())
    finally:
        obs.clear_events()
    snap = eng.metrics()["serving_flight_anomalies_total"]["samples"]
    assert [s["labels"] for s in snap] == [{"trigger": "post_warmup_compile"}]
    assert snap[0]["value"] == len(warm)


def test_admission_rejects_counted_by_reason():
    eng = _tiny_engine(max_slots=1, kv_block_size=8)
    for bad, reason in (([], "empty_prompt"),
                        (np.arange(70) % 128, "context_overflow")):
        with pytest.raises(ValueError):
            eng.add_request(bad, max_new_tokens=2)
    with pytest.raises(ValueError):
        eng.add_request([1, 2], max_new_tokens=0)
    eng.drain()
    with pytest.raises(ValueError, match="draining"):
        eng.add_request([1, 2], max_new_tokens=2)
    rows = eng.metrics()["serving_admission_rejects_total"]["samples"]
    assert {r["labels"]["reason"]: r["value"] for r in rows} == {
        "bad_max_new_tokens": 1, "context_overflow": 1, "draining": 1,
        "empty_prompt": 1}


def _free_port():
    probe = obs.serve_metrics(0, obs.Registry())
    port = probe.port
    probe.close()
    return port


def _get(url):
    with urllib.request.urlopen(url) as resp:
        return resp.status, resp.read().decode()


def test_http_metrics_endpoint():
    reg = obs.Registry("pt")
    reg.counter("up_total", "").inc()
    srv = obs.serve_metrics(0, reg)
    try:
        code, body = _get(f"http://127.0.0.1:{srv.port}/metrics")
        assert code == 200 and "pt_up_total 1" in body
        assert _get(f"http://127.0.0.1:{srv.port}/healthz") == (200, "ok\n")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://127.0.0.1:{srv.port}/nope")
        assert ei.value.code == 404
    finally:
        srv.close()
        srv.close()                     # idempotent


def test_engines_share_one_http_port():
    """FLAGS_obs_http_port names one port: every engine registers on the
    shared endpoint, /metrics serves each under its engine label (a
    LLaMA and a GPT engine here), /healthz is 503 until every engine
    passed finish_warmup and answers per engine; close() detaches."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    port_flags.set_flags({"FLAGS_obs_http_port": port})
    try:
        e1 = _tiny_engine(max_slots=1)
        e2 = ServingEngine(_pair("gpt")[1], max_slots=1, device="cpu")
    finally:
        port_flags.set_flags({"FLAGS_obs_http_port": 0})
    srv = e1._metrics_server
    try:
        assert srv is e2._metrics_server and srv is obs.shared_server(port)
        assert srv.engines() == sorted([e1._engine_name, e2._engine_name])
        e2.add_request([1, 2, 3], max_new_tokens=2)
        e2.run()
        _, body = _get(f"{url}/metrics")
        for e in (e1, e2):
            assert f'paddle_tpu_serving_slots{{engine="{e._engine_name}"}} 1' \
                in body
        assert (f'paddle_tpu_serving_decode_tokens_total{{engine="'
                f'{e2._engine_name}"}} 1') in body
        assert body.count("# TYPE paddle_tpu_serving_slots gauge") == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{url}/healthz")
        assert ei.value.code == 503
        e1.finish_warmup()
        assert _get(f"{url}/healthz?engine={e1._engine_name}") \
            == (200, "ready\n")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{url}/healthz?engine={e2._engine_name}")
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{url}/healthz?engine=nope")
        assert ei.value.code == 404
        e2.finish_warmup()
        assert _get(f"{url}/healthz") == (200, "ready\n")
        e2.close()
        e2.close()
        assert srv.engines() == [e1._engine_name]
        assert e2._engine_name not in _get(f"{url}/metrics")[1]
    finally:
        e1.close()
        srv.close()
