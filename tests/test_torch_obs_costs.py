"""The port's program cost ledger held to paddle_tpu's on the CPU.

`ProgramCost`'s math, the `roofline_utilization{program}` gauge and
`audit_cost_regressions` (D8) through both packages from the same stub
costs (the reference's from a stub compiled object, as
tests/test_flight.py:275 makes it; the port's the same numbers as a cost
dict): rows, gauge values and Findings equal. The baseline file round
trip. Then the port's cost source, one eager run under `extract_cost`:
a known matmul, a tiny `to_static` train step whose flops lie within 2%
of a hand count of its matmuls (on the CPU the kernels' plain versions
run and count as aten ops), the flash forward's dispatcher op counted
through its body, and the compile sites that leave analyzed rows: tiny
LLaMA and GPT serving engines (prefill, chunk and decode, observed
walls, rows that survive `clear_ledger` while their programs live), the
static `generate` and a tiny LLaMA `to_static` step, each with its
compile event carrying the row's cost.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu import obs as ref_obs
from paddle_tpu.obs import costs as ref_costs

import paddle_tpu_torch as pt
from paddle_tpu_torch import obs
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.obs import costs
from paddle_tpu_torch.text.models import (GPTConfig, GPTForCausalLM,
                                          LlamaForCausalLM,
                                          llama_tiny_config)


def _stub_compiled(flops=1000.0, bytes_accessed=2000.0, arg=100, out=50,
                   temp=25, alias=0):
    return SimpleNamespace(
        cost_analysis=lambda: [{"flops": flops,
                                "bytes accessed": bytes_accessed}],
        memory_analysis=lambda: SimpleNamespace(
            argument_size_in_bytes=arg, output_size_in_bytes=out,
            temp_size_in_bytes=temp, alias_size_in_bytes=alias))


def _stub_cost(flops=1000.0, bytes_accessed=2000.0, arg=100, out=50,
               temp=25):
    """The port's cost dict of the same program."""
    return {"flops": flops, "bytes_accessed": bytes_accessed,
            "arg_bytes": arg, "out_bytes": out, "temp_bytes": temp,
            "peak_hbm_bytes": arg + out + temp}


def _both(site, key, **kw):
    """(reference row, port row) of one program from the same costs."""
    r = ref_costs.record_program(site, "g", key,
                                 compiled=_stub_compiled(**kw))
    p = costs.record_program(site, "g", key, cost=_stub_cost(**kw))
    return r, p


def _row(e):
    d = e.to_dict()
    d.pop("compile_wall_s")
    return d


def test_rows_and_gauge_equal_the_reference():
    r, p = _both("tcost.a", "k1")
    assert _row(p) == _row(r)
    ur, up = r.observe(wall_s=0.001), p.observe(wall_s=0.001)
    assert up == ur == pytest.approx(2000.0 / (0.001 * 25.0 * 1e9))
    assert _row(p) == _row(r)
    g = obs.default_registry().get("roofline_utilization")
    rg = ref_obs.default_registry().get("roofline_utilization")
    assert dict(g.samples())[("tcost.a|k1",)].value == \
        dict(rg.samples())[("tcost.a|k1",)].value
    assert (g.doc, g.labelnames) == (rg.doc, rg.labelnames)
    assert p.achieved_gbps() == r.achieved_gbps()
    assert p.utilization() == r.utilization()
    assert p.predicted() == r.predicted()


def test_record_idempotent_and_reset():
    e1 = costs.record_program("tcost.b", "g", "k1", cost=_stub_cost())
    e2 = costs.record_program("tcost.b", "g", "k1")
    assert e1 is e2 and e1.analyzed
    e1.observe(0.01)
    assert e1.exec_count == 1
    obs.reset_exec_stats()
    assert e1.exec_count == 0 and e1.analyzed
    assert costs.record_program("tcost.b", "g", "none").analyzed is False
    assert costs.get_program("tcost.b", "k1") is e1


@pytest.mark.parametrize("case", ["grown", "within", "missing_new",
                                  "shrunk"])
def test_audit_cost_regressions_equals_reference(case):
    now = {"grown": 1500.0, "within": 1100.0, "missing_new": 500.0,
           "shrunk": 800.0}[case]
    r, p = _both("tcost.d8", f"{case}", bytes_accessed=now)
    base = {"threshold_pct": 25.0,
            "programs": {r.program: {"bytes_accessed": 1000.0}}}
    if case == "missing_new":
        base["programs"] = {"tcost.d8|ghost": {"bytes_accessed": 1000.0}}
    got = [f.to_dict() for f in obs.audit_cost_regressions(
        base, entries=[p])]
    want = [f.to_dict() for f in ref_obs.audit_cost_regressions(
        base, entries=[r])]
    assert got == want
    warn = [f for f in got if f["severity"] == "warning"]
    assert len(warn) == (1 if case == "grown" else 0)


def test_write_load_baseline_round_trip(tmp_path):
    costs.record_program("serving.tcost", "g", "kk",
                         cost=_stub_cost(bytes_accessed=4321.0))
    path = str(tmp_path / "base.json")
    base = obs.write_baseline(path, site="serving.tcost")
    again = costs.load_baseline(path)
    assert again["programs"] == base["programs"]
    assert again["programs"]["serving.tcost|kk"] == {
        "bytes_accessed": 4321.0, "flops": 1000.0, "peak_hbm_bytes": 175}
    fs = obs.audit_cost_regressions(path, entries=obs.ledger(
        "serving.tcost"))
    assert {f.severity for f in fs} == {"note"}


def test_public_names_are_the_reference():
    names = {"ProgramCost", "record_program", "reregister", "get_program",
             "ledger", "clear_ledger", "reset_exec_stats", "roofline_rows",
             "write_baseline", "load_baseline", "audit_cost_regressions",
             "extract_cost", "peak_gbps"}
    for n in names:
        assert hasattr(costs, n) and hasattr(ref_costs, n), n


# ------------------------------------------------------ the cost source
def test_extract_cost_counts_a_matmul():
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    cost, out = costs.extract_cost(lambda: a @ b, args=(a, b))
    assert out.shape == (4, 3)
    assert cost["flops"] == 2 * 4 * 8 * 3
    assert cost["bytes_accessed"] == 4 * (4 * 8 + 8 * 3 + 4 * 3)
    assert cost["arg_bytes"] == 4 * (32 + 24) and cost["out_bytes"] == 48
    assert cost["peak_hbm_bytes"] == cost["arg_bytes"] + cost["out_bytes"]
    old = flag("FLAGS_obs_cost_capture")
    set_flags({"FLAGS_obs_cost_capture": False})
    try:
        assert costs.extract_cost(lambda: a @ b)[0] is None
    finally:
        set_flags({"FLAGS_obs_cost_capture": old})


def test_views_and_allocations_move_no_bytes():
    a = torch.randn(16, 16)

    def run():
        view = a.t().unsqueeze(0)[:, :8].expand(2, 8, 16)
        return view, torch.empty(1000)

    cost, _ = costs.extract_cost(run)
    assert cost["bytes_accessed"] == 0 and cost["flops"] == 0


def test_flash_op_counts_through_its_body():
    """The flash forward's dispatcher op (kept by the recompute policy)
    is counted by its body: on the CPU the plain version's two matmuls."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd_op

    q, k, v = (torch.randn(1, 2, 8, 16) for _ in range(3))
    cost, _ = costs.extract_cost(
        lambda: flash_attention_fwd_op(q, k, v, True))
    assert cost["flops"] == 2 * (2 * 1 * 2 * 8 * 8 * 16)


def test_to_static_step_flops_match_a_hand_count():
    pt.set_device("cpu")
    pt.seed(0)
    b, i, h, o = 8, 32, 64, 16
    net = pt.nn.Sequential(pt.nn.Linear(i, h), pt.nn.ReLU(),
                           pt.nn.Linear(h, o))
    opt = pt.optimizer.SGD(learning_rate=1e-3, parameters=net.parameters())
    loss_fn = pt.nn.MSELoss()

    @pt.jit.to_static
    def mlp_step(x, y):
        loss = loss_fn(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    rs = np.random.RandomState(0)
    x = pt.to_tensor(rs.randn(b, i).astype("float32"))
    y = pt.to_tensor(rs.randn(b, o).astype("float32"))
    obs.clear_events()
    for _ in range(4):
        mlp_step(x, y)
    # forward 2·b·i·h + 2·b·h·o; backward dW of both layers and dX of the
    # second (x takes no gradient)
    hand = 2 * b * i * h * 2 + 2 * b * h * o * 3
    rows = [e for e in obs.ledger("to_static") if e.group == "mlp_step"]
    assert len(rows) == 1 and rows[0].analyzed
    assert abs(rows[0].flops - hand) <= 0.02 * hand, (rows[0].flops, hand)
    assert rows[0].bytes_accessed > 0 and rows[0].peak_hbm_bytes > 0
    ev = obs.compile_events("to_static")
    assert len(ev) == 1 and ev[0].cost["flops"] == rows[0].flops


# -------------------------------------------------------- compile sites
def _tiny_llama():
    torch.manual_seed(0)
    return LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2),
                            device="cpu")


def _tiny_gpt():
    torch.manual_seed(0)
    return GPTForCausalLM(GPTConfig(vocab_size=96, hidden_size=32,
                                    num_hidden_layers=2,
                                    num_attention_heads=4,
                                    max_position_embeddings=64),
                          device="cpu")


def _drive(eng, vocab):
    rs = np.random.RandomState(3)
    for ln, nt in ((3, 4), (20, 3), (2, 5)):
        eng.add_request(rs.randint(0, vocab, (ln,)), max_new_tokens=nt)
    return eng.run()


@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_engine_populates_ledger(arch):
    m, vocab = (_tiny_llama(), 256) if arch == "llama" else (_tiny_gpt(),
                                                              96)
    costs.clear_ledger()
    obs.clear_events()
    eng = ServingEngine(m, max_slots=2, kv_block_size=8, device="cpu",
                        chunked_prefill_tokens=8)
    _drive(eng, vocab)
    rows = obs.ledger("serving")
    sites = {e.site for e in rows}
    assert {"serving.decode", "serving.chunk_prefill"} <= sites, sites
    for e in rows:
        assert e.analyzed and e.bytes_accessed > 0 and e.flops > 0, e.program
        assert e.exec_count > 0 and e.utilization() is not None
    json.dumps(obs.roofline_rows("serving"))
    ev = {(e.site, e.key): e.cost for e in obs.compile_events()
          if e.site.startswith("serving")}
    for e in rows:
        # a row's key is the event's and the model's geometry
        event_key = e.key.rsplit("/spec", 1)[0]
        assert ev[(e.site, event_key)] == e.cost_summary()
    # programs outlive the ledger: a cleared ledger gets their rows back
    costs.clear_ledger()
    _drive(eng, vocab)
    dec = [e for e in obs.ledger("serving.decode") if e.exec_count > 0]
    assert dec and all(e.analyzed for e in dec)


def test_prefill_program_row():
    costs.clear_ledger()
    eng = ServingEngine(_tiny_llama(), max_slots=2, kv_block_size=8,
                        device="cpu", chunked_prefill_tokens=0,
                        prefix_cache=False)
    _drive(eng, 256)
    pre = obs.ledger("serving.prefill")
    assert pre and all(e.analyzed and e.exec_count > 0 for e in pre)


def test_generate_site_captures_costs():
    m = _tiny_llama()
    ids = np.random.RandomState(3).randint(0, 256, (1, 5))
    costs.clear_ledger()
    m.generate(torch.from_numpy(ids), max_new_tokens=3)
    m.generate(torch.from_numpy(ids), max_new_tokens=3)
    gen = [e for e in obs.ledger("generate") if e.exec_count > 0]
    assert len(gen) == 1 and gen[0].analyzed and gen[0].exec_count == 2
    assert gen[0].flops > 0 and gen[0].bytes_accessed > 0


def test_llama_to_static_step_leaves_an_analyzed_row():
    m = _tiny_llama()
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())

    @pt.jit.to_static
    def llama_step(x):
        loss = m(x, labels=x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    x = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 17)))
    for _ in range(3):
        llama_step(x)
    rows = [e for e in obs.ledger("to_static") if e.group == "llama_step"]
    assert rows and rows[0].analyzed and rows[0].flops > 0
    cfg = m.config
    # at least the forward and weight-gradient matmuls of every
    # projection (the head included): 4 flops a parameter and token
    proj = cfg.num_hidden_layers * (
        2 * cfg.hidden_size * cfg.hidden_size
        + 2 * cfg.hidden_size * cfg.num_key_value_heads
        * (cfg.hidden_size // cfg.num_attention_heads)
        + 3 * cfg.hidden_size * cfg.intermediate_size) \
        + cfg.hidden_size * cfg.vocab_size
    assert rows[0].flops >= 4 * proj * x.numel()
