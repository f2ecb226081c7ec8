"""Compile watchdog — every program build becomes an event, and
pathological build behaviour becomes a Finding.

Port of paddle_tpu/obs/watchdog.py. In the port a compile is a program
key's first call: on a card that call is the CUDA-graph capture (its
wall the capture's: dry run, capture, instantiation), on the CPU the
eager first call. The sites that report here:

  * ``text/generation.py``     static-engine programs (site "generate")
  * ``inference/engine.py``    serving programs ("serving.prefill",
                               "serving.decode", "serving.chunk_prefill",
                               "serving.spec_verify") and the draft
                               model's ("serving.spec_draft_prefill",
                               "serving.spec_draft_propose")

  * ``jit/api.py``             ``to_static`` specializations (site
                               "to_static")

Each event carries the program key, its bucket, wall time, donation
summary and cost (flops / bytes accessed / peak bytes, counted at the
program's eager run before capture by ``obs/costs.py``), increments
``compiles_total{site=...}`` / ``compile_seconds`` in the default
registry plus the JSONL log, and, while an instrumented fit runs, books
its wall as the goodput ledger's ``compile`` seconds.
``audit_recompiles()`` turns the event history into
``analysis.Finding``s:

  * RECOMPILE STORM — one (site, group) accumulated more than
    ``FLAGS_obs_compile_storm_threshold`` distinct program keys, or any
    single key compiled more than once (a program cache losing entries
    mid-run).
  * POST-WARMUP COMPILE — any compile recorded after a ServingEngine
    declared warmup complete (``finish_warmup()``): a steady-state
    serving tick must never capture.

Checkpoint saves report here too (``record_ckpt_save`` from
``ckpt/core.py``): ``audit_ckpt_stalls()`` warns on a save past
``FLAGS_ckpt_stall_seconds`` or one that failed, and such a save dumps
the training flight recorder's ring (the ``ckpt_stall`` anomaly).
"""
from __future__ import annotations

import time
from collections import deque

from ..core.flags import flag

#: bounded event history (a process compiling >4096 programs has worse
#: problems than a truncated audit window). Appends/counter bumps rely
#: on the GIL like the metrics hot path: no lock.
_EVENT_CAP = 4096
# thread-safe: GIL-atomic bounded-deque appends; readers take list()
# snapshots and clear_events is a test/bench barrier run with no recorder
_events: deque = deque(maxlen=_EVENT_CAP)

#: compiles tagged warm=True by their site (the serving engine tags any
#: compile after its finish_warmup() barrier) — steady-state retraces.
# thread-safe: GIL-atomic int bump mirroring post_warmup_compiles_total;
# the per-event warm flag drives the audit, a lost bump is a lost metric
_post_warmup_total = 0


class CompileEvent:
    """One compile/retrace, as recorded at the site."""

    __slots__ = ("site", "group", "key", "bucket", "wall_s", "jaxpr_eqns",
                 "donated", "warm", "cost", "t")

    def __init__(self, site, group, key, bucket=None, wall_s=0.0,
                 jaxpr_eqns=None, donated=None, warm=False, cost=None):
        self.site = str(site)
        self.group = str(group)      # program FAMILY (fn/model), storms
        self.key = str(key)          # exact specialization key
        self.bucket = bucket
        self.wall_s = float(wall_s)
        self.jaxpr_eqns = jaxpr_eqns
        self.donated = donated
        self.warm = bool(warm)
        # the cost summary (obs/costs.py: flops / bytes accessed / peak
        # bytes) where the site counted one, else None
        self.cost = cost
        self.t = time.time()

    def to_dict(self) -> dict:
        return {"site": self.site, "group": self.group, "key": self.key,
                "bucket": self.bucket, "wall_s": round(self.wall_s, 4),
                "jaxpr_eqns": self.jaxpr_eqns, "donated": self.donated,
                "warm": self.warm, "cost": self.cost, "t": self.t}


def record_compile(site: str, group: str, key: str, bucket=None,
                   wall_s: float = 0.0, jaxpr_eqns=None, donated=None,
                   warm: bool = False, cost=None) -> CompileEvent:
    """Record one compile. Cheap (an append + two counter bumps) and only
    reached on a program key's first call, so the steady-state hot paths
    never pay it."""
    from . import default_registry, metrics

    ev = CompileEvent(site, group, key, bucket=bucket, wall_s=wall_s,
                      jaxpr_eqns=jaxpr_eqns, donated=donated, warm=warm,
                      cost=cost)
    _events.append(ev)
    reg = default_registry()
    reg.counter("compiles_total", "compiled programs (any site)",
                ("site",)).labels(site).inc()
    reg.counter("compile_seconds", "wall seconds spent compiling/tracing",
                ("site",)).labels(site).inc(max(ev.wall_s, 0.0))
    if warm:
        global _post_warmup_total
        _post_warmup_total += 1
        reg.counter("post_warmup_compiles_total",
                    "compiles recorded after a serving warmup barrier",
                    ("site",)).labels(site).inc()
    metrics.log_event("compile", **ev.to_dict())
    # a compile wall paid while a fit is instrumented is non-productive
    # training time (no-op otherwise)
    from .goodput import note_compile

    note_compile(ev.wall_s)
    return ev


def compile_events(site: str | None = None) -> list[CompileEvent]:
    evs = list(_events)
    if site is not None:
        evs = [e for e in evs if e.site == site]
    return evs


def compile_counts() -> dict:
    """{site: count} over the current event window."""
    out: dict[str, int] = {}
    for e in _events:
        out[e.site] = out.get(e.site, 0) + 1
    return out


def post_warmup_compiles() -> int:
    return _post_warmup_total


def clear_events():
    """Reset the window (tests, and measurements that want their own
    counts)."""
    global _post_warmup_total
    _events.clear()
    _post_warmup_total = 0
    _ckpt_events.clear()


# ------------------------------------------------------- ckpt watchdog
#: checkpoint save events — same bounded-window design as the compile
#: events; ckpt/core.py reports every save outcome here, including from
#: the AsyncCheckpointer commit thread.
# thread-safe: GIL-atomic bounded-deque appends; audits read a snapshot
_ckpt_events: deque = deque(maxlen=_EVENT_CAP)


def record_ckpt_save(step: int, wall_s: float, nbytes: int, result: str,
                     attempts: int = 1) -> dict:
    """One checkpoint-save outcome (ok / retry_ok / error). Counters
    live in the default registry (``ckpt_saves_total{result}`` etc.,
    recorded by ckpt/core); this window feeds ``audit_ckpt_stalls``."""
    from . import metrics

    ev = {"step": int(step), "wall_s": float(wall_s),
          "bytes": int(nbytes), "result": str(result),
          "attempts": int(attempts), "t": time.time()}
    _ckpt_events.append(ev)
    metrics.log_event("ckpt_save", **ev)
    # ckpt-stall postmortem: a save blowing its wall budget (or failing
    # outright) while a training flight recorder is active dumps the
    # last N step timelines — the trace of the stall
    if wall_s > float(flag("FLAGS_ckpt_stall_seconds")) \
            or result == "error":
        from .train_flight import current as _tf_current

        rec = _tf_current()
        if rec is not None:
            rec.anomaly("ckpt_stall")
    return ev


def ckpt_save_events() -> list:
    return list(_ckpt_events)


def audit_ckpt_stalls(events=None, threshold: float | None = None,
                      loc: str = "obs/ckpt") -> list:
    """Checkpoint-save health Findings over the event window: a save
    exceeding ``FLAGS_ckpt_stall_seconds`` wall (the checkpoint path is
    blocking training far longer than budgeted) or a save that exhausted
    its retries is a warning; a healthy window is a note."""
    from ..analysis import Finding

    if events is None:
        events = ckpt_save_events()
    if threshold is None:
        threshold = float(flag("FLAGS_ckpt_stall_seconds"))
    findings: list = []
    stalls = [e for e in events if e["wall_s"] > threshold]
    failures = [e for e in events if e["result"] == "error"]
    if stalls:
        worst = max(e["wall_s"] for e in stalls)
        findings.append(Finding(
            "ckpt-stall", "warning", loc,
            f"{len(stalls)} checkpoint save(s) exceeded "
            f"FLAGS_ckpt_stall_seconds={threshold:g} (worst {worst:.1f}s) "
            "— saves are blocking training; shrink the state, raise "
            "max_in_flight, or fix the filesystem",
            data={"threshold": threshold, "stalls": stalls[:8]}))
    if failures:
        findings.append(Finding(
            "ckpt-stall", "warning", loc,
            f"{len(failures)} checkpoint save(s) FAILED after retries — "
            "a preemption now loses everything since the last good "
            "checkpoint",
            data={"failures": failures[:8]}))
    if not stalls and not failures:
        findings.append(Finding(
            "ckpt-stall", "note", loc,
            f"{len(events)} checkpoint save(s), none stalled past "
            f"{threshold:g}s, none failed",
            data={"count": len(events), "threshold": threshold}))
    return findings


def jaxpr_size(graph) -> int:
    """The program size a compile event records where the site has a
    graph in hand: the node count of a ``torch.fx`` Graph or GraphModule,
    sub-modules' graphs included (the reference counts a jaxpr's eqns,
    sub-jaxprs included)."""
    g = getattr(graph, "graph", graph)
    n = sum(1 for _ in g.nodes)
    if hasattr(graph, "named_children"):
        n += sum(jaxpr_size(m) for _, m in graph.named_children()
                 if hasattr(m, "graph"))
    return n


# ---------------------------------------------------------------- audit
def audit_recompiles(events=None, threshold: int | None = None,
                     loc: str = "obs/watchdog") -> list:
    """Recompile-storm + post-warmup-compile Findings over the event
    window: notes for healthy sites, warnings for the two failure
    shapes."""
    from ..analysis import Finding

    if events is None:
        events = compile_events()
    if threshold is None:
        threshold = int(flag("FLAGS_obs_compile_storm_threshold"))
    findings: list = []

    groups: dict[tuple, list] = {}
    for e in events:
        groups.setdefault((e.site, e.group), []).append(e)
    for (site, group), evs in sorted(groups.items()):
        keys: dict[str, int] = {}
        for e in evs:
            keys[e.key] = keys.get(e.key, 0) + 1
        distinct = len(keys)
        repeats = {k: n for k, n in keys.items() if n > 1}
        # the eager cache specializes per (statics, diff-mask) BY DESIGN —
        # distinct-key growth there is normal; only a re-BUILD of the
        # same key (eviction thrash) is pathological
        if distinct > threshold and site != "eager":
            findings.append(Finding(
                "recompile-storm", "warning", f"{loc}:{site}/{group}",
                f"{distinct} distinct programs compiled for one family "
                f"(threshold {threshold}) — lengths/shapes are not "
                f"bucketing (exact-length keying); keys: "
                f"{sorted(keys)[:6]}{'...' if distinct > 6 else ''}",
                data={"site": site, "group": group, "distinct": distinct,
                      "threshold": threshold,
                      "total_compiles": len(evs)}))
        elif repeats:
            worst = max(repeats.values())
            findings.append(Finding(
                "recompile-storm", "warning", f"{loc}:{site}/{group}",
                f"same program key compiled {worst}x (cache thrash: the "
                f"program cache is losing entries mid-run); "
                f"{len(repeats)} key(s) affected",
                data={"site": site, "group": group, "repeats": repeats,
                      "total_compiles": len(evs)}))
        else:
            findings.append(Finding(
                "recompile-storm", "note", f"{loc}:{site}/{group}",
                f"{distinct} program(s), no retraces",
                data={"site": site, "group": group, "distinct": distinct}))

    warm = [e for e in events if e.warm]
    if warm:
        sites = sorted({f"{e.site}/{e.group}" for e in warm})
        findings.append(Finding(
            "post-warmup-compile", "warning", loc,
            f"{len(warm)} compile(s) recorded AFTER serving warmup "
            f"completed — steady-state ticks are retracing ({sites}); "
            f"every serving bucket must compile during warmup",
            data={"count": len(warm),
                  "events": [e.to_dict() for e in warm[:8]]}))
    return findings
