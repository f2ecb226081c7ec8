"""Program cost attribution — the ledger that joins each program's flops
and bytes with its measured walls into a roofline utilization.

Port of paddle_tpu/obs/costs.py, with the reference's names, rows,
gauge, baseline file and D8 audit. The reference reads XLA's
``cost_analysis()`` / ``memory_analysis()`` from each AOT-compiled
program. A CUDA graph carries no such analysis, so the port counts the
cost of **one eager run of the program body** (``extract_cost``), where
the body already runs eagerly once before it is captured: `to_static`'s
discovery call and the serving and static-generate programs' dry run.
Nothing is counted at a replay.

  * aten ops: flops by ``torch.utils.flop_counter``'s registered
    formulas (the matmuls, convolutions and attention ops); bytes as the
    op's tensor operands read plus its results written (XLA's "bytes
    accessed"). Views, aliases and the ``empty`` family move nothing; an
    indexed read (embedding, index, gather) or an indexed write in place
    (index_put_, index_copy_, scatter_: a KV cache append) counts the
    rows it touches, not its whole source or destination.
  * hand-written kernels: their ctypes launches are invisible to the
    dispatcher, so each wrapper reports its launch through
    ``ops._cuda_common.count_launch(name, reads, writes, flops)``: flops
    by the kernel's own formula, bytes from the tensors it reads and
    writes (the paged decode: the cache blocks its tables can address).
    On the CPU the kernels' plain versions run and count as aten ops.
  * ``peak_hbm_bytes``: on a card the largest allocated bytes sampled
    every ``SAMPLE_EVERY`` ops and kernel launches of the run (and at its
    end); on the CPU the arguments plus the outputs.

A program is counted once a process: a site whose program id already has
an analyzed row (another engine's program of the same key) skips the
count (``needs_count``), as the reference's module-level executable
cache compiles and analyzes a key once.

Combining the static bytes with measured wall time per execution yields
the roofline story per program:

    achieved GB/s = bytes_accessed * executions / exec_wall
    roofline_utilization{program} = achieved / peak     (obs gauge)

``audit_cost_regressions`` (analysis D8) compares each program's bytes
accessed with a committed baseline.

Peaks: ``peak_gbps()`` defaults to 3,350 GB/s on a CUDA device (the
H100 SXM 80GB HBM3's HBM3 rate, the figure the port's kernel bounds use;
its measured programs ran on a card at a 700 W power limit), and to the
reference's nominal 25 GB/s elsewhere (CPU numbers are plumbing, not
quotable). ``FLAGS_obs_peak_gbps`` overrides both.
"""
from __future__ import annotations

import json
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.flags import flag

#: per-device peak-HBM-bandwidth defaults (GB/s) when FLAGS_obs_peak_gbps
#: is 0: an H100 SXM 80GB HBM3 moves 3,350 GB/s (the bound the kernel
#: table's bytes rows use, cards at a 700 W limit); other hosts get a
#: nominal DDR-class figure — their utilization numbers are test
#: plumbing, not quotable
PEAK_GBPS_DEFAULTS = {"cuda": 3350.0}
PEAK_GBPS_FALLBACK = 25.0

#: roofline gauges get a wider label cap than the default 64: a serving
#: ladder (prefill x chunk x decode buckets) legitimately exceeds it
_GAUGE_LABEL_CAP = 256


def _device_kind() -> str:
    from .trace import _on_card

    return "cuda" if _on_card() else "cpu"


def peak_gbps() -> float:
    v = float(flag("FLAGS_obs_peak_gbps"))
    if v > 0:
        return v
    return PEAK_GBPS_DEFAULTS.get(_device_kind(), PEAK_GBPS_FALLBACK)


# --------------------------------------------------------- cost counting
#: aten ops that touch no element: the allocation family (their results
#: are written by the op that consumes them)
_NO_BYTES = ("aten::empty", "aten::empty_like", "aten::empty_strided",
             "aten::new_empty", "aten::new_empty_strided",
             "aten::empty_permuted")
#: indexed reads: the source (the first operand) is read only where the
#: indices point, the bytes of the result
_GATHERS = ("aten::embedding", "aten::index", "aten::index_select",
            "aten::gather", "aten::take")
#: indexed writes in place: the destination (the first operand) is
#: written only where the indices point, the bytes of the values (a KV
#: cache append touches its rows, not the pool)
_SCATTERS = ("aten::index_put_", "aten::_index_put_impl_",
             "aten::index_copy_", "aten::index_add_", "aten::scatter_",
             "aten::scatter_add_", "aten::scatter_reduce_")


def _nbytes(t) -> int:
    """Bytes a tensor operand stands for: its elements, at most its
    storage (an expanded view reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


#: every SAMPLE_EVERY ops (and at the end) a card's counter reads the
#: allocator's current bytes for the peak: reading its statistics costs
#: more than most ops it would follow
SAMPLE_EVERY = 16


def _allocated(device) -> int:
    """The caching allocator's current bytes on `device` (one lookup in
    its statistics; `torch.cuda.memory_allocated` flattens all of them)."""
    return torch._C._cuda_memoryStats(device.index or 0)[
        "allocated_bytes"]["all"]["current"]


#: {OpOverload: (python body or None, composite, flop formula or None)}
_OP_INFO: dict = {}


def _op_info(func):
    info = _OP_INFO.get(func)
    if info is None:
        from torch.utils.flop_counter import flop_registry

        composite = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        info = _OP_INFO[func] = (_python_impl(func), composite,
                                 flop_registry.get(func._overloadpacket))
    return info


class CostCounter(TorchDispatchMode):
    """Flops, bytes and the memory peak of the ops and kernel launches run
    while it is active (see the module note). The kernel wrappers report
    through ``ops._cuda_common``'s cost hook, which ``__enter__`` installs
    (a module value, so launches from the autograd engine's threads
    report too)."""

    def __init__(self, device=None):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.kernels: dict = {}
        self.ops = 0
        self._ticks = 0             # ops and launches, for the sampling
        dev = torch.device(device) if device is not None else None
        self._cuda = dev if dev is not None and dev.type == "cuda" \
            else None
        self.alloc_start = _allocated(self._cuda) \
            if self._cuda is not None else 0
        self.alloc_peak = self.alloc_start
        self._prev_hook = None

    def __enter__(self):
        from ..ops import _cuda_common

        self._prev_hook = _cuda_common.set_cost_recorder(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from ..ops import _cuda_common

        _cuda_common.set_cost_recorder(self._prev_hook)
        self._sample(force=True)
        return super().__exit__(*exc)

    # -------------------------------------------------------- the hooks
    def on_launch(self, name, reads, writes, flops, nbytes=None):
        """One hand-written kernel launch (``count_launch``)."""
        self.flops += float(flops)
        self.bytes_accessed += sum(_nbytes(t) for t in (*reads, *writes)) \
            if nbytes is None else nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self._sample()

    def _sample(self, force=False):
        self._ticks += 1
        if self._cuda is not None and (force
                                       or self._ticks % SAMPLE_EVERY == 0):
            a = _allocated(self._cuda)
            if a > self.alloc_peak:
                self.alloc_peak = a

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        impl, composite, flop_fn = _op_info(func)
        if impl is not None:
            # the port's own dispatcher ops (the flash forward as a
            # custom op): run their Python body with the counter on, so
            # its kernel launch (or, on the CPU, its plain version's aten
            # ops) counts, and the op itself does not
            with self:
                return impl(*args, **kwargs)
        if composite:
            # below autograd (inside such an op's body) composite ops
            # such as matmul arrive whole: count what they decompose to
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if flop_fn is not None:
            self.flops += float(flop_fn(*args, **kwargs, out_val=out))
        self.bytes_accessed += _op_bytes(func._schema, args, kwargs, out)
        self.ops += 1
        self._sample()
        return out


def _op_bytes(schema, args, kwargs, out) -> int:
    """Bytes one aten op moves: its tensor operands read plus its results
    written; none for a view or an allocation; an indexed read or write
    counts the rows it touches (`_GATHERS`, `_SCATTERS`)."""
    name = schema.name
    if name in _NO_BYTES or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in schema.returns):
        return 0
    operands = list(_tensors((args, kwargs)))
    results = list(_tensors(out))
    if name in _GATHERS and operands:
        moved = sum(_nbytes(t) for t in results)
        return sum(_nbytes(t) for t in operands[1:]) + 2 * moved
    if name in _SCATTERS and operands:
        dest, rest = operands[0], operands[1:]
        values = sum(_nbytes(t) for t in rest if t.dtype == dest.dtype)
        return sum(_nbytes(t) for t in rest) + values
    return sum(_nbytes(t) for t in operands) \
        + sum(_nbytes(t) for t in results)


#: {OpOverload: the Python body of one of the port's dispatcher ops}
_PY_IMPLS: dict = {}


def _python_impl(func):
    if func.namespace != "paddle_tpu_torch":
        return None
    if not _PY_IMPLS:
        from ..ops.flash_attention import flash_attention_fwd_op

        op = torch.ops.paddle_tpu_torch.flash_attention_fwd.default
        _PY_IMPLS[op] = flash_attention_fwd_op._init_fn
    return _PY_IMPLS.get(func)


def extract_cost(run, device=None, args=(), outputs=None):
    """(cost, result) of ONE run of ``run()`` (the program body, run
    eagerly): the cost a dict of flops / bytes accessed / memory
    footprint, or None when ``FLAGS_obs_cost_capture`` is off; the result
    ``run()``'s, which the caller keeps (it paid for that run).
    ``device``: where the body runs (a card samples its allocator);
    ``args``: the program's explicit inputs (tensors, nested), whose
    bytes are ``arg_bytes``; the result's (or ``outputs``') are
    ``out_bytes``. ``peak_hbm_bytes`` is the largest allocated bytes
    sampled during the run on a card, the arguments plus the outputs on
    the CPU."""
    if not flag("FLAGS_obs_cost_capture"):
        return None, run()
    counter = CostCounter(device)
    with counter:
        out = run()
    arg_b = sum(_nbytes(t) for t in _tensors(args))
    out_b = sum(_nbytes(t) for t in _tensors(out if outputs is None
                                             else outputs))
    if counter._cuda is not None:
        peak = counter.alloc_peak
        temp = max(counter.alloc_peak - counter.alloc_start, 0)
    else:
        peak, temp = arg_b + out_b, 0
    return {"flops": counter.flops,
            "bytes_accessed": counter.bytes_accessed,
            "arg_bytes": arg_b, "out_bytes": out_b, "temp_bytes": temp,
            "peak_hbm_bytes": peak, "kernels": dict(counter.kernels),
            "ops": counter.ops}, out


class ProgramCost:
    """One program's ledger row: its counted costs + measured execution
    walls."""

    __slots__ = ("program", "site", "group", "key", "bucket", "flops",
                 "bytes_accessed", "arg_bytes", "out_bytes", "temp_bytes",
                 "peak_hbm_bytes", "collective_bytes", "compile_wall_s",
                 "analyzed", "exec_count", "exec_wall_s", "last_util", "t",
                 "_gauge")

    def __init__(self, program, site, group, key, bucket=None,
                 compile_wall_s=0.0, cost=None, collective_bytes=0):
        self.program = program      # stable id: "site|key"
        self.site = site
        self.group = group
        self.key = key
        self.bucket = bucket
        self.compile_wall_s = float(compile_wall_s)
        self._set_cost(cost)
        # collective bytes of a sharded program: 0 until the distributed
        # entry is ported (ROADMAP 'After these', Distributed)
        self.collective_bytes = int(collective_bytes or 0)
        self.exec_count = 0
        self.exec_wall_s = 0.0
        self.last_util = None
        self.t = time.time()
        self._gauge = None          # resolved roofline gauge handle

    def _set_cost(self, cost):
        cost = cost or {}
        self.analyzed = bool(cost)
        self.flops = float(cost.get("flops", 0.0))
        self.bytes_accessed = float(cost.get("bytes_accessed", 0.0))
        self.arg_bytes = int(cost.get("arg_bytes", 0))
        self.out_bytes = int(cost.get("out_bytes", 0))
        self.temp_bytes = int(cost.get("temp_bytes", 0))
        self.peak_hbm_bytes = int(cost.get("peak_hbm_bytes", 0))

    # ------------------------------------------------------ measurement
    def observe(self, wall_s: float):
        """One measured execution of this program. Updates the rolling
        achieved-bandwidth numbers and the roofline_utilization{program}
        gauge in the default registry."""
        self.exec_count += 1
        self.exec_wall_s += float(wall_s)
        if not self.analyzed or wall_s <= 0.0:
            return None
        util = self.bytes_accessed / (wall_s * peak_gbps() * 1e9)
        self.last_util = util
        if self._gauge is None:
            from . import default_registry

            self._gauge = default_registry().gauge(
                "roofline_utilization",
                "achieved HBM bandwidth of one compiled program over the "
                "device roofline (bytes_accessed from XLA cost_analysis / "
                "measured wall / FLAGS_obs_peak_gbps)",
                ("program",), label_cap=_GAUGE_LABEL_CAP).labels(
                    self.program)
        self._gauge.set(util)
        return util

    def achieved_gbps(self) -> float | None:
        """Mean achieved bandwidth over every measured execution."""
        if not (self.analyzed and self.exec_count and self.exec_wall_s > 0):
            return None
        return self.bytes_accessed * self.exec_count / self.exec_wall_s / 1e9

    def utilization(self) -> float | None:
        g = self.achieved_gbps()
        return None if g is None else g / peak_gbps()

    def predicted(self) -> tuple[float | None, float | None]:
        """(predicted_step_ms, collective_time_ms): the roofline
        max(compute, HBM) at the obs peaks (no collectives until the
        distributed entry). None when the program was not analyzed."""
        if not self.analyzed:
            return None, None
        from .goodput import peak_tflops

        compute_ms = self.flops / (peak_tflops() * 1e12) * 1e3
        hbm_ms = self.bytes_accessed / (peak_gbps() * 1e9) * 1e3
        return max(compute_ms, hbm_ms), 0.0

    def to_dict(self) -> dict:
        g = self.achieved_gbps()
        pred_ms, coll_ms = self.predicted()
        return {"program": self.program, "site": self.site,
                "group": self.group, "key": self.key, "bucket": self.bucket,
                "analyzed": self.analyzed, "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "arg_bytes": self.arg_bytes, "out_bytes": self.out_bytes,
                "temp_bytes": self.temp_bytes,
                "peak_hbm_bytes": self.peak_hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "predicted_step_ms": (None if pred_ms is None
                                      else round(pred_ms, 4)),
                "collective_time_ms": (None if coll_ms is None
                                       else round(coll_ms, 4)),
                "compile_wall_s": round(self.compile_wall_s, 4),
                "exec_count": self.exec_count,
                "exec_wall_s": round(self.exec_wall_s, 6),
                "achieved_gbps": None if g is None else round(g, 3),
                "roofline_utilization": (None if g is None
                                         else round(g / peak_gbps(), 4))}

    def cost_summary(self) -> dict | None:
        """The compile event's cost field: flops / bytes accessed / peak
        bytes, or None when the program was not analyzed."""
        if not self.analyzed:
            return None
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "peak_hbm_bytes": self.peak_hbm_bytes}


#: program id -> ProgramCost; process-global like the compile-event
#: window
_ledger: dict[str, ProgramCost] = {}
_site_counts: dict[str, int] = {}


def record_program(site: str, group: str, key: str, cost=None,
                   wall_s: float = 0.0, bucket=None,
                   collective_bytes=0) -> ProgramCost:
    """Register one program in the ledger with its counted ``cost`` (the
    dict of ``extract_cost``, or None), idempotent per program id: a
    program recorded again keeps its first analysis. Returns the entry;
    the caller attaches ``entry.observe(wall)`` per execution."""
    pid = f"{site}|{key}"
    entry = _ledger.get(pid)
    if entry is not None:
        if cost and not entry.analyzed:
            # a row recorded without a count (a key compiled from another
            # key's discovery) takes the first count that comes
            entry._set_cost(cost)
        return entry
    entry = ProgramCost(pid, site, group, key, bucket=bucket,
                        compile_wall_s=wall_s, cost=cost,
                        collective_bytes=collective_bytes)
    _ledger[pid] = entry
    _site_counts[site] = _site_counts.get(site, 0) + 1
    from . import metrics

    metrics.log_event("program_cost", **entry.to_dict())
    return entry


def needs_count(site: str, key: str) -> bool:
    """Whether program `site|key` still needs its cost counted: counting
    is on and no analyzed row holds it yet."""
    if not flag("FLAGS_obs_cost_capture"):
        return False
    entry = _ledger.get(f"{site}|{key}")
    return entry is None or not entry.analyzed


def reregister(entry: "ProgramCost") -> "ProgramCost":
    """Re-insert a live ProgramCost whose row was dropped by
    ``clear_ledger()``: programs outlive the ledger (an engine's captured
    graphs), so a program still in use must surface its analysis in the
    fresh ledger instead of vanishing from the roofline and D8 views."""
    if entry.program not in _ledger:
        _ledger[entry.program] = entry
        _site_counts[entry.site] = _site_counts.get(entry.site, 0) + 1
    return entry


def get_program(site: str, key: str) -> ProgramCost | None:
    return _ledger.get(f"{site}|{key}")


def ledger(site: str | None = None) -> list[ProgramCost]:
    """Ledger rows, optionally filtered by site prefix (``"serving"``
    matches serving.prefill / serving.decode / serving.chunk_prefill)."""
    rows = list(_ledger.values())
    if site is not None:
        rows = [e for e in rows if e.site == site
                or e.site.startswith(site + ".")]
    return sorted(rows, key=lambda e: e.program)


def clear_ledger():
    _ledger.clear()
    _site_counts.clear()
    _baselined_this_run.clear()


def reset_exec_stats():
    """Zero the measured-execution accumulators (so a measurement's
    utilization is its own); the counted costs stay — they belong to the
    program."""
    for e in _ledger.values():
        e.exec_count = 0
        e.exec_wall_s = 0.0
        e.last_util = None


def roofline_rows(site: str | None = None, measured_only: bool = False
                  ) -> list[dict]:
    rows = [e.to_dict() for e in ledger(site)]
    if measured_only:
        rows = [r for r in rows if r["roofline_utilization"] is not None]
    return rows


# -------------------------------------------------------------- baseline
#: programs committed by write_baseline() IN THIS PROCESS — D8 skips its
#: "new unbaselined program" note for them
_baselined_this_run: set = set()


def write_baseline(path: str, site: str = "serving",
                   threshold_pct: float | None = None) -> dict:
    """Commit the current ledger's analyzed programs as the D8 baseline.
    Only static quantities are recorded (bytes accessed, flops, memory
    footprint) — walls are machine-dependent."""
    if threshold_pct is None:
        threshold_pct = float(flag("FLAGS_obs_cost_regress_pct"))
    progs = {e.program: {"bytes_accessed": e.bytes_accessed,
                         "flops": e.flops,
                         "peak_hbm_bytes": e.peak_hbm_bytes}
             for e in ledger(site) if e.analyzed}
    _baselined_this_run.update(progs)
    base = {"_comment": "analysis D8 baseline: per-program bytes accessed "
                        "/ flops counted at each program's eager run "
                        "before capture (paddle_tpu_torch.obs.costs). "
                        "Regenerate with write_baseline after an "
                        "INTENTIONAL cost change.",
            "threshold_pct": float(threshold_pct), "programs": progs}
    with open(path, "w") as fh:
        json.dump(base, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return base


def load_baseline(path_or_dict) -> dict:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict) as fh:
        return json.load(fh)


def audit_cost_regressions(baseline, entries=None,
                           threshold_pct: float | None = None,
                           loc: str = "obs/costs") -> list:
    """D8 — program cost regressions vs a committed baseline.

    A program present in the baseline whose CURRENT bytes-accessed grew
    more than ``threshold_pct`` (baseline's own value, else
    FLAGS_obs_cost_regress_pct) is a **warning**. Programs the baseline
    knows but this run never compiled are notes (partial runs are
    normal); new unbaselined programs are one note; shrunk programs are
    notes too — an improvement worth re-baselining."""
    from ..analysis import Finding

    base = load_baseline(baseline)
    if threshold_pct is None:
        threshold_pct = float(base.get("threshold_pct",
                                       flag("FLAGS_obs_cost_regress_pct")))
    if entries is None:
        entries = ledger()
    cur = {e.program: e for e in entries}
    findings: list = []
    grown, shrunk, missing, checked = [], [], [], 0
    for pid, b in sorted(base.get("programs", {}).items()):
        e = cur.get(pid)
        if e is None or not e.analyzed:
            missing.append(pid)
            continue
        checked += 1
        b_bytes = float(b.get("bytes_accessed", 0.0))
        if b_bytes <= 0:
            continue
        growth = (e.bytes_accessed - b_bytes) / b_bytes
        if growth * 100.0 > threshold_pct:
            grown.append((pid, b_bytes, e.bytes_accessed, growth))
        elif growth < -0.05:
            shrunk.append((pid, b_bytes, e.bytes_accessed, growth))
    for pid, b_bytes, now, growth in grown:
        findings.append(Finding(
            "cost-regression", "warning", f"{loc}:{pid}",
            f"bytes accessed grew {growth:+.0%} over the committed "
            f"baseline ({b_bytes:.0f} -> {now:.0f} B, threshold "
            f"{threshold_pct:g}%) — this program's HBM traffic budget "
            "regressed; if intentional, regenerate "
            "tools/cost_baseline.json (tools/roofline_report.py "
            "--write-baseline)",
            data={"program": pid, "baseline_bytes": b_bytes,
                  "bytes": now, "growth_pct": round(growth * 100, 1),
                  "threshold_pct": threshold_pct}))
    for pid, b_bytes, now, growth in shrunk:
        findings.append(Finding(
            "cost-regression", "note", f"{loc}:{pid}",
            f"bytes accessed SHRANK {growth:+.0%} vs baseline "
            f"({b_bytes:.0f} -> {now:.0f} B) — re-baseline to lock the "
            "improvement in",
            data={"program": pid, "baseline_bytes": b_bytes,
                  "bytes": now}))
    if missing:
        findings.append(Finding(
            "cost-regression", "note", loc,
            f"{len(missing)} baselined program(s) not compiled this run "
            f"(partial smoke): {missing[:4]}"
            f"{'...' if len(missing) > 4 else ''}",
            data={"missing": missing}))
    new = sorted(pid for pid, e in cur.items()
                 if e.analyzed and pid not in base.get("programs", {})
                 and pid not in _baselined_this_run)
    if new:
        findings.append(Finding(
            "cost-regression", "note", loc,
            f"{len(new)} analyzed program(s) not in the baseline "
            f"(unbaselined additions): {new[:4]}"
            f"{'...' if len(new) > 4 else ''}",
            data={"new": new}))
    if not grown:
        findings.append(Finding(
            "cost-regression", "note", loc,
            f"{checked} baselined program(s) within the "
            f"{threshold_pct:g}% bytes-accessed budget",
            data={"checked": checked,
                  "threshold_pct": threshold_pct}))
    return findings
