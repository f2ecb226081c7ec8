"""Training MFU + goodput ledger — productive step seconds over total
wall, net of compile / checkpoint / data-wait / post-resume-replay
overheads (the ML-goodput accounting shape), plus model-FLOPs utilization
from the cost ledger's counted flops.

Port of paddle_tpu/obs/goodput.py, the same names, metrics and audit.

* **MFU** — ``obs/costs.py`` counts the flops of each ``to_static``
  program at its discovery run; the train flight recorder accumulates
  the flops each step actually dispatched, and dividing by the measured
  step wall and the device peak (``FLAGS_obs_peak_tflops``) gives
  ``train_mfu{program}`` per compiled program plus an aggregate
  ``train_mfu{program="step"}`` and ``train_achieved_flops``. Eager
  training (no compiled step program) declares its per-step flops the
  same way token accounting is declared
  (``TelemetryCallback(step_flops=...)``).

* **Goodput** — cumulative wall-second accounting into
  ``train_goodput_seconds_total{category}``: ``productive`` (step
  compute), ``data_wait`` (loader stalls), ``compile`` (watchdog compile
  walls — program captures — recorded while training), ``ckpt`` (the
  BLOCKING portion of checkpoint saves — the overlapped async commit
  costs nothing here), and ``replay`` (the resume fast-forward: batches
  re-consumed without compute count against goodput, NOT against MFU).
  ``train_goodput_ratio`` = productive seconds / total wall since
  ``start()``.

The module-level ``activate()``/``deactivate()`` pair scopes the hook
sites (watchdog compile events, ``Model.fit``'s replay loop, checkpoint
saves) to the ledger of the fit that is actually running, so a serving
engine compiling in the same process never pollutes training goodput.

**Analysis D12** (``audit_train_steps``) turns the joined recorder +
ledger story into Findings: a data-starvation STREAK (consecutive steps
blocked on input past ``FLAGS_obs_data_wait_ms``) and an MFU COLLAPSE
(recent median a fraction of the run median) are warnings.

Peak: ``peak_tflops()`` defaults to 989 TFLOP/s on a CUDA device (an
H100 SXM's dense bf16 tensor-core peak, the figure the kernel table's
operation bounds use; its training runs were on a card at a 700 W power
limit), and to the reference's nominal 0.5 elsewhere (CPU numbers are
plumbing, not quotable).
"""
from __future__ import annotations

import statistics
import time
from collections import deque

from ..core.flags import flag

#: per-device peak-compute defaults (bf16 TFLOP/s) when
#: FLAGS_obs_peak_tflops is 0: an H100 SXM's 989 dense bf16 TFLOP/s
#: (cards at a 700 W limit); the fallback makes CPU plumbing produce
#: finite gauges, not quotable numbers (same contract as obs/costs.py
#: PEAK_GBPS_FALLBACK)
PEAK_TFLOPS_DEFAULTS = {"cuda": 989.0}
PEAK_TFLOPS_FALLBACK = 0.5

#: goodput categories (the label set of train_goodput_seconds_total)
CATEGORIES = ("productive", "data_wait", "compile", "ckpt", "replay")

#: per-step MFU history kept for D12's collapse detector
MFU_HISTORY = 256

#: train_mfu gets the same widened label cap as roofline_utilization —
#: a step dispatching several compiled programs is legitimate
_GAUGE_LABEL_CAP = 256


#: (flag_value, resolved) memo — observe_step runs per train step; the
#: device never changes mid-process and the flag rarely does
_peak_memo: tuple = (None, None)


def peak_tflops() -> float:
    global _peak_memo

    v = float(flag("FLAGS_obs_peak_tflops"))
    if _peak_memo[0] == v:
        return _peak_memo[1]
    if v > 0:
        out = v
    else:
        from .costs import _device_kind

        out = PEAK_TFLOPS_DEFAULTS.get(_device_kind(), PEAK_TFLOPS_FALLBACK)
    _peak_memo = (v, out)
    return out


class GoodputLedger:
    """Cumulative MFU/goodput accounting over one registry. Persists
    across sequential fits (``start()``/``stop()`` accumulate elapsed
    wall per fit); ``reset()`` zeroes the host-side state (registry
    counters are monotonic by contract and stay)."""

    def __init__(self, registry=None):
        if registry is None:
            from . import default_registry

            registry = default_registry()
        self.registry = registry
        self._m_secs = registry.counter(
            "train_goodput_seconds_total", "cumulative training wall "
            "seconds by goodput category (productive step compute vs "
            "data_wait / compile / blocking-ckpt / resume-replay "
            "overheads)", ("category",))
        self._sec_handles = {c: self._m_secs.labels(c) for c in CATEGORIES}
        self._m_ratio = registry.gauge(
            "train_goodput_ratio", "productive step seconds over total "
            "training wall since the ledger started (ML goodput)")
        self._m_mfu = registry.gauge(
            "train_mfu", "model-FLOPs utilization: flops executed per "
            "measured step wall over FLAGS_obs_peak_tflops; one child "
            "per compiled program plus the aggregate program=\"step\"",
            ("program",), label_cap=_GAUGE_LABEL_CAP)
        self._m_aflops = registry.gauge(
            "train_achieved_flops", "achieved FLOP/s of the last train "
            "step (ledger flops / measured wall)")
        self._m_dwait = registry.histogram(
            "train_data_wait_seconds", "per-step loader stall: previous "
            "step end -> batch available (the data_wait flight span)")
        self.seconds = {c: 0.0 for c in CATEGORIES}
        self.steps = 0
        self.mfu_history: deque = deque(maxlen=MFU_HISTORY)
        self._t_start = None          # the running window's start
        self._elapsed_closed = 0.0    # wall of closed windows
        self._window_skip = 0.0       # replay wall the next data_wait
        #                               measurement must not re-count

    # ----------------------------------------------------------- window
    @property
    def active(self) -> bool:
        return self._t_start is not None

    def start(self):
        if self._t_start is None:
            self._t_start = time.perf_counter()
        return self

    def stop(self):
        if self._t_start is not None:
            self._elapsed_closed += time.perf_counter() - self._t_start
            self._t_start = None
        return self

    def elapsed(self) -> float:
        live = (time.perf_counter() - self._t_start) \
            if self._t_start is not None else 0.0
        return self._elapsed_closed + live

    def reset(self):
        self.seconds = {c: 0.0 for c in CATEGORIES}
        self.steps = 0
        self.mfu_history.clear()
        self._t_start = None
        self._elapsed_closed = 0.0
        self._window_skip = 0.0

    # ------------------------------------------------------- accounting
    def _add(self, category: str, wall_s: float):
        wall_s = max(float(wall_s), 0.0)
        self.seconds[category] += wall_s
        self._sec_handles[category].inc(wall_s)

    def observe_step(self, wall_s, data_wait_s=0.0, flops=0.0,
                     programs=()):
        """One completed train step: ``wall_s`` productive seconds,
        ``data_wait_s`` loader stall, ``flops`` the step's total FLOP
        count (ledger-accumulated or declared), ``programs`` the
        (program_id, flops) pairs dispatched — each gets its own
        ``train_mfu{program}`` child. Returns the aggregate MFU (or
        None without a flops source)."""
        self.steps += 1
        self._add("productive", wall_s)
        self._add("data_wait", data_wait_s)
        self._m_dwait.observe(max(float(data_wait_s), 0.0))
        # denominator: real elapsed wall, floored by the categorized
        # seconds so synthetic accounting (tests, offline replays of a
        # recorded run) can never quote a ratio above 1
        total = max(self.elapsed(), sum(self.seconds.values()))
        if total > 0:
            self._m_ratio.set(self.seconds["productive"] / total)
        if not flops or wall_s <= 0:
            return None
        peak = peak_tflops() * 1e12
        aflops = float(flops) / float(wall_s)
        self._m_aflops.set(aflops)
        mfu = aflops / peak
        self._m_mfu.labels("step").set(mfu)
        # sum per program FIRST: one compiled program dispatched N times
        # in a step (grad-accumulation microbatches) contributes N x its
        # flops, matching the aggregate instead of the last dispatch
        per_prog: dict = {}
        for pid, p_flops in programs:
            per_prog[pid] = per_prog.get(pid, 0.0) + float(p_flops)
        for pid, p_flops in per_prog.items():
            self._m_mfu.labels(pid).set(p_flops / float(wall_s) / peak)
        self.mfu_history.append(mfu)
        return mfu

    def note_compile(self, wall_s: float):
        self._add("compile", wall_s)

    def note_ckpt(self, wall_s: float):
        """The BLOCKING portion of a checkpoint save (host copy /
        synchronous commit) — overlapped background IO is free."""
        self._add("ckpt", wall_s)

    def note_replay(self, wall_s: float):
        """Resume fast-forward: re-consumed batches count
        against goodput, not MFU — and the wall is remembered so the
        next step's data_wait measurement can net it out instead of
        double-counting it as a loader stall."""
        self._add("replay", wall_s)
        self._window_skip += max(float(wall_s), 0.0)

    def take_window_skip(self) -> float:
        s, self._window_skip = self._window_skip, 0.0
        return s

    def to_dict(self) -> dict:
        el = self.elapsed()
        total = max(el, sum(self.seconds.values()))
        return {"steps": self.steps, "elapsed_s": round(el, 6),
                "seconds": {c: round(v, 6)
                            for c, v in self.seconds.items()},
                "goodput_ratio": (self.seconds["productive"] / total
                                  if total > 0 else None),
                "mfu_last": (self.mfu_history[-1]
                             if self.mfu_history else None),
                "mfu_median": (statistics.median(self.mfu_history)
                               if self.mfu_history else None),
                "peak_tflops": peak_tflops()}


# ------------------------------------------------------ module-level hook
#: the ledger of the fit currently running — the watchdog / fit-replay /
#: ckpt hook sites only report while one is active, so serving compiles
#: in the same process never count against training goodput
_ACTIVE: GoodputLedger | None = None


def activate(ledger: GoodputLedger) -> GoodputLedger | None:
    """Install ``ledger`` as the hook target; returns the previous one
    (nested fits restore it)."""
    global _ACTIVE

    prev = _ACTIVE
    _ACTIVE = ledger
    return prev


def deactivate(ledger: GoodputLedger | None = None):
    global _ACTIVE

    if ledger is None or _ACTIVE is ledger:
        _ACTIVE = None


def active_ledger() -> GoodputLedger | None:
    return _ACTIVE


def note_compile(wall_s: float):
    if _ACTIVE is not None and _ACTIVE.active:
        _ACTIVE.note_compile(wall_s)


def note_ckpt(wall_s: float):
    if _ACTIVE is not None and _ACTIVE.active:
        _ACTIVE.note_ckpt(wall_s)


def note_replay(wall_s: float):
    if _ACTIVE is not None and _ACTIVE.active:
        _ACTIVE.note_replay(wall_s)


# ------------------------------------------------------------------- D12
def audit_train_steps(recorder=None, ledger=None, data_wait_ms=None,
                      streak: int = 3, collapse_ratio: float = 0.5,
                      min_mfu_steps: int = 16,
                      loc: str = "obs/train") -> list:
    """D12 — training-step health Findings over the flight recorder's
    step ring and the goodput ledger's MFU history.

    * **data-starvation streak**: ``streak`` or more CONSECUTIVE steps
      whose data_wait exceeded ``FLAGS_obs_data_wait_ms`` — the input
      pipeline, not compute, is the bottleneck (warning). Isolated
      stalls (epoch boundaries, first batch) stay notes.
    * **MFU collapse**: with at least ``min_mfu_steps`` MFU samples,
      the median of the most recent quarter fell below
      ``collapse_ratio`` x the run median — throughput regressed
      mid-run (a retrace, a growing host sync, a dying input pipeline)
      even though steps still complete (warning).

    Healthy windows produce notes, so a report shows the audit ran."""
    from ..analysis import Finding
    from . import train_flight

    if recorder is None:
        recorder = train_flight.current()
    if ledger is None:
        ledger = _ACTIVE
    if data_wait_ms is None:
        data_wait_ms = float(flag("FLAGS_obs_data_wait_ms"))
    findings: list = []

    steps = [st for st in (recorder.steps() if recorder else [])
             if st.finished]
    worst_streak, run, worst_end = 0, 0, None
    if data_wait_ms > 0:
        for st in steps:
            if st.data_wait_s * 1e3 > data_wait_ms:
                run += 1
                if run > worst_streak:
                    worst_streak, worst_end = run, st.index
            else:
                run = 0
    if worst_streak >= streak:
        findings.append(Finding(
            "train-starvation", "warning", loc,
            f"{worst_streak} consecutive step(s) blocked on input past "
            f"FLAGS_obs_data_wait_ms={data_wait_ms:g} (ending at step "
            f"{worst_end}) — the loader, not compute, bounds this run; "
            "raise num_workers / prefetch or fix the input pipeline",
            data={"streak": worst_streak, "threshold_ms": data_wait_ms,
                  "end_step": worst_end}))
    else:
        findings.append(Finding(
            "train-starvation", "note", loc,
            f"{len(steps)} recorded step(s), longest data-wait streak "
            f"{worst_streak} (< {streak}) at "
            f"threshold {data_wait_ms:g}ms",
            data={"steps": len(steps), "streak": worst_streak}))

    hist = list(ledger.mfu_history) if ledger is not None else []
    if len(hist) >= min_mfu_steps:
        overall = statistics.median(hist)
        recent = statistics.median(hist[-max(len(hist) // 4, 4):])
        if overall > 0 and recent < collapse_ratio * overall:
            findings.append(Finding(
                "train-mfu-collapse", "warning", loc,
                f"MFU collapsed mid-run: recent median "
                f"{recent:.4f} < {collapse_ratio:g} x run median "
                f"{overall:.4f} — throughput regressed while steps "
                "still complete (retrace storm, growing host sync, or "
                "a dying input pipeline); dump the flight ring",
                data={"recent": recent, "overall": overall,
                      "collapse_ratio": collapse_ratio}))
        else:
            findings.append(Finding(
                "train-mfu-collapse", "note", loc,
                f"MFU steady over {len(hist)} step(s): recent median "
                f"{recent:.4f} vs run median {overall:.4f}",
                data={"recent": recent, "overall": overall}))
    else:
        findings.append(Finding(
            "train-mfu-collapse", "note", loc,
            f"{len(hist)} MFU sample(s) (< {min_mfu_steps}) — collapse "
            "detection needs a longer window or a flops source "
            "(compiled step program or TelemetryCallback(step_flops=))",
            data={"samples": len(hist)}))
    return findings
