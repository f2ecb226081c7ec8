"""Per-step training flight recorder — the artifact that explains a slow
step.

Port of paddle_tpu/obs/train_flight.py, the same names, trace layout,
tiling proof and anomaly triggers. ``TelemetryCallback`` says *what*
(``train_step_seconds`` p95 grew); this module records *why*: every
train step driven through an instrumented ``Model.fit`` carries an
ordered span timeline — the data wait (loader blocked before the batch
arrived), host→device transfer, forward / backward / optimizer-commit
phases, the loss read-back, compiled-step dispatches (``to_static``
programs, with their ledger flops) and the blocking half of checkpoint
saves — next to a separate track of the **overlapped** async-checkpoint
IO commits (``ckpt/async_saver.py`` background thread).
``TrainFlightRecorder.dump(path)`` exports the ring as Chrome-trace /
Perfetto JSON, and anomaly triggers (data starvation past
``FLAGS_obs_data_wait_ms``, a step-wall spike past
``FLAGS_obs_step_spike_factor`` × the rolling median, a checkpoint stall
past ``FLAGS_ckpt_stall_seconds``) auto-dump the last N step timelines to
``FLAGS_obs_flight_dir`` — the training twin of ``obs/flight.py``.

The tiling invariant is **asserted, not assumed**: a step's
``data_wait`` span ends exactly where its ``compute`` span begins, the
two tile the step window, and the compute span's endpoints must
reproduce the recorded step wall — the SAME ``perf_counter`` reads the
``train_step_seconds`` histogram observed — bitwise. ``dump()`` raises on
violation; every span's args carry exact float seconds (``t0_s`` /
``t1_s``) so the dumped JSON round-trips the proof
(``obs.validate_trace`` re-parses + re-checks).

Bounding: finished steps are a ring (``FLAGS_obs_train_flight_steps``;
oldest finished evicted, the active step never), per-step span lists are
capped, and the IO track is a fixed deque. The reference's lazy-mode
flush spans have no counterpart: its lazy mode is left out by design
(ROADMAP Queue 1 item 1), so a step's ``flushes`` stays 0.
"""
from __future__ import annotations

import bisect
import json
import os
import time
from collections import deque

from ..core.flags import flag

#: per-step program-span cap: flush/dispatch spans past it are counted
#: (``spans_dropped``) instead of stored
STEP_SPAN_CAP = 256

#: overlapped-IO track spans kept (async ckpt commits, epoch marks)
IO_SPAN_CAP = 1024

#: auto-dumps per recorder: a flapping spike must not fill the disk —
#: the anomaly counter keeps counting, the files stop
AUTODUMP_CAP = 16

#: rolling step-wall window for the spike trigger, and the minimum
#: population before the median is trusted
SPIKE_WINDOW = 64
SPIKE_MIN_STEPS = 8


class StepFlight:
    """One train step's timeline. Timestamps are ``time.perf_counter``
    seconds; the lifecycle boundaries (``fetch_s``/``begin_s``/``end_s``)
    are the very reads the TelemetryCallback histograms observe."""

    __slots__ = ("index", "epoch", "fetch_s", "begin_s", "end_s",
                 "wall_s", "data_wait_s", "loss", "flops", "flushes",
                 "spans", "spans_dropped", "marks", "programs")

    def __init__(self, index, epoch, fetch_s, begin_s):
        self.index = int(index)
        self.epoch = int(epoch)
        self.fetch_s = float(fetch_s)     # window start (prev step end)
        self.begin_s = float(begin_s)     # batch arrived, compute starts
        self.end_s = None
        self.wall_s = None                # recorded by the callback
        self.data_wait_s = begin_s - fetch_s
        self.loss = None
        self.flops = 0.0                  # ledger flops executed this step
        self.flushes = 0
        self.spans: list = []             # (name, t0, t1, args) programs
        self.spans_dropped = 0
        self.marks: list = []             # (name, t, args) instantaneous
        self.programs: list = []          # (program_id, flops) dispatched

    def add_span(self, name, t0, t1, args=None):
        if len(self.spans) >= STEP_SPAN_CAP:
            self.spans_dropped += 1
            return
        self.spans.append((name, float(t0), float(t1), args or {}))

    def add_mark(self, name, t, args=None):
        if len(self.marks) < STEP_SPAN_CAP:
            self.marks.append((name, float(t), args or {}))

    @property
    def finished(self) -> bool:
        return self.end_s is not None


class TrainFlightRecorder:
    """Bounded ring of :class:`StepFlight` timelines + an overlapped-IO
    track. One per ``TelemetryCallback`` (module-level ``current()``
    routes the hook sites in hapi/ckpt/jit here)."""

    def __init__(self, capacity: int | None = None, registry=None):
        if capacity is None:
            capacity = int(flag("FLAGS_obs_train_flight_steps"))
        self.capacity = max(1, int(capacity))
        self._steps: deque = deque()      # finished StepFlights
        self.active: StepFlight | None = None
        self._io: deque = deque(maxlen=IO_SPAN_CAP)
        # rolling wall window for the spike trigger: arrival order in the
        # deque, a parallel SORTED list maintained by bisect so the
        # per-step median is an index, not a 64-element re-sort
        self._walls: deque = deque()
        self._walls_sorted: list = []
        self.evicted = 0
        self.autodumps = 0
        self.autodump_paths: list[str] = []
        if registry is None:
            from . import default_registry

            registry = default_registry()
        self.registry = registry
        self._m_anomalies = registry.counter(
            "train_flight_anomalies_total", "training flight-recorder "
            "anomaly triggers (data_starvation, step_spike, ckpt_stall)",
            ("trigger",))
        self._m_dumps = registry.counter(
            "train_flight_dumps_total", "training flight-recorder "
            "postmortem trace files written to FLAGS_obs_flight_dir",
            ("trigger",))
        self._m_steps = registry.gauge(
            "train_flight_steps", "step timelines held in the training "
            "flight-recorder ring (active + finished)")

    # ----------------------------------------------------------- record
    def step_begin(self, index, epoch, fetch_s, begin_s) -> StepFlight:
        self.active = StepFlight(index, epoch, fetch_s, begin_s)
        self._m_steps.set(len(self._steps) + 1)
        return self.active

    def step_end(self, end_s, wall_s, loss=None, flushes=0):
        """Close the active step (``wall_s`` is the callback's own
        ``end - begin`` — the histogram sample — recorded separately so
        dump-time can ASSERT the recorder and the histogram agree) and
        run the anomaly triggers."""
        st = self.active
        if st is None:
            return None
        self.active = None
        st.end_s = float(end_s)
        st.wall_s = float(wall_s)
        st.loss = loss
        st.flushes = int(flushes)
        self._steps.append(st)
        while len(self._steps) > self.capacity:
            self._steps.popleft()
            self.evicted += 1
        self._m_steps.set(len(self._steps))
        # ---- anomaly triggers (dump AFTER the step joined the ring so
        # the postmortem contains the offending timeline)
        dw_ms = float(flag("FLAGS_obs_data_wait_ms"))
        if dw_ms > 0 and st.data_wait_s * 1e3 > dw_ms:
            self.anomaly("data_starvation")
        factor = float(flag("FLAGS_obs_step_spike_factor"))
        if factor > 0 and len(self._walls) >= SPIKE_MIN_STEPS:
            med = self._walls_sorted[len(self._walls_sorted) // 2]
            if med > 0 and st.wall_s > factor * med:
                self.anomaly("step_spike")
        if len(self._walls) >= SPIKE_WINDOW:
            old = self._walls.popleft()
            del self._walls_sorted[bisect.bisect_left(self._walls_sorted,
                                                      old)]
        self._walls.append(st.wall_s)
        bisect.insort(self._walls_sorted, st.wall_s)
        return st

    def program_span(self, name, t0, t1, **args):
        """One program-category span (h2d, fwd/bwd, optimizer commit,
        loss read-back, compiled dispatch, blocking ckpt copy). Attaches to the
        active step; between steps it lands on the IO track so a save at
        an epoch boundary is still visible."""
        st = self.active
        if st is not None:
            st.add_span(name, t0, t1, args)
        else:
            self._io.append((name, float(t0), float(t1), args))

    def program_dispatch(self, name, t0, t1, entry=None):
        """A compiled ``to_static`` program executed during this step:
        span + the ledger flops that make the MFU numerator."""
        args = {"program": name}
        st = self.active
        if entry is not None and getattr(entry, "analyzed", False):
            args["program"] = entry.program
            args["flops"] = entry.flops
            if st is not None:
                st.flops += entry.flops
                st.programs.append((entry.program, entry.flops))
        self.program_span(f"dispatch:{name}", t0, t1, **args)

    def io_span(self, name, t0, t1, **args):
        """Overlapped-IO track (async ckpt commits; background thread —
        a deque append is GIL-atomic like the metrics hot path)."""
        self._io.append((name, float(t0), float(t1), args))

    def mark(self, name, t=None, **args):
        t = time.perf_counter() if t is None else t
        st = self.active
        if st is not None:
            st.add_mark(name, t, args)
        else:
            self._io.append((name, float(t), None, args))

    def steps(self) -> list[StepFlight]:
        out = list(self._steps)
        if self.active is not None:
            out.append(self.active)
        return out

    # ----------------------------------------------------------- export
    def _check_tiling(self):
        """The invariant: ``data_wait`` + ``compute`` tile the step
        window and the compute endpoints reproduce the recorded wall —
        all derived from the same three ``perf_counter`` reads the
        ``train_step_seconds`` histogram observed."""
        for st in self._steps:
            if not (st.fetch_s <= st.begin_s <= st.end_s):
                raise AssertionError(
                    f"step {st.index}: non-monotonic lifecycle "
                    f"({st.fetch_s} -> {st.begin_s} -> {st.end_s})")
            if st.wall_s is not None and \
                    (st.end_s - st.begin_s) != st.wall_s:
                raise AssertionError(
                    f"step {st.index}: compute span does not tile the "
                    f"recorded step wall ({st.end_s - st.begin_s!r} != "
                    f"{st.wall_s!r}) — the callback's histogram "
                    "bookkeeping and the recorder's diverged")

    def to_chrome(self) -> dict:
        """Chrome-trace/Perfetto ``traceEvents`` JSON (object form): tid
        0 = the train loop (step + lifecycle + program spans), tid 1 =
        the overlapped-IO track. Complete events carry exact seconds in
        ``args``; ts/dur microseconds are viewer-resolution only."""
        self._check_tiling()
        steps = self.steps()
        times = [st.fetch_s for st in steps]
        times += [t0 for _, t0, _, _ in self._io]
        epoch0 = min(times) if times else 0.0

        def us(t):
            return (t - epoch0) * 1e6

        ev: list[dict] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "paddle_tpu_torch training"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
             "args": {"name": "train loop"}},
            {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
             "args": {"name": "ckpt io (overlapped)"}},
        ]
        for st in steps:
            # a mid-step dump (anomaly postmortem while this step is
            # still computing) has no end yet — the window stretches
            # over whatever spans it recorded so far
            end = st.end_s or st.begin_s
            for _, _, t1, _ in st.spans:
                end = max(end, t1)
            for _, t, _ in st.marks:
                end = max(end, t)
            ev.append({"ph": "X", "pid": 1, "tid": 0, "name": "step",
                       "ts": us(st.fetch_s),
                       "dur": (end - st.fetch_s) * 1e6, "cat": "step",
                       "args": {"step": st.index, "epoch": st.epoch,
                                "wall_s": st.wall_s,
                                "data_wait_s": st.data_wait_s,
                                "loss": st.loss, "flops": st.flops,
                                "flushes": st.flushes,
                                "spans_dropped": st.spans_dropped,
                                "t0_s": st.fetch_s, "t1_s": end}})
            ev.append({"ph": "X", "pid": 1, "tid": 0, "name": "data_wait",
                       "ts": us(st.fetch_s),
                       "dur": (st.begin_s - st.fetch_s) * 1e6,
                       "cat": "lifecycle",
                       "args": {"step": st.index, "t0_s": st.fetch_s,
                                "t1_s": st.begin_s}})
            if st.end_s is not None:
                ev.append({"ph": "X", "pid": 1, "tid": 0,
                           "name": "compute", "ts": us(st.begin_s),
                           "dur": (st.end_s - st.begin_s) * 1e6,
                           "cat": "lifecycle",
                           "args": {"step": st.index,
                                    "wall_s": st.wall_s,
                                    "t0_s": st.begin_s,
                                    "t1_s": st.end_s}})
            for name, t0, t1, args in st.spans:
                ev.append({"ph": "X", "pid": 1, "tid": 0, "name": name,
                           "ts": us(t0), "dur": (t1 - t0) * 1e6,
                           "cat": "program",
                           "args": dict(args, step=st.index, t0_s=t0,
                                        t1_s=t1)})
            for name, t, args in st.marks:
                ev.append({"ph": "i", "pid": 1, "tid": 0, "name": name,
                           "ts": us(t), "s": "t",
                           "args": dict(args, step=st.index, t_s=t)})
        for name, t0, t1, args in self._io:
            if t1 is None:
                ev.append({"ph": "i", "pid": 1, "tid": 1, "name": name,
                           "ts": us(t0), "s": "t",
                           "args": dict(args, t_s=t0)})
            else:
                ev.append({"ph": "X", "pid": 1, "tid": 1, "name": name,
                           "ts": us(t0), "dur": (t1 - t0) * 1e6,
                           "cat": "io",
                           "args": dict(args, t0_s=t0, t1_s=t1)})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"source": "paddle_tpu_torch.obs.train_flight",
                              "steps": len(steps),
                              "evicted": self.evicted,
                              "epoch_s": epoch0}}

    def dump(self, path: str) -> str:
        obj = self.to_chrome()
        with open(path, "w") as fh:
            json.dump(obj, fh)
        return path

    #: name parity with ServingEngine.dump_trace — same artifact shape,
    #: same validator entry point (obs.validate_trace)
    dump_trace = dump

    # ---------------------------------------------------------- anomaly
    def anomaly(self, trigger: str) -> str | None:
        """One anomaly: count it and (when FLAGS_obs_flight_dir is set)
        write the last-N-steps postmortem, capped at AUTODUMP_CAP files
        per recorder. Never raises — a broken postmortem path must not
        take the train loop down."""
        self._m_anomalies.labels(trigger).inc()
        d = str(flag("FLAGS_obs_flight_dir") or "")
        if not d or self.autodumps >= AUTODUMP_CAP:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"train_{trigger}_{os.getpid()}_{self.autodumps}.json")
            self.dump(path)
        except Exception:
            return None
        self.autodumps += 1
        self.autodump_paths.append(path)
        self._m_dumps.labels(trigger).inc()
        return path


# ----------------------------------------------------- module-level hook
#: the recorder the hook sites (hapi train_batch, ckpt savers, jit
#: dispatch) report to; set by TelemetryCallback for the
#: duration of a fit. A plain module global: the train loop is
#: single-threaded, background IO threads only append to their own track.
_CURRENT: TrainFlightRecorder | None = None


def current() -> TrainFlightRecorder | None:
    return _CURRENT


def set_current(rec: TrainFlightRecorder | None):
    """Install ``rec`` as the active recorder; returns the previous one
    (nested fits restore it on exit)."""
    global _CURRENT

    prev = _CURRENT
    _CURRENT = rec
    return prev


# ------------------------------------------------------------ validation
def validate_train_trace(obj_or_path) -> dict:
    """Structural validation of a dumped TRAINING trace — the re-parse
    half of the round trip (``obs.validate_trace`` routes training dumps
    here via ``otherData.source``). Verifies: JSON loads, traceEvents
    exists, non-negative durations, and per step: the lifecycle spans
    NEST inside the step window, ``data_wait`` starts the window and ends
    exactly where ``compute`` begins, ``compute`` ends the step window,
    and the compute endpoints reproduce the recorded ``wall_s`` bitwise.
    Raises ValueError on violation; returns a summary dict."""
    if isinstance(obj_or_path, (str, os.PathLike)):
        with open(obj_or_path) as fh:
            obj = json.load(fh)
    else:
        obj = obj_or_path
    evs = obj.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("trace has no traceEvents array")
    by_step: dict = {}
    io_spans = 0
    for e in evs:
        if e.get("ph") != "X":
            continue
        if e.get("dur", 0) < 0:
            raise ValueError(f"negative-duration span: {e}")
        if e.get("tid") == 1:
            io_spans += 1
            continue
        idx = (e.get("args") or {}).get("step")
        if idx is not None:
            by_step.setdefault(idx, {}).setdefault(
                e["name"], []).append(e)
    steps = 0
    tiled = 0
    for idx, spans in sorted(by_step.items()):
        if "step" not in spans:
            raise ValueError(
                f"step {idx}: sub-spans without a step window span")
        steps += 1
        win = spans["step"][0]["args"]
        lo, hi = win["t0_s"], win["t1_s"]
        for name, group in spans.items():
            for s in group:
                a = s["args"]
                if not (lo <= a["t0_s"] and a["t1_s"] <= hi):
                    raise ValueError(
                        f"span {name!r} escapes its step window on step "
                        f"{idx}: [{a['t0_s']}, {a['t1_s']}] outside "
                        f"[{lo}, {hi}]")
        if "data_wait" in spans and "compute" in spans:
            dw = spans["data_wait"][0]["args"]
            cp = spans["compute"][0]["args"]
            if dw["t0_s"] != lo:
                raise ValueError(
                    f"step {idx}: data_wait does not start the step "
                    f"window ({dw['t0_s']!r} != {lo!r})")
            if dw["t1_s"] != cp["t0_s"]:
                raise ValueError(
                    f"step {idx}: data_wait does not end where compute "
                    f"begins ({dw['t1_s']!r} != {cp['t0_s']!r})")
            wall = cp.get("wall_s")
            if wall is not None and (cp["t1_s"] - cp["t0_s"]) != wall:
                raise ValueError(
                    f"step {idx}: compute span does not tile the "
                    f"recorded step wall "
                    f"({cp['t1_s'] - cp['t0_s']!r} != {wall!r})")
            tiled += 1
    return {"events": len(evs), "steps": steps, "tiled_steps": tiled,
            "io_spans": io_spans}
