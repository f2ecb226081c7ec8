"""Trace spans — named scopes over the device profiler, with wall-clock
records everywhere.

Port of paddle_tpu/obs/trace.py. ``span(name)`` records a wall-clock span
(qualified with its nesting path, e.g. ``step/prefill``) into a bounded
host buffer, and observes its duration into a histogram when given one;
on a card it also marks the region with ``torch.profiler.
record_function``, so the scope shows up in a ``torch.profiler`` trace
(the reference's ``jax.profiler.TraceAnnotation`` on a TPU).
``capture_trace(dir)`` is the on-demand profile: a ``torch.profiler``
capture of the window, written to ``dir`` as a Chrome trace.

Distinct from a profiler surface: ``obs.span`` is the always-available
internal instrumentation the runtime itself uses — no scheduler, no
recording toggle.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque

import torch

_tls = threading.local()

#: host-side span record buffer; bounded so an instrumented serving loop
#: can run forever
_SPAN_BUF_CAP = 8192
# thread-safe: GIL-atomic bounded-deque appends; readers snapshot
_span_buf: deque = deque(maxlen=_SPAN_BUF_CAP)

# thread-safe: idempotent memo, last-write-wins
_card_memo: bool | None = None

#: capture_trace's file numbers within the process
_captures = itertools.count()


def _on_card() -> bool:
    """Whether a CUDA card is present, memoized: span() must not ask
    CUDA on every call."""
    global _card_memo
    if _card_memo is None:
        _card_memo = bool(torch.cuda.is_available())
    return _card_memo


def _stack() -> list:
    s = getattr(_tls, "span_stack", None)
    if s is None:
        s = _tls.span_stack = []
    return s


@contextlib.contextmanager
def span(name: str, histogram=None):
    """Named scope: ``with obs.span("prefill"): ...``.

    Records a wall-clock span (qualified with its nesting path) into the
    host buffer; when `histogram` (an obs.metrics.Histogram handle) is
    given, the duration is observed into it. On a card the scope is also
    a ``record_function`` region of the torch profiler. Yields the span's
    record: a caller whose device work outlives the scope (a card runs
    asynchronously) sets its ``seconds`` once that work has ended."""
    stack = _stack()
    qual = "/".join([*(s for s in stack), name]) if stack else name
    stack.append(name)
    rec = {"name": name, "path": qual, "seconds": None,
           "depth": len(stack) - 1}
    ann = None
    if _on_card():
        ann = torch.profiler.record_function(name)
        ann.__enter__()
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        dt = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(None, None, None)
        stack.pop()
        rec["seconds"] = dt
        _span_buf.append(rec)
        if histogram is not None:
            histogram.observe(dt)


@contextlib.contextmanager
def step_span(step: int, name: str = "train_step"):
    """Per-step scope: the span ``name[step]`` (on a card a
    ``record_function`` region of that name, where the reference's TPU
    path groups steps with ``StepTraceAnnotation``)."""
    with span(f"{name}[{int(step)}]"):
        yield


def span_events(clear: bool = False) -> list[dict]:
    """Snapshot of the host span buffer (newest last)."""
    out = list(_span_buf)
    if clear:
        _span_buf.clear()
    return out


def clear_spans():
    _span_buf.clear()


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """On-demand profile capture around a suspect window:

        with obs.capture_trace("/tmp/trace"):
            engine.step()

    A ``torch.profiler`` capture (the host's ops, and the card's kernels
    where there is one), written on exit to ``log_dir`` as a Chrome trace
    (``trace_<pid>_<n>.json``, loadable in Perfetto or chrome://tracing).
    Yields the directory. One capture runs at a time: torch's profiler
    refuses to nest."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if _on_card():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield log_dir
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{next(_captures)}.json"))
