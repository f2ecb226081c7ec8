"""paddle_tpu_torch.obs — runtime telemetry: metrics, spans, compile
watchdog, structured logging, the request flight recorder.

Port of paddle_tpu/obs, the same public names, metric names, types,
label names and help strings:

  * **metrics**  — Counter/Gauge/Histogram registry with labels
    (cardinality-capped), the JSONL event log (``FLAGS_obs_log_path``)
    and the Prometheus text exposition (``render_prometheus()``, and the
    stdlib ``/metrics`` endpoint of ``serve_metrics(port)``). The
    serving engine owns a per-instance registry; the process default
    (compile metrics) is ``default_registry()``.
  * **trace**    — ``span("name")``: wall-clock spans everywhere, a
    ``torch.profiler.record_function`` region on a card;
    ``capture_trace(dir)`` writes a torch.profiler Chrome trace.
  * **watchdog** — every program key's first call (a CUDA-graph capture
    on a card) becomes a compile event + ``compiles_total`` /
    ``compile_seconds``; ``audit_recompiles()`` turns storms and
    post-warmup captures into ``analysis.Finding``s; checkpoint saves
    become events that ``audit_ckpt_stalls()`` audits.
  * **costs**    — the program cost ledger: flops and bytes counted at
    each program's eager run before capture, joined with measured walls
    into ``roofline_utilization{program}``; ``audit_cost_regressions``
    (D8) against a baseline.
  * **logging**  — module-scoped VLOG driven by ``FLAGS_log_level`` with
    per-message rate limiting.
  * **flight**   — the serving engine's per-request span timelines,
    Chrome-trace dumps and anomaly postmortems.
  * **train_flight / goodput** — the training twins: per-step span
    timelines (data wait, h2d, fwd/bwd/opt, loss read-back, compiled
    dispatches, ckpt IO) with a dump-time tiling assertion and anomaly
    postmortems (data starvation / step spike / ckpt stall), plus MFU
    (``train_mfu{program}``) and ML-goodput accounting
    (``train_goodput_seconds_total{category}``); ``audit_train_steps``
    (D12) gates starvation streaks and MFU collapse.

Overhead: the serving engine records into its registry and flight
recorder on every tick; the watchdog records every compile event;
``FLAGS_obs_metrics=1`` opts the train loop in (``hapi``'s ``fit``
attaches a ``TelemetryCallback``).
"""
from __future__ import annotations

from .costs import (ProgramCost, audit_cost_regressions, clear_ledger,
                    extract_cost, ledger, peak_gbps, record_program,
                    reset_exec_stats, roofline_rows, write_baseline)
from .flight import FlightRecorder, RequestFlight, validate_trace
from .goodput import GoodputLedger, audit_train_steps, peak_tflops
from .http import MetricsServer, serve_metrics, shared_server
from .logging import ObsLogger, get_logger
from .metrics import (DEFAULT_BUCKETS, OVERFLOW, Counter, Gauge, Histogram,
                      Registry, dump_registry, log_event)
from .trace import (capture_trace, clear_spans, span, span_events,
                    step_span)
from .train_flight import (StepFlight, TrainFlightRecorder,
                           validate_train_trace)
from .watchdog import (CompileEvent, audit_ckpt_stalls, audit_recompiles,
                       ckpt_save_events, clear_events, compile_counts,
                       compile_events, jaxpr_size, post_warmup_compiles,
                       record_ckpt_save, record_compile)

#: process-default registry: compile watchdog counters, train-callback
#: metrics, anything not tied to one engine instance
_default = Registry()


def default_registry() -> Registry:
    return _default


def render_prometheus() -> str:
    """Prometheus text exposition of the default registry."""
    return _default.render_prometheus()


def metrics_enabled() -> bool:
    """Global opt-in for instrumentation OUTSIDE the serving engine
    (FLAGS_obs_metrics; hapi's fit reads it). The engine instruments
    unconditionally (its registry is the serving product); the watchdog
    records compiles unconditionally (rare events, not a hot path)."""
    from ..core.flags import flag

    return bool(flag("FLAGS_obs_metrics"))


__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "DEFAULT_BUCKETS",
    "OVERFLOW", "default_registry", "render_prometheus", "metrics_enabled",
    "dump_registry", "log_event",
    "span", "step_span", "span_events", "clear_spans", "capture_trace",
    "CompileEvent", "record_compile", "compile_events", "compile_counts",
    "post_warmup_compiles", "clear_events", "audit_recompiles",
    "jaxpr_size",
    "record_ckpt_save", "ckpt_save_events", "audit_ckpt_stalls",
    "get_logger", "ObsLogger",
    "serve_metrics", "MetricsServer", "shared_server",
    "FlightRecorder", "RequestFlight", "validate_trace",
    "TrainFlightRecorder", "StepFlight", "validate_train_trace",
    "GoodputLedger", "audit_train_steps", "peak_tflops",
    "ProgramCost", "record_program", "ledger", "clear_ledger",
    "reset_exec_stats", "roofline_rows", "extract_cost", "peak_gbps",
    "write_baseline", "audit_cost_regressions",
]
