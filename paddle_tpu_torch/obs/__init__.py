"""paddle_tpu_torch.obs — runtime telemetry: metrics, spans, compile
watchdog, structured logging, the request flight recorder.

Port of the serving half of paddle_tpu/obs, the same public names,
metric names, types, label names and help strings:

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
    post-warmup captures into ``analysis.Finding``s.
  * **logging**  — module-scoped VLOG driven by ``FLAGS_log_level`` with
    per-message rate limiting.
  * **flight**   — the serving engine's per-request span timelines,
    Chrome-trace dumps and anomaly postmortems.

Not ported yet (ROADMAP Queue 1): the cost ledger (``obs/costs.py``,
fed by XLA's cost_analysis in the reference), the training flight
recorder and goodput accounting (``train_flight``, ``goodput``) with
``metrics_enabled`` and ``FLAGS_obs_metrics``, the opt-in that only
their caller ``hapi`` reads, and the checkpoint-save audit
(``record_ckpt_save``, ``ckpt_save_events``, ``audit_ckpt_stalls``),
which waits for the checkpoint writer that feeds it.

Overhead: the serving engine records into its registry and flight
recorder on every tick; the watchdog records every compile event.
"""
from __future__ import annotations

from .flight import FlightRecorder, RequestFlight, validate_trace
from .http import MetricsServer, serve_metrics, shared_server
from .logging import ObsLogger, get_logger
from .metrics import (DEFAULT_BUCKETS, OVERFLOW, Counter, Gauge, Histogram,
                      Registry, dump_registry, log_event)
from .trace import (capture_trace, clear_spans, span, span_events,
                    step_span)
from .watchdog import (CompileEvent, audit_recompiles, clear_events,
                       compile_counts, compile_events, jaxpr_size,
                       post_warmup_compiles, record_compile)

#: process-default registry: compile watchdog counters, anything not tied
#: to one engine instance
_default = Registry()


def default_registry() -> Registry:
    return _default


def render_prometheus() -> str:
    """Prometheus text exposition of the default registry."""
    return _default.render_prometheus()


__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "DEFAULT_BUCKETS",
    "OVERFLOW", "default_registry", "render_prometheus",
    "dump_registry", "log_event",
    "span", "step_span", "span_events", "clear_spans", "capture_trace",
    "CompileEvent", "record_compile", "compile_events", "compile_counts",
    "post_warmup_compiles", "clear_events", "audit_recompiles",
    "jaxpr_size",
    "get_logger", "ObsLogger",
    "serve_metrics", "MetricsServer", "shared_server",
    "FlightRecorder", "RequestFlight", "validate_trace",
]
