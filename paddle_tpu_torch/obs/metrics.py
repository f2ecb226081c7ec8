"""Metrics registry — the runtime telemetry substrate of the serving
engine.

Port of paddle_tpu/obs/metrics.py: the Prometheus data model (Counter /
Gauge / Histogram with labels), two exporters (the JSONL event log at
``FLAGS_obs_log_path``; the Prometheus text exposition of
``render_prometheus()`` and the stdlib ``/metrics`` endpoint of
obs/http.py), and a hot path cheap enough for the serving engine's
per-tick loop. Same metric names, types, label names, help strings,
quantile rules, escaping and float spellings as the reference; the
exposition prefixes every family with the registry namespace
``paddle_tpu`` (the reference's), so one dashboard reads either package.
The reference's lock-order checker (``core.lockdep``) is left out by
design (ROADMAP Queue 1 item 1): plain ``threading`` locks stand in.

Hot path:

* no locks on observe/inc — a sample is one dict lookup (pre-resolved by
  ``labels()`` at setup time into a child handle) plus 2-4 Python
  attribute updates. Under the GIL a lost increment race is the worst
  case; correctness-critical counting (tokens emitted, requests
  completed) happens in the scheduler's own state, the registry only
  mirrors it.
* Histograms keep both forms: fixed cumulative buckets (Prometheus
  ``le`` semantics, one bisect per observe) and an exact-sample ring
  (capped), so small populations (per-request TTFTs) quote exact
  quantiles while unbounded ones (per-tick decode wall) degrade to
  bucket interpolation instead of growing without bound.
* Label cardinality is capped per metric (default 64 label sets): past
  the cap new label sets collapse into one reserved ``__overflow__``
  child and ``dropped_label_sets`` counts them.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
import time

#: reserved child absorbing label sets past the cardinality cap
OVERFLOW = "__overflow__"

#: default per-metric label-set cap (the cardinality bomb guard)
DEFAULT_LABEL_CAP = 64

#: default fixed bucket ladder: latency-flavored seconds, 100us..~2min —
#: wide enough for TTFT (ms..s) and compile walls (s..min) alike
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

#: exact-sample ring size for histogram quantiles (beyond: interpolation)
DEFAULT_EXACT_CAP = 4096


def _label_key(labelnames, labelvalues):
    return tuple(str(v) for v in labelvalues)


class _Metric:
    """Shared parent bookkeeping: named children per label set, capped."""

    kind = "untyped"

    def __init__(self, name: str, doc: str, labelnames=(),
                 label_cap: int = DEFAULT_LABEL_CAP):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self.label_cap = int(label_cap)
        # setup-time only (labels() at instrument-site creation); the
        # observe/inc hot path never takes it
        self._setup_lock = threading.Lock()
        self.dropped_label_sets = 0      # guarded-by: _setup_lock
        # mutations guarded; the labels() fast path reads lock-free (a
        # memoized child handle — last-write-wins is the documented
        # statsd-style contract)
        self._children: dict[tuple, _Metric] = {}  # guarded-by: _setup_lock

    def labels(self, *labelvalues, **labelkv):
        """Resolve (and memoize) the child for one label set. Call this at
        instrumentation-SETUP time and keep the handle — the per-sample
        path is then just child.inc()/observe()."""
        if labelkv:
            if labelvalues:
                raise ValueError("pass labels positionally or by name, "
                                 "not both")
            try:
                labelvalues = tuple(labelkv[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"metric {self.name} has labels {self.labelnames}, "
                    f"got {sorted(labelkv)}") from e
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects {len(self.labelnames)} label "
                f"value(s) {self.labelnames}, got {labelvalues!r}")
        key = _label_key(self.labelnames, labelvalues)
        child = self._children.get(key)
        if child is not None:
            return child
        with self._setup_lock:
            child = self._children.get(key)
            if child is not None:
                return child
            if len(self._children) >= self.label_cap:
                self.dropped_label_sets += 1
                key = (OVERFLOW,) * len(self.labelnames)
                child = self._children.get(key)
                if child is not None:
                    return child
            child = self._make_child()
            self._children[key] = child
            return child

    def _make_child(self):
        raise NotImplementedError

    # -- introspection
    def samples(self):
        """[(labelvalues_tuple, child)] — parent included when unlabeled."""
        if not self.labelnames:
            return [((), self)]
        return sorted(self._children.items())


class Counter(_Metric):
    """Monotonically increasing count. ``inc()`` is the whole hot path."""

    kind = "counter"

    def __init__(self, name, doc, labelnames=(), label_cap=DEFAULT_LABEL_CAP):
        super().__init__(name, doc, labelnames, label_cap)
        self.value = 0.0

    def _make_child(self):
        return Counter(self.name, self.doc)

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += n


class Gauge(_Metric):
    """Point-in-time value (queue depth, pool occupancy)."""

    kind = "gauge"

    def __init__(self, name, doc, labelnames=(), label_cap=DEFAULT_LABEL_CAP):
        super().__init__(name, doc, labelnames, label_cap)
        self.value = 0.0

    def _make_child(self):
        return Gauge(self.name, self.doc)

    def set(self, v):
        self.value = float(v)

    def inc(self, n=1.0):
        self.value += n

    def dec(self, n=1.0):
        self.value -= n


class Histogram(_Metric):
    """Fixed cumulative buckets + exact-sample ring.

    ``quantile(q)`` is exact while the population fits ``exact_cap``
    (TTFT-per-request scale), linear-interpolated from the bucket counts
    past it (per-step scale)."""

    kind = "histogram"

    def __init__(self, name, doc, labelnames=(), buckets=DEFAULT_BUCKETS,
                 exact_cap=DEFAULT_EXACT_CAP, label_cap=DEFAULT_LABEL_CAP):
        super().__init__(name, doc, labelnames, label_cap)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.exact_cap = int(exact_cap)
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0
        self._exact: list[float] = []
        self._exact_i = 0  # ring cursor once the cap is hit

    def _make_child(self):
        return Histogram(self.name, self.doc, buckets=self.buckets,
                         exact_cap=self.exact_cap)

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
        if len(self._exact) < self.exact_cap:
            self._exact.append(v)
        else:
            self._exact[self._exact_i] = v
            self._exact_i = (self._exact_i + 1) % self.exact_cap

    @property
    def exact(self) -> bool:
        """True while quantiles come from the full sample population."""
        return self.count <= self.exact_cap

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return float("nan")
        if self.exact:
            s = sorted(self._exact)
            return s[min(len(s) - 1, int(math.ceil(q * len(s))) - 1)] \
                if q > 0 else s[0]
        # bucket interpolation over cumulative counts (Prometheus
        # histogram_quantile semantics: linear within the hit bucket)
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, c in enumerate(self.bucket_counts):
            if c == 0:
                lo = self.buckets[i] if i < len(self.buckets) else lo
                continue
            if cum + c >= target:
                hi = self.buckets[i] if i < len(self.buckets) \
                    else self.buckets[-1]
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
            lo = self.buckets[i] if i < len(self.buckets) else lo
        return self.buckets[-1]

    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")


class Registry:
    """One namespace of metrics. The process default lives in
    obs/__init__ (``default_registry()``); the serving engine builds its
    own per instance so concurrent engines never share counters."""

    def __init__(self, namespace: str = "paddle_tpu"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}   # guarded-by: _lock

    def _get_or_make(self, cls, name, doc, labelnames, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, doc, labelnames, **kw)
                    self._metrics[name] = m
                    return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labelnames}")
        if "buckets" in kw and m.buckets != tuple(sorted(
                float(b) for b in kw["buckets"])):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{m.buckets}; a second ladder would silently skew its "
                "interpolated quantiles")
        return m

    def counter(self, name, doc="", labelnames=(), **kw) -> Counter:
        return self._get_or_make(Counter, name, doc, labelnames, **kw)

    def gauge(self, name, doc="", labelnames=(), **kw) -> Gauge:
        return self._get_or_make(Gauge, name, doc, labelnames, **kw)

    def histogram(self, name, doc="", labelnames=(), buckets=DEFAULT_BUCKETS,
                  **kw) -> Histogram:
        return self._get_or_make(Histogram, name, doc, labelnames,
                                 buckets=buckets, **kw)

    def get(self, name) -> _Metric | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self):
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------ export
    def to_dict(self) -> dict:
        """Snapshot for `ServingEngine.metrics()`: plain JSON-able values,
        histograms summarized."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            rows = []
            for labelvalues, child in m.samples():
                labels = dict(zip(m.labelnames, labelvalues))
                if m.kind == "histogram":
                    row = {"count": child.count, "sum": child.sum,
                           "mean": (child.mean() if child.count else None),
                           "p50": (child.quantile(0.5) if child.count
                                   else None),
                           "p95": (child.quantile(0.95) if child.count
                                   else None),
                           "p99": (child.quantile(0.99) if child.count
                                   else None),
                           "exact": child.exact}
                else:
                    row = {"value": child.value}
                if labels:
                    row["labels"] = labels
                rows.append(row)
            out[name] = {"kind": m.kind, "doc": m.doc,
                         "dropped_label_sets": m.dropped_label_sets,
                         "samples": rows}
        return out

    def _render_samples(self, name: str, extra_labels=()) -> list:
        """Sample lines (no HELP/TYPE) for one metric, with
        ``extra_labels`` pairs injected — the multi-registry /metrics
        endpoint merges same-named metrics across engine registries this
        way (the text format forbids a second HELP/TYPE group for one
        metric name, so the merge has to happen at the sample level)."""
        m = self._metrics.get(name)
        if m is None:
            return []
        ns = self.namespace
        full = f"{ns}_{name}" if ns else name
        extra = tuple(extra_labels)
        lines = []
        for labelvalues, child in m.samples():
            base = extra + tuple(zip(m.labelnames, labelvalues))
            lab = _fmt_labels(base)
            if m.kind == "histogram":
                cum = 0
                for b, c in zip(child.buckets, child.bucket_counts):
                    cum += c
                    lines.append(
                        f"{full}_bucket{_fmt_labels(base, ('le', _fmt_float(b)))} {cum}")
                lines.append(
                    f"{full}_bucket{_fmt_labels(base, ('le', '+Inf'))} {child.count}")
                lines.append(f"{full}_sum{lab} {_fmt_float(child.sum)}")
                lines.append(f"{full}_count{lab} {child.count}")
            else:
                lines.append(f"{full}{lab} {_fmt_float(child.value)}")
        return lines

    def render_prometheus(self, extra_labels=()) -> str:
        """Prometheus text exposition format 0.0.4 (the /metrics body).
        ``extra_labels`` — ((name, value), ...) — is injected into every
        sample line."""
        ns = self.namespace
        lines = []
        for name, m in sorted(self._metrics.items()):
            full = f"{ns}_{name}" if ns else name
            lines.append(f"# HELP {full} {_escape_help(m.doc or name)}")
            lines.append(f"# TYPE {full} {m.kind}")
            lines.extend(self._render_samples(name, extra_labels))
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_float(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"           # text-format spec spells the specials
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_labels(pairs, extra=None):
    parts = [f'{n}="{_escape(v)}"' for n, v in pairs]
    if extra is not None:
        parts.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    """Label-value escaping per the Prometheus text format 0.0.4: inside
    double quotes, backslash, double-quote and line feed must escape (in
    this order — escaping the backslash LAST would re-escape the
    escapes)."""
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n",
                                                                   r"\n")


def _escape_help(v: str) -> str:
    """HELP-line escaping: backslash and line feed only (quotes are legal
    there): a metric doc containing a newline would otherwise tear the
    exposition into an unparseable line."""
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


# ----------------------------------------------------------- JSONL export
class _JsonlSink:
    """Append-only JSONL event log at FLAGS_obs_log_path. The file handle
    opens lazily on first event and re-opens when the flag changes (tests
    point it at tmp paths); line-buffered so a crashed process leaves
    whole lines.

    Size-capped rotation: past
    ``FLAGS_obs_log_max_mb`` the file rolls to ``<path>.1`` (older rolls
    shift to ``.2`` .. ``.N``, ``FLAGS_obs_log_backups``; the oldest is
    deleted). Rotation happens BETWEEN records under the sink lock, so a
    rollover can never tear a JSON line — every line in every file of
    the set parses."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fh = None       # guarded-by: _lock
        self._path = None     # guarded-by: _lock
        self._bytes = 0       # guarded-by: _lock

    def _open(self, path):  # requires-lock: _lock
        import os

        self._fh = open(path, "a", buffering=1)
        self._path = path
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0

    def _handle(self):  # requires-lock: _lock
        from ..core.flags import flag

        path = str(flag("FLAGS_obs_log_path") or "")
        if not path:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
                self._path = None
            return None
        if path != self._path:
            if self._fh is not None:
                self._fh.close()
            self._open(path)
        return self._fh

    def _rotate(self):  # requires-lock: _lock
        import os

        from ..core.flags import flag

        backups = max(1, int(flag("FLAGS_obs_log_backups")))
        self._fh.close()
        oldest = f"{self._path}.{backups}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(backups - 1, 0, -1):
            src = f"{self._path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self._path}.{i + 1}")
        os.replace(self._path, f"{self._path}.1")
        self._open(self._path)

    def emit(self, kind: str, payload: dict):
        from ..core.flags import flag

        with self._lock:
            fh = self._handle()
            if fh is None:
                return False
            rec = {"t": time.time(), "kind": kind}
            rec.update(payload)
            line = json.dumps(rec) + "\n"
            cap = int(flag("FLAGS_obs_log_max_mb")) * 1024 * 1024
            if cap > 0 and self._bytes and self._bytes + len(line) > cap:
                self._rotate()
                fh = self._fh
            fh.write(line)
            self._bytes += len(line)
            return True


_sink = _JsonlSink()


def log_event(kind: str, **payload) -> bool:
    """One structured event onto the JSONL log (no-op with the flag
    unset). Compile events, admission decisions and logger records all
    funnel through here so one tail -f shows the runtime's story."""
    return _sink.emit(kind, payload)


def dump_registry(registry: Registry, path: str | None = None) -> bool:
    """Write a full registry snapshot as one JSONL `metrics` event (to
    `path` when given, else the flag sink)."""
    if path is not None:
        with open(path, "a", buffering=1) as fh:
            rec = {"t": time.time(), "kind": "metrics",
                   "metrics": registry.to_dict()}
            fh.write(json.dumps(rec) + "\n")
        return True
    return log_event("metrics", metrics=registry.to_dict())
