"""Stdlib /metrics + /healthz endpoint for the serving path.

Port of paddle_tpu/obs/http.py. ``serve_metrics(port, registry)`` starts
a daemon-thread ``ThreadingHTTPServer`` exposing:

  * ``/metrics``  — the Prometheus text exposition of the base registry
    plus every registered engine's registry with an ``engine="<name>"``
    label stamped on its samples: one scrape target covers N
    ``ServingEngine`` instances in one process.
  * ``/healthz``  — readiness, not just liveness: with engines
    registered it returns 200 ``ready`` only once every registered
    engine's readiness probe passes (a ``ServingEngine`` turns ready at
    ``finish_warmup()``), 503 ``warming`` before that; with none
    registered it stays the plain 200 ``ok`` liveness check.
  * ``/healthz?engine=NAME``  — the named engine's readiness alone; 404
    ``unknown engine`` when NAME is not registered.

No dependency beyond the stdlib, read-only. Engines attach when
``FLAGS_obs_http_port`` > 0: the first engine creates the shared server
(``shared_server(port)``), later engines register into it.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer



class MetricsServer:
    def __init__(self, port: int, registry, host: str = "127.0.0.1"):
        self.registry = registry
        self._lock = threading.Lock()
        # name -> (registry, ready_fn) — mutated under _lock, read by
        # the handler thread (dict snapshot per request)
        self._engines: dict = {}      # guarded-by: _lock
        self._closed = False          # guarded-by: _lock
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                path = self.path.split("?")[0]
                if path == "/metrics":
                    body = srv.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                elif path == "/healthz":
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    name = q.get("engine", [None])[0]
                    ready, body = srv.health(engine=name)
                    body = body.encode()
                    if ready:
                        code = 200
                    else:
                        code = 404 if body.startswith(b"unknown") else 503
                    self.send_response(code)
                    self.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # no per-request stderr lines
                return None

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self.port = self._httpd.server_address[1]  # resolved (port=0 OK)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=f"obs-metrics-:{self.port}",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------ multi-engine
    def register_engine(self, name: str, registry, ready=None):
        """Attach one engine's registry (exported with
        ``engine="<name>"`` labels) and its readiness probe (a callable;
        ``ServingEngine`` passes ``lambda: self.warmed``)."""
        with self._lock:
            self._engines[str(name)] = (registry, ready)
        return self

    def unregister_engine(self, name: str):
        with self._lock:
            self._engines.pop(str(name), None)

    def engines(self) -> list[str]:
        with self._lock:
            return sorted(self._engines)

    def render(self) -> str:
        """The /metrics body: base registry samples bare, engine
        registries with an ``engine`` label — merged PER METRIC NAME so
        each name gets exactly one HELP/TYPE group (the text format
        rejects duplicates, which a naive per-registry concatenation
        produced when two engines shared a metric name)."""
        with self._lock:
            engines = dict(self._engines)
        sources = []
        if self.registry is not None:
            sources.append((self.registry, ()))
        for name in sorted(engines):
            sources.append((engines[name][0], (("engine", name),)))
        from .metrics import _escape_help

        # group by FULL (namespaced) metric name: one HELP/TYPE each
        names: dict = {}          # full name -> (bare name, first reg)
        for reg, _ in sources:
            ns = reg.namespace
            for n in reg.names():
                names.setdefault(f"{ns}_{n}" if ns else n, (n, reg))
        lines = []
        for full in sorted(names):
            n, first = names[full]
            m = first.get(n)
            lines.append(f"# HELP {full} {_escape_help(m.doc or n)}")
            lines.append(f"# TYPE {full} {m.kind}")
            for reg, extra in sources:
                if (f"{reg.namespace}_{n}" if reg.namespace else n) == full:
                    lines.extend(reg._render_samples(n, extra))
        return "\n".join(lines) + ("\n" if lines else "")

    def health(self, engine: str | None = None) -> tuple[bool, str]:
        """Aggregate readiness, or — with ``engine`` (the
        ``/healthz?engine=NAME`` probe) — the named engine's alone: a
        router admits a warmed replica while its peers still warm."""
        with self._lock:
            engines = dict(self._engines)
        if engine is not None:
            if engine not in engines:
                return False, f"unknown engine: {engine}\n"
            _, ready = engines[engine]
            if ready is not None and not ready():
                return False, f"warming: {engine}\n"
            return True, "ready\n"
        if not engines:
            return True, "ok\n"
        warming = sorted(name for name, (_, ready) in engines.items()
                         if ready is not None and not ready())
        if warming:
            return False, "warming: " + ",".join(warming) + "\n"
        return True, "ready\n"

    def close(self):
        """Idempotent under concurrent callers: the first caller through
        the flag tears the server down, every later or concurrent close()
        is a no-op."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        with self._lock:
            self._engines.clear()
        with _SERVERS_LOCK:
            for p in [p for p, s in _SERVERS.items() if s is self]:
                del _SERVERS[p]


def serve_metrics(port: int, registry=None, host: str = "127.0.0.1"
                  ) -> MetricsServer:
    """Start the endpoint; returns the server (``.port`` is the bound
    port — pass 0 to let the OS pick, handy in tests)."""
    if registry is None:
        from . import default_registry

        registry = default_registry()
    return MetricsServer(port, registry, host=host)


#: per-port shared servers (the FLAGS_obs_http_port path): engines in
#: one process scrape through ONE endpoint instead of fighting the bind
_SERVERS_LOCK = threading.Lock()
_SERVERS: dict = {}           # guarded-by: _SERVERS_LOCK


def shared_server(port: int, host: str = "127.0.0.1") -> MetricsServer:
    """Get-or-create the process-shared server for ``port`` (base body =
    the process-default registry; engines register on top). Port 0 means
    "any free port" and always creates a fresh server — only resolved
    ports are shared."""
    with _SERVERS_LOCK:
        srv = _SERVERS.get(int(port)) if int(port) != 0 else None
        if srv is None:
            from . import default_registry

            srv = MetricsServer(port, default_registry(), host=host)
            _SERVERS[srv.port] = srv
        return srv
