"""Per-request flight recorder — the record that explains a TTFT p95.

Port of paddle_tpu/obs/flight.py. Every request riding a
``ServingEngine`` carries an ordered span timeline — enqueue, admission
(with how many scheduler ticks it sat blocked on the block pool), its
prefix-cache hit and copy-on-write, the prefill program or each prefill
chunk, the decode phase, its finish or timeout reason — held in a
bounded ring beside an engine-level track of decode ticks and verify
windows. ``ServingEngine.dump_trace(path)`` exports the ring as
Chrome-trace JSON (the ``traceEvents`` format Perfetto and
``chrome://tracing`` load), and anomaly triggers (request timeout, TTFT
SLO breach, post-warmup capture) auto-dump a postmortem to
``FLAGS_obs_flight_dir``.

The TTFT invariant is asserted, not assumed: a request's ``queue_wait``
span ends exactly where its ``prefill`` span begins, and the two tile
the engine's recorded TTFT bitwise (they come from the same three
timestamps the histograms observe: arrival, admission, first token).
``dump()`` raises on a violation, and every span's args carry the exact
float seconds (``t0_s``/``t1_s``), so the dumped JSON round-trips the
invariant (the microsecond ``ts``/``dur`` fields are for the viewer).
On a card the program spans end after the device finished: a token's
read-back, or a stream sync for a chunk that emits none.

Bounds: finished flights are a ring (``FLAGS_obs_flight_requests``; the
oldest finished flight is evicted, active requests never are), per-flight
span lists are capped, and the engine track is a fixed deque. Per token
the hot path costs two attribute writes; spans are appended per program
call (ticks and chunks), not per token.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict, deque

from ..core.flags import flag

#: engine-track spans kept (decode ticks, chunk phases): one per
#: scheduler tick, so this window covers the last ~4k ticks
TICK_SPAN_CAP = 4096

#: per-flight program-span cap: chunks/prefill programs past it are
#: counted (``spans_dropped``) instead of stored
REQUEST_SPAN_CAP = 512

#: auto-dumps per recorder: a flapping SLO must not fill the disk —
#: the dumps counter keeps counting, the files stop
AUTODUMP_CAP = 16


class RequestFlight:
    """One request's timeline. Timestamps are ``time.perf_counter``
    seconds, the same clock (and for the lifecycle marks, the same
    *reads*) the engine's histograms observe."""

    __slots__ = ("rid", "prompt_len", "max_new_tokens", "arrival_s",
                 "admitted_s", "first_token_s", "last_token_s",
                 "finish_s", "reason", "cached_blocks", "cow",
                 "blocked_ticks", "tokens", "chunks", "spans",
                 "spans_dropped", "marks", "ttft_s")

    def __init__(self, rid, prompt_len, max_new_tokens, arrival_s):
        self.rid = int(rid)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.arrival_s = float(arrival_s)
        self.admitted_s = None
        self.first_token_s = None
        self.last_token_s = None
        self.finish_s = None
        self.reason = None
        self.cached_blocks = 0
        self.cow = False
        self.blocked_ticks = 0
        self.tokens = 0
        self.chunks = 0
        self.spans: list = []        # (name, t0, t1, args) program spans
        self.spans_dropped = 0
        self.marks: list = []        # (name, t, args) instantaneous
        self.ttft_s = None           # engine-recorded, for the assertion

    def add_span(self, name, t0, t1, args=None):
        if len(self.spans) >= REQUEST_SPAN_CAP:
            self.spans_dropped += 1
            return
        self.spans.append((name, float(t0), float(t1), args or {}))

    def add_mark(self, name, t, args=None):
        if len(self.marks) < REQUEST_SPAN_CAP:
            self.marks.append((name, float(t), args or {}))

    @property
    def finished(self) -> bool:
        return self.finish_s is not None


class FlightRecorder:
    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = int(flag("FLAGS_obs_flight_requests"))
        self.capacity = max(1, int(capacity))
        self._flights: "OrderedDict[int, RequestFlight]" = OrderedDict()
        self._finished: deque = deque()   # rids in finish order
        self._ticks: deque = deque(maxlen=TICK_SPAN_CAP)
        self.evicted = 0
        self.autodumps = 0
        self.autodump_paths: list[str] = []

    # ----------------------------------------------------------- record
    def begin(self, rid, prompt_len, max_new_tokens, arrival_s
              ) -> RequestFlight:
        fl = RequestFlight(rid, prompt_len, max_new_tokens, arrival_s)
        self._flights[rid] = fl
        return fl

    def get(self, rid) -> RequestFlight | None:
        return self._flights.get(rid)

    def tick_span(self, name, t0, t1, **args):
        """One engine-track span (decode tick / chunk phase)."""
        self._ticks.append((name, float(t0), float(t1), args))

    def tick_mark(self, name, t, **args):
        self._ticks.append((name, float(t), None, args))

    def finish(self, rid, t, reason):
        fl = self._flights.get(rid)
        if fl is None:
            return
        fl.finish_s = float(t)
        fl.reason = reason
        self._finished.append(rid)
        while len(self._finished) > self.capacity:
            old = self._finished.popleft()
            if self._flights.pop(old, None) is not None:
                self.evicted += 1

    # ----------------------------------------------------------- export
    def flights(self) -> list[RequestFlight]:
        return list(self._flights.values())

    def _check_tiling(self):
        """The TTFT invariant: queue_wait and prefill spans are derived
        from the SAME timestamps the histograms observed, are contiguous
        by construction, and must sum to the recorded TTFT bitwise."""
        for fl in self._flights.values():
            if fl.first_token_s is None:
                continue
            if fl.admitted_s is None:
                raise AssertionError(
                    f"flight {fl.rid}: first token without an admission "
                    "timestamp — the queue_wait span cannot tile TTFT")
            if not (fl.arrival_s <= fl.admitted_s <= fl.first_token_s):
                raise AssertionError(
                    f"flight {fl.rid}: non-monotonic lifecycle "
                    f"({fl.arrival_s} -> {fl.admitted_s} -> "
                    f"{fl.first_token_s})")
            if fl.ttft_s is not None and \
                    (fl.first_token_s - fl.arrival_s) != fl.ttft_s:
                raise AssertionError(
                    f"flight {fl.rid}: span endpoints do not tile the "
                    f"recorded TTFT ({fl.first_token_s - fl.arrival_s!r} "
                    f"!= {fl.ttft_s!r}) — the engine's timestamp "
                    "bookkeeping and the recorder's diverged")

    def to_chrome(self) -> dict:
        """Chrome-trace/Perfetto ``traceEvents`` JSON (object form).
        One process, tid 0 = the engine scheduler track, tid rid+1 per
        request; complete (``ph:"X"``) events carry exact seconds in
        ``args`` — ts/dur microseconds are viewer-resolution only."""
        self._check_tiling()
        times = [fl.arrival_s for fl in self._flights.values()]
        times += [t0 for _, t0, _, _ in self._ticks]
        epoch = min(times) if times else 0.0

        def us(t):
            return (t - epoch) * 1e6

        ev: list[dict] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "paddle_tpu_torch serving"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
             "args": {"name": "engine"}},
        ]
        for name, t0, t1, args in self._ticks:
            if t1 is None:
                ev.append({"ph": "i", "pid": 1, "tid": 0, "name": name,
                           "ts": us(t0), "s": "t",
                           "args": dict(args, t_s=t0)})
            else:
                ev.append({"ph": "X", "pid": 1, "tid": 0, "name": name,
                           "ts": us(t0), "dur": (t1 - t0) * 1e6,
                           "cat": "engine",
                           "args": dict(args, t0_s=t0, t1_s=t1)})
        for fl in self._flights.values():
            tid = fl.rid + 1
            ev.append({"ph": "M", "pid": 1, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": f"request {fl.rid}"}})
            end = fl.finish_s or fl.last_token_s or fl.first_token_s \
                or fl.admitted_s or fl.arrival_s
            # a mid-flight dump (anomaly postmortem while this request
            # is still prefilling) has lifecycle timestamps that stop at
            # admission while chunk spans/marks run past it — the window
            # must cover them or validate_trace rejects the postmortem
            for _, _, t1, _ in fl.spans:
                end = max(end, t1)
            for _, t, _ in fl.marks:
                end = max(end, t)
            ev.append({"ph": "X", "pid": 1, "tid": tid, "name": "request",
                       "ts": us(fl.arrival_s),
                       "dur": (end - fl.arrival_s) * 1e6, "cat": "request",
                       "args": {"rid": fl.rid, "prompt_len": fl.prompt_len,
                                "max_new_tokens": fl.max_new_tokens,
                                "tokens": fl.tokens,
                                "reason": fl.reason,
                                "cached_blocks": fl.cached_blocks,
                                "cow": fl.cow,
                                "blocked_ticks": fl.blocked_ticks,
                                "spans_dropped": fl.spans_dropped,
                                "t0_s": fl.arrival_s, "t1_s": end}})
            if fl.admitted_s is not None:
                ev.append({"ph": "X", "pid": 1, "tid": tid,
                           "name": "queue_wait", "ts": us(fl.arrival_s),
                           "dur": (fl.admitted_s - fl.arrival_s) * 1e6,
                           "cat": "lifecycle",
                           "args": {"blocked_ticks": fl.blocked_ticks,
                                    "t0_s": fl.arrival_s,
                                    "t1_s": fl.admitted_s}})
            if fl.first_token_s is not None:
                ev.append({"ph": "X", "pid": 1, "tid": tid,
                           "name": "prefill", "ts": us(fl.admitted_s),
                           "dur": (fl.first_token_s - fl.admitted_s) * 1e6,
                           "cat": "lifecycle",
                           "args": {"cached_blocks": fl.cached_blocks,
                                    "cow": fl.cow, "chunks": fl.chunks,
                                    "ttft_s": fl.ttft_s,
                                    "t0_s": fl.admitted_s,
                                    "t1_s": fl.first_token_s}})
            if fl.first_token_s is not None and fl.last_token_s is not None \
                    and fl.last_token_s > fl.first_token_s:
                ev.append({"ph": "X", "pid": 1, "tid": tid,
                           "name": "decode", "ts": us(fl.first_token_s),
                           "dur": (fl.last_token_s - fl.first_token_s)
                           * 1e6, "cat": "lifecycle",
                           "args": {"tokens": fl.tokens,
                                    "t0_s": fl.first_token_s,
                                    "t1_s": fl.last_token_s}})
            for name, t0, t1, args in fl.spans:
                ev.append({"ph": "X", "pid": 1, "tid": tid, "name": name,
                           "ts": us(t0), "dur": (t1 - t0) * 1e6,
                           "cat": "program",
                           "args": dict(args, t0_s=t0, t1_s=t1)})
            for name, t, args in fl.marks:
                ev.append({"ph": "i", "pid": 1, "tid": tid, "name": name,
                           "ts": us(t), "s": "t",
                           "args": dict(args, t_s=t)})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"source": "paddle_tpu_torch.obs.flight",
                              "flights": len(self._flights),
                              "evicted": self.evicted,
                              "epoch_s": epoch}}

    def dump(self, path: str) -> str:
        obj = self.to_chrome()
        with open(path, "w") as fh:
            json.dump(obj, fh)
        return path

    # ---------------------------------------------------------- anomaly
    def anomaly_dump(self, trigger: str) -> str | None:
        """Postmortem auto-dump: write the current ring to
        FLAGS_obs_flight_dir (created on demand), capped at
        AUTODUMP_CAP files per recorder. Returns the path, or None when
        disabled/capped. Never raises — a broken postmortem path must
        not take the serving loop down."""
        d = str(flag("FLAGS_obs_flight_dir") or "")
        if not d or self.autodumps >= AUTODUMP_CAP:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{trigger}_{os.getpid()}_{self.autodumps}.json")
            self.dump(path)
        except Exception:
            return None
        self.autodumps += 1
        self.autodump_paths.append(path)
        return path


# ------------------------------------------------------------ validation
def validate_trace(obj_or_path) -> dict:
    """Structural validation of a dumped trace — the re-parse half of the
    Perfetto round trip. Verifies: JSON loads, the
    traceEvents array exists, every complete event has non-negative
    ``dur``, per-request lifecycle spans NEST (queue_wait and prefill
    inside the request span, programs inside the request span) and TILE
    (queue_wait ends exactly where prefill begins, and their exact-
    seconds args reproduce ``ttft_s`` bitwise). Raises ValueError on any
    violation; returns a summary dict."""
    if isinstance(obj_or_path, (str, os.PathLike)):
        with open(obj_or_path) as fh:
            obj = json.load(fh)
    else:
        obj = obj_or_path
    source = (obj.get("otherData") or {}).get("source", "")
    if source.endswith("train_flight"):
        # the training flight recorder's step timelines
        from .train_flight import validate_train_trace

        return validate_train_trace(obj)
    evs = obj.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("trace has no traceEvents array")
    by_tid: dict = {}
    for e in evs:
        if e.get("ph") == "X":
            if e.get("dur", 0) < 0:
                raise ValueError(f"negative-duration span: {e}")
            by_tid.setdefault(e["tid"], {}).setdefault(
                e["name"], []).append(e)
    requests = 0
    tiled = 0
    for tid, spans in by_tid.items():
        if "request" not in spans:
            continue
        requests += 1
        req = spans["request"][0]["args"]
        lo, hi = req["t0_s"], req["t1_s"]
        for name, group in spans.items():
            for s in group:
                a = s["args"]
                if not (lo <= a["t0_s"] and a["t1_s"] <= hi):
                    raise ValueError(
                        f"span {name!r} escapes its request window on "
                        f"tid {tid}: [{a['t0_s']}, {a['t1_s']}] outside "
                        f"[{lo}, {hi}]")
        if "queue_wait" in spans and "prefill" in spans:
            q = spans["queue_wait"][0]["args"]
            p = spans["prefill"][0]["args"]
            if q["t1_s"] != p["t0_s"]:
                raise ValueError(
                    f"tid {tid}: queue_wait does not end where prefill "
                    f"begins ({q['t1_s']!r} != {p['t0_s']!r})")
            ttft = p.get("ttft_s")
            if ttft is not None and (p["t1_s"] - q["t0_s"]) != ttft:
                raise ValueError(
                    f"tid {tid}: spans do not tile TTFT "
                    f"({p['t1_s'] - q['t0_s']!r} != {ttft!r})")
            tiled += 1
    return {"events": len(evs), "requests": requests,
            "tiled_requests": tiled,
            "engine_spans": len(by_tid.get(0, {}).get("decode_tick", [])),
            "verify_spans": len(by_tid.get(0, {}).get("verify_window", []))}
