"""Structured runtime logger, driven by FLAGS_log_level.

Port of paddle_tpu/obs/logging.py (glog's VLOG(n) + LOG(WARNING) as the
reference's C++ uses them):

  * module-scoped loggers: ``log = obs.get_logger(__name__)``; every
    record carries the module tag (the package prefix dropped);
  * VLOG semantics: ``log.vlog(2, ...)`` prints only when
    ``FLAGS_log_level >= 2``; ``info`` is vlog(1); ``warning``/``error``
    always print (to stderr, like glog), tagged ``[paddle_tpu:<module>]``
    as the reference's, so one log filter reads either package;
  * rate limiting per (logger, message key): a repeating message (the
    serving engine's admission-blocked path can fire every tick) prints
    at most once per window (default 5 s) and reports how many repeats
    were suppressed when it next prints;
  * every record that passes the level check also lands on the JSONL
    event log (FLAGS_obs_log_path), unrated;
  * ``warning(..., also_warn=True)`` also raises a Python
    ``warnings.warn`` for callers that read warnings.
"""
from __future__ import annotations

import sys
import threading
import time
import warnings as _warnings

from ..core.flags import flag
from . import metrics as _metrics

#: default suppression window for repeated messages (seconds)
RATE_WINDOW_S = 5.0

_lock = threading.Lock()
_loggers: dict[str, "ObsLogger"] = {}   # guarded-by: _lock


def get_logger(module: str) -> "ObsLogger":
    lg = _loggers.get(module)
    if lg is None:
        with _lock:
            lg = _loggers.get(module)
            if lg is None:
                lg = ObsLogger(module)
                _loggers[module] = lg
    return lg


class ObsLogger:
    __slots__ = ("module", "_last", "_suppressed", "suppressed_total")

    def __init__(self, module: str):
        self.module = module.removeprefix("paddle_tpu_torch.")
        self._last: dict[str, float] = {}    # message key -> last print t
        self._suppressed: dict[str, int] = {}
        self.suppressed_total = 0

    # ------------------------------------------------------------- core
    def _emit(self, severity: str, msg: str, key: str | None,
              rate_s: float, fields: dict):
        now = time.perf_counter()
        k = key if key is not None else msg[:80]
        last = self._last.get(k)
        if last is not None and rate_s > 0 and now - last < rate_s:
            self._suppressed[k] = self._suppressed.get(k, 0) + 1
            self.suppressed_total += 1
            # the JSONL sink still sees every record (machines don't
            # need rate limiting; the flag gates the file entirely)
            _metrics.log_event("log", severity=severity,
                               module=self.module, msg=msg,
                               suppressed=True, **fields)
            return False
        self._last[k] = now
        n_sup = self._suppressed.pop(k, 0)
        tail = f" [{n_sup} similar suppressed]" if n_sup else ""
        extra = "".join(f" {k2}={v!r}" for k2, v in fields.items())
        print(f"[paddle_tpu:{self.module}] {severity.upper()}: "
              f"{msg}{extra}{tail}", file=sys.stderr)
        _metrics.log_event("log", severity=severity, module=self.module,
                           msg=msg, **fields)
        return True

    # -------------------------------------------------------------- API
    def vlog(self, level: int, msg: str, key: str | None = None,
             rate_s: float = RATE_WINDOW_S, **fields) -> bool:
        """Print when FLAGS_log_level >= level; returns whether it
        printed (False: below level or rate-limited)."""
        if int(flag("FLAGS_log_level")) < level:
            return False
        return self._emit(f"v{level}", msg, key, rate_s, fields)

    def info(self, msg: str, **kw) -> bool:
        return self.vlog(1, msg, **kw)

    def warning(self, msg: str, key: str | None = None,
                rate_s: float = RATE_WINDOW_S, also_warn: bool = False,
                stacklevel: int = 2, **fields) -> bool:
        """Always eligible (no level gate). ``also_warn=True`` also raises
        a Python warning: the structured record is the log of record, the
        warning the surface for callers that catch warnings."""
        out = self._emit("warning", msg, key, rate_s, fields)
        if also_warn:
            _warnings.warn(msg, stacklevel=stacklevel + 1)
        return out

    def error(self, msg: str, key: str | None = None, rate_s: float = 0.0,
              **fields) -> bool:
        """Errors never rate-limit by default."""
        return self._emit("error", msg, key, rate_s, fields)

    def reset(self):
        self._last.clear()
        self._suppressed.clear()
        self.suppressed_total = 0
