"""Async checkpoint saver: snapshot synchronously, commit in background.

Port of paddle_tpu/ckpt/async_saver.py. The split that makes overlap
safe:

  * the **device→host copy** (``core.host_copy``) happens synchronously
    inside :meth:`AsyncCheckpointer.save` — once it returns, the next
    train step may update every live tensor in place without racing the
    bytes being written;
  * **serialization + fsync + atomic commit** run on one background
    thread, bounded to ``FLAGS_ckpt_max_in_flight`` queued saves —
    ``save()`` blocks (backpressure) instead of letting a slow filesystem
    accumulate unbounded host copies.

Errors never drop silently: each queued save retries transient OSErrors
with exponential backoff inside ``core.save_checkpoint``
(``FLAGS_ckpt_save_retries``); a save that still fails parks its
:class:`CheckpointSaveError` and the NEXT ``save()`` / ``wait()`` call
raises it.  ``wait()`` is the barrier (train-end, pre-eval, SIGTERM
paths); ``abort()`` drops queued-but-unstarted saves and joins the
in-flight one (shutdown without flushing the tail).
"""
from __future__ import annotations

import queue
import threading
import time

from .core import (CheckpointSaveError, clean_debris, gc_checkpoints,
                   host_copy, save_checkpoint)


class AsyncCheckpointer:
    """Bounded background checkpoint writer over one root directory."""

    _STOP = object()

    def __init__(self, root, keep_last_n=None, max_in_flight=None,
                 fingerprint_extra=None, sharded=False):
        from ..core.flags import flag

        self.root = root
        self.keep_last_n = keep_last_n
        self.fingerprint_extra = fingerprint_extra
        #: sharded=True waits for the distributed entry
        #: (ckpt.core.host_copy)
        self.sharded = bool(sharded)
        if max_in_flight is None:
            max_in_flight = int(flag("FLAGS_ckpt_max_in_flight"))
        self._q: queue.Queue = queue.Queue(maxsize=max(int(max_in_flight), 1))
        self._lock = threading.Lock()
        self._errors: list = []       # guarded-by: _lock
        self._results: list = []      # guarded-by: _lock
        self._thread = None
        self._aborted = threading.Event()
        clean_debris(root)

    # ------------------------------------------------------------ worker
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="ckpt-saver", daemon=True)
            self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is self._STOP:
                    return
                step, host_tree = item
                if self._aborted.is_set():
                    continue
                try:
                    res = self._commit(step, host_tree)
                    with self._lock:
                        self._results.append(res)
                except Exception as e:   # surfaced on wait()/next save()
                    with self._lock:
                        self._errors.append(e)
            finally:
                self._q.task_done()

    def _commit(self, step, host_tree):
        # overlapped-IO span for the training flight recorder: the
        # background serialize+fsync+rename lands on the trace's
        # ckpt-io track so its overlap with train steps is VISIBLE —
        # it costs goodput nothing, only the blocking host copy does
        from ..obs.train_flight import current as _tf_current

        rec = _tf_current()
        t0 = time.perf_counter()
        res = save_checkpoint(self.root, step, host_tree,
                              fingerprint_extra=self.fingerprint_extra,
                              host_copied=True)   # save() snapshotted it
        gc_checkpoints(self.root, self.keep_last_n)
        if rec is not None:
            rec.io_span("ckpt_commit", t0, time.perf_counter(),
                        step=int(step))
        return res

    # --------------------------------------------------------------- API
    def save(self, step, tree, block=False):
        """Snapshot `tree` to host NOW; commit in background (or inline
        when ``block=True`` — the SIGTERM/final-save path).  Raises a
        parked :class:`CheckpointSaveError` from an earlier async save
        before accepting new work."""
        self._raise_parked()
        from ..obs import goodput as _goodput
        from ..obs.train_flight import current as _tf_current

        rec = _tf_current()
        t0 = time.perf_counter()
        host = host_copy(tree, sharded=self.sharded)
        t1 = time.perf_counter()
        if rec is not None:
            # the BLOCKING half: the device->host snapshot the train
            # loop waits on (the async commit overlaps on its own track)
            rec.program_span("ckpt_host_copy", t0, t1, step=int(step))
        _goodput.note_ckpt(t1 - t0)
        if block:
            # drain in-flight background saves FIRST: two concurrent
            # commits on one root would race the `latest` pointer (a
            # queued step-N save finishing after this step-N+1 one would
            # point `latest` back at the older step) and the retention
            # renames.  The blocking save is the preemption path — it
            # must end up the newest published state.
            self._q.join()
            t2 = time.perf_counter()
            res = self._commit(step, host)
            t3 = time.perf_counter()
            if rec is not None:
                rec.program_span("ckpt_blocking_save", t2, t3,
                                 step=int(step))
            _goodput.note_ckpt(t3 - t2)
            with self._lock:
                self._results.append(res)
            return res
        self._aborted.clear()
        self._ensure_thread()
        self._q.put((step, host))    # blocks at max_in_flight: backpressure
        return None

    def wait(self):
        """Barrier: block until every queued save committed; raise the
        first parked error (the rest stay visible in ``errors``)."""
        self._q.join()
        self._raise_parked()
        with self._lock:
            return list(self._results)

    def abort(self):
        """Drop queued-but-unstarted saves, join the in-flight one, and
        clear parked errors (an aborted tail is intentionally lost)."""
        self._aborted.set()
        self._q.join()
        self._aborted.clear()
        with self._lock:
            self._errors.clear()

    def close(self):
        """Flush pending saves and stop the worker thread."""
        self._q.join()
        if self._thread is not None and self._thread.is_alive():
            self._q.put(self._STOP)
            self._thread.join(timeout=30)
        self._thread = None
        self._raise_parked()

    @property
    def errors(self):
        with self._lock:
            return list(self._errors)

    @property
    def results(self):
        with self._lock:
            return list(self._results)

    def _raise_parked(self):
        with self._lock:
            if not self._errors:
                return
            err = self._errors.pop(0)
        if isinstance(err, CheckpointSaveError):
            raise err
        raise CheckpointSaveError(
            f"async checkpoint save failed: {err!r}") from err
