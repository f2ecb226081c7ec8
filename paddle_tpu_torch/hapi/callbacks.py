"""hapi training callbacks.

Port of paddle_tpu/hapi/callbacks.py: ProgBarLogger, ModelCheckpoint,
CheckpointCallback, EarlyStopping, LRScheduler and TelemetryCallback —
the hooks fire from Model.fit/evaluate/predict exactly as in the
reference (config_callbacks assembles the default stack)."""
from __future__ import annotations

import os
import sys
import time

import numpy as np


class Callback:
    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # -- train
    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    # -- eval
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    # -- predict
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks, model, params):
        self.callbacks = list(callbacks)
        for cb in self.callbacks:
            cb.set_model(model)
            cb.set_params(params)

    def call(self, hook, *args):
        for cb in self.callbacks:
            getattr(cb, hook)(*args)


class ProgBarLogger(Callback):
    """Per-epoch progress line with smoothed metrics."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        self.log_freq = log_freq
        self.verbose = verbose
        self.steps = None
        self.epoch = 0

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}", file=sys.stderr)

    def _line(self, step, logs):
        items = [f"step {step + 1}" + (f"/{self.steps}" if self.steps else "")]
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)):
                v = v[0] if v else 0.0
            if isinstance(v, (int, float, np.floating)):
                items.append(f"{k}: {float(v):.4f}")
        return " - ".join(items)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and (step + 1) % self.log_freq == 0:
            print(self._line(step, logs), file=sys.stderr)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(self._line(self.params.get("steps", 1) - 1 if self.params.get("steps") else 0, logs)
                  + f" - {dt:.2f}s", file=sys.stderr)

    def on_eval_begin(self, logs=None):
        self.eval_steps = (logs or {}).get("steps")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print("Eval " + self._line((self.eval_steps or 1) - 1, logs),
                  file=sys.stderr)


class ModelCheckpoint(Callback):
    """Per-epoch checkpointing.  Default (``keep_last_n=None``) keeps the
    reference behavior: ``model.save(<dir>/<epoch>)`` pickle pairs plus a
    ``final`` save.  With ``keep_last_n`` set it switches to the
    crash-consistent ``ckpt`` format (atomic ``step_<epoch>/`` dirs +
    ``latest`` pointer) with retention: only the newest N checkpoints
    survive, deletion is strictly oldest-first, the dir ``latest`` points
    at is never deleted, and only fully-committed dirs are touched — a
    concurrent restore never observes a half-deleted checkpoint."""

    def __init__(self, save_freq: int = 1, save_dir: str = "checkpoint",
                 keep_last_n: int | None = None):
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.keep_last_n = keep_last_n
        self._last_epoch = None
        self._last_saved = None

    def _save_ckpt(self, epoch):
        from .. import ckpt

        tree = ckpt.capture_train_state(
            self.model, getattr(self.model, "_optimizer", None), step=epoch)
        ckpt.save_checkpoint(self.save_dir, epoch, tree)
        ckpt.gc_checkpoints(self.save_dir, self.keep_last_n)
        self._last_saved = epoch

    def on_epoch_end(self, epoch, logs=None):
        self._last_epoch = epoch
        if not self.save_dir or epoch % self.save_freq != 0:
            return
        if self.keep_last_n is None:
            self.model.save(os.path.join(self.save_dir, str(epoch)))
            return
        self._save_ckpt(epoch)

    def on_train_end(self, logs=None):
        if not self.save_dir:
            return
        if self.keep_last_n is None:
            self.model.save(os.path.join(self.save_dir, "final"))
        elif self._last_epoch is not None \
                and self._last_saved != self._last_epoch:
            # save_freq > 1: the final epochs since the last periodic
            # save must not be lost (the pickle mode's `final` analogue)
            self._save_ckpt(self._last_epoch)


class CheckpointCallback(Callback):
    """Crash-consistent train-loop checkpointing + preemption-safe resume
    (``paddle_tpu_torch.ckpt``).

    Every ``save_freq_steps`` train batches (and/or every
    ``save_freq_epochs`` epochs) the FULL train state — params, optimizer
    slots, LR schedule, global step, both RNG streams, data-iterator
    position — is captured and committed through an
    :class:`~paddle_tpu_torch.ckpt.AsyncCheckpointer`: the device→host copy is
    synchronous (the next step can't race it), serialization + fsync +
    atomic rename run on the background thread (``FLAGS_ckpt_async=0``
    forces blocking saves).

    **Preemption**: on SIGTERM the callback finishes the in-flight batch,
    performs one final SYNCHRONOUS save, and stops training — a
    preempted job loses at most the current batch. The previous SIGTERM
    handler comes back at train end.

    **Resume**: ``CheckpointCallback(dir, resume=True)`` restores the
    newest verified checkpoint (falling back past damaged ones with a
    named reason — see ``ckpt.restore_checkpoint``) in
    ``on_train_begin`` and hands the data position to ``Model.fit``,
    which fast-forwards to the saved (epoch, batch) replaying the same
    shuffle permutation — the resumed loss trajectory is bitwise
    identical to the uninterrupted run.
    """

    def __init__(self, save_dir: str, save_freq_steps: int = 0,
                 save_freq_epochs: int = 1, keep_last_n: int | None = None,
                 async_save: bool | None = None, resume: bool = False,
                 handle_sigterm: bool = True):
        self.save_dir = save_dir
        self.save_freq_steps = int(save_freq_steps or 0)
        self.save_freq_epochs = int(save_freq_epochs or 0)
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self.resume = resume
        self.handle_sigterm = handle_sigterm
        self.global_step = 0
        self.last_restore = None
        self._saver = None
        self._preempted = False
        self._preempt_saved = False
        self._prev_handler = None
        self._epoch = 0
        self._batch = 0
        self._epoch_np_state = None

    # ---------------------------------------------------------- plumbing
    def _optimizer(self):
        return getattr(self.model, "_optimizer", None)

    def _data_state(self):
        from .. import ckpt

        np_state = self._epoch_np_state if self._epoch_np_state is not None \
            else ckpt.pack_np_state()
        return {"epoch": int(self._epoch), "batch": int(self._batch),
                "np_state": np_state}

    def _save(self, block: bool):
        from .. import ckpt

        tree = ckpt.capture_train_state(
            self.model, self._optimizer(), step=self.global_step,
            data_state=self._data_state())
        self._saver.save(self.global_step, tree, block=block)

    def _on_sigterm(self, signum, frame):
        # only record the fact; the save happens at the next batch/epoch
        # boundary on the main thread (we are inside a signal handler)
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    # ------------------------------------------------------------- hooks
    def on_train_begin(self, logs=None):
        import signal

        from .. import ckpt
        from ..core.flags import flag

        if self.async_save is None:
            self.async_save = bool(flag("FLAGS_ckpt_async"))
        self._preempted = False
        self._preempt_saved = False
        # restore BEFORE constructing the saver: its startup debris
        # sweep (clean_debris) owns the root, and the restore scan must
        # see any crash-displaced checkpoint first
        if self.resume:
            try:
                result = ckpt.restore_checkpoint(self.save_dir)
            except ckpt.CheckpointNotFoundError:
                result = None   # cold start: nothing to resume from
            if result is not None:
                meta = ckpt.restore_train_state(result.tree, self.model,
                                                self._optimizer())
                self.global_step = meta["step"]
                self.last_restore = result
                # Model.fit fast-forwards to this (epoch, batch) position
                self.model._ckpt_resume = meta["data"]
        self._saver = ckpt.AsyncCheckpointer(self.save_dir,
                                             keep_last_n=self.keep_last_n)
        if self.handle_sigterm:
            try:
                self._prev_handler = signal.signal(signal.SIGTERM,
                                                   self._on_sigterm)
            except ValueError:
                self._prev_handler = None   # not the main thread

    def on_epoch_begin(self, epoch, logs=None):
        from .. import ckpt

        self._epoch = epoch
        self._batch = 0
        # the shuffle permutation for this epoch is drawn from THIS numpy
        # state when the loader's iterator starts — saving it is what
        # makes mid-epoch resume replay the identical batch order
        self._epoch_np_state = ckpt.pack_np_state()

    def on_train_batch_end(self, step, logs=None):
        self.global_step += 1
        self._batch = step + 1
        if self._preempted:
            # preemption: final synchronous save, then stop the loop
            # (fit breaks out of the epoch MID-epoch on stop_training)
            from ..obs.train_flight import current as _tf_current

            rec = _tf_current()
            if rec is not None:
                rec.mark("preemption", step=self.global_step)
            self._save(block=True)
            self._preempt_saved = True
            self.model.stop_training = True
            return
        if self.save_freq_steps and \
                self.global_step % self.save_freq_steps == 0:
            self._save(block=not self.async_save)

    def on_epoch_end(self, epoch, logs=None):
        if self._preempted:
            # the mid-epoch break still fires on_epoch_end; the final
            # save (with the mid-epoch position) already happened at
            # batch end — do NOT roll the position over it
            if not getattr(self, "_preempt_saved", False):
                self._save(block=True)
                self._preempt_saved = True
            self.model.stop_training = True
            return
        # position rolls to the next epoch's start; numpy state AS OF NOW
        # is that epoch's start state (nothing draws between epochs)
        self._epoch = epoch + 1
        self._batch = 0
        self._epoch_np_state = None
        if self.save_freq_epochs and \
                (epoch + 1) % self.save_freq_epochs == 0:
            self._save(block=not self.async_save)

    def on_train_end(self, logs=None):
        import signal

        if self._saver is not None:
            self._saver.wait()   # barrier: surface any parked save error
        if self.handle_sigterm and self._prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler)
            except ValueError:
                pass
            self._prev_handler = None

    def wait(self):
        """Flush pending async saves (surfaces parked errors)."""
        if self._saver is not None:
            return self._saver.wait()
        return []


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode
        self.wait = 0
        self.stopped_epoch = 0
        self.best = baseline  # baseline seeds the initial best (reference semantics)

    def _better(self, cur, ref):
        if ref is None:
            return True
        delta = self.min_delta if self.mode == "max" else -self.min_delta
        return cur > ref + delta if self.mode == "max" else cur < ref + delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:  # evaluate() prefixes loss keys with "eval_"
            cur = logs.get("eval_" + self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        cur = float(cur)
        if self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"EarlyStopping: no {self.monitor} improvement for "
                          f"{self.wait} evals, stopping", file=sys.stderr)


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by_step or by_epoch)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class TelemetryCallback(Callback):
    """Train-loop telemetry into an obs metrics registry.

    Per train batch: step wall time (histogram), loss (gauge), tokens/s
    (gauge, when the batch's token count is declared), the lazy-mode
    flush counter (``train_lazy_flushes_total``: it exists and stays 0,
    since the reference's lazy mode is left out by design, ROADMAP Queue
    1 item 1), and the flight-recorder/goodput story:

    * a :class:`~paddle_tpu_torch.obs.TrainFlightRecorder` holds every
      step's span timeline (data wait, h2d, fwd/bwd, optimizer commit,
      loss read-back, compiled-step dispatches, blocking ckpt copies,
      overlapped async-ckpt IO); ``cb.flight.dump(path)`` exports
      Chrome-trace JSON and anomalies (data starvation / step spike /
      ckpt stall) auto-dump postmortems to ``FLAGS_obs_flight_dir``;
    * a :class:`~paddle_tpu_torch.obs.GoodputLedger` accumulates
      ``train_goodput_seconds_total{category}`` +
      ``train_goodput_ratio`` and the MFU gauges
      (``train_mfu{program}``, ``train_achieved_flops``) — the flops
      numerator comes from the cost ledger of compiled ``to_static``
      step programs executed during the step, or is declared via
      ``step_flops`` (eager steps have no compiled program), the same
      way token accounting is declared.

    Attach explicitly (``model.fit(..., callbacks=[TelemetryCallback()])``)
    or globally via ``FLAGS_obs_metrics=1`` (config_callbacks auto-adds
    one). The callback API surfaces no batch tensors, so token
    accounting is declared: pass ``batch_tokens`` (tokens per batch, e.g.
    ``batch * seq_len`` for an LM) or call ``set_batch_tokens``; without
    it the tokens/s gauge stays unset and step time/loss still record.
    """

    def __init__(self, registry=None, batch_tokens=None, step_flops=None,
                 flight=None):
        from .. import obs

        reg = registry if registry is not None else obs.default_registry()
        self.registry = reg
        self._m_step = reg.histogram(
            "train_step_seconds", "one train_batch call (fwd+bwd+opt)")
        self._m_loss = reg.gauge("train_loss", "last train batch loss")
        self._m_tps = reg.gauge(
            "train_tokens_per_sec", "tokens (or rows) / step wall")
        self._m_steps = reg.counter("train_steps_total", "train batches run")
        self._m_flushes = reg.counter(
            "train_lazy_flushes_total",
            "segmented-lazy segment flushes forced during train steps "
            "(graph-break host syncs, core/lazy.py)")
        if flight is False:
            self.flight = None
        elif flight is None or flight is True:
            self.flight = obs.TrainFlightRecorder(registry=reg)
        else:
            self.flight = flight
        self.ledger = obs.GoodputLedger(registry=reg)
        self._t0 = None
        self._t_prev_end = None
        self._cur = None
        self._dw = 0.0
        self._epoch = 0
        self._step_index = 0        # monotonic across fits (ring index)
        self._prev_recorder = None
        self._prev_ledger = None
        self._batch_tokens = None if batch_tokens is None \
            else int(batch_tokens)
        self._step_flops = None if step_flops is None else float(step_flops)

    def set_batch_tokens(self, n):
        """Override token accounting when inputs aren't id tensors."""
        self._batch_tokens = int(n)
        return self

    def set_step_flops(self, n):
        """Declare per-step FLOPs for the MFU gauges when the step has
        no compiled program to read them from (eager training)."""
        self._step_flops = float(n)
        return self

    # ------------------------------------------------------------- hooks
    def on_train_begin(self, logs=None):
        from ..obs import goodput, train_flight

        # re-baseline on (re)attach: a dangling _t0 from a fit that died
        # mid-batch must not leak into this one
        self._t0 = None
        self._cur = None
        if self.flight is not None:
            self._prev_recorder = train_flight.set_current(self.flight)
        self._prev_ledger = goodput.activate(self.ledger)
        self.ledger.start()
        self._t_prev_end = time.perf_counter()

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        # re-anchor the data-wait window: the gap since the last batch
        # is epoch-boundary work (metric resets, a mid-fit evaluate()
        # pass) — counting it as a loader stall would fire a spurious
        # data_starvation postmortem every epoch. Any replay booked
        # BEFORE this point (a checkpoint at an exact epoch boundary:
        # the resumed epoch drained without a real step) is also outside
        # the new window — leaving it pending would subtract it from the
        # first batch's wait and mask a real loader stall.
        self._t_prev_end = time.perf_counter()
        self.ledger.take_window_skip()
        if self.flight is not None:
            self.flight.mark("epoch_begin", epoch=epoch)

    def on_train_batch_begin(self, step, logs=None):
        now = time.perf_counter()
        # loader stall = time since the previous step ended, net of any
        # resume-replay wall the goodput ledger just recorded (replay is
        # its own category, not a data wait)
        base = self._t_prev_end if self._t_prev_end is not None else now
        self._dw = max(now - base - self.ledger.take_window_skip(), 0.0)
        if self.flight is not None:
            self._cur = self.flight.step_begin(
                self._step_index, self._epoch, now - self._dw, now)
        self._t0 = now

    def on_train_batch_end(self, step, logs=None):
        if self._t0 is None:
            return
        end = time.perf_counter()
        wall = end - self._t0
        self._t0 = None
        self._step_index += 1
        self._m_step.observe(wall)
        self._m_steps.inc()
        # no lazy mode in the port (ROADMAP Queue 1 item 1): a step forces
        # no segment flushes
        flushes = 0
        self._m_flushes.inc(flushes)
        logs = logs or {}
        loss = logs.get("loss")
        if isinstance(loss, (list, tuple)):
            loss = loss[0] if loss else None
        loss = float(loss) if isinstance(loss, (int, float, np.floating)) \
            else None
        if loss is not None:
            self._m_loss.set(loss)
        if self._batch_tokens:
            self._m_tps.set(self._batch_tokens / max(wall, 1e-9))
        cur = self._cur
        # measured at batch begin — valid with OR without the recorder
        # (flight=False must still report data waits honestly)
        dw = self._dw
        if self._step_flops is not None:
            flops, programs = self._step_flops, ()
        elif cur is not None:
            flops, programs = cur.flops, cur.programs
        else:
            flops, programs = 0.0, ()
        self.ledger.observe_step(wall, data_wait_s=dw, flops=flops,
                                 programs=programs)
        if self.flight is not None:
            # same `end`/`wall` floats the histogram observed — the
            # dump-time tiling assertion holds bitwise by construction
            self.flight.step_end(end, wall, loss=loss, flushes=flushes)
        self._cur = None
        self._t_prev_end = end

    def on_train_end(self, logs=None):
        from ..obs import goodput, train_flight

        self.ledger.stop()
        goodput.deactivate(self.ledger)
        if self._prev_ledger is not None:
            goodput.activate(self._prev_ledger)
            self._prev_ledger = None
        if self.flight is not None:
            train_flight.set_current(self._prev_recorder)
            self._prev_recorder = None
        self._t0 = None
        self._cur = None

    # predict/eval keep the defaults (train is the instrumented loop)


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=1, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    from .. import obs

    if mode == "train" and obs.metrics_enabled() \
            and not any(isinstance(c, TelemetryCallback) for c in cbks):
        cbks = cbks + [TelemetryCallback()]
    params = {"epochs": epochs, "steps": steps, "verbose": verbose,
              "metrics": metrics or []}
    return CallbackList(cbks, model, params)
