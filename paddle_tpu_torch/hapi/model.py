"""hapi.Model — Keras-style fit/evaluate/predict.

Port of paddle_tpu/hapi/model.py: prepare() binds optimizer/loss/metrics
(and the AMP level, run through the port's ``amp.auto_cast``), fit()
drives DataLoader epochs with the callback stack (resume and the replay
fast-forward included), train_batch/eval_batch/predict_batch are the
single-step primitives, save/load wrap state dicts.

The model's device decides where batches go: each input and label is
moved to the device of the network's first parameter (the ``h2d`` span
of an instrumented step), ``non_blocking`` so a pinned batch copies
asynchronously; nothing falls back to the CPU. ``prepare(mesh=...)`` and
``fit(mesh=...)`` wait for the distributed entry.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core.tensor import Tensor
from .callbacks import config_callbacks

_MESH = ("Model.prepare/fit(mesh=...) is not ported yet (ROADMAP 'After "
         "these', Distributed)")


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _scalar(x) -> float:
    """A loss (a Tensor or torch tensor) read back to the host."""
    return float(getattr(x, "_data", x).detach().float().item())


class Model:
    """model = paddle.Model(network); model.prepare(opt, loss, metrics);
    model.fit(train_dataset, eval_dataset, epochs=2, batch_size=64)."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._save_dir = None
        self._amp_level = "O0"

    # ------------------------------------------------------------ setup
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be callable (a Loss layer or function)")
        self._loss = loss
        self._metrics = _to_list(metrics)
        # amp_configs: "O1"/"O2" or a dict with a "level" key; forward
        # passes run under bf16 auto_cast
        if amp_configs is None:
            self._amp_level = "O0"
        elif isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
        else:
            raise TypeError("amp_configs must be None, str level, or dict")
        if self._amp_level not in ("O0", "O1", "O2"):
            raise ValueError(f"unsupported amp level {self._amp_level!r}")
        return self

    def _amp_ctx(self):
        from .. import amp

        level = self._amp_level
        return amp.auto_cast(enable=level != "O0", dtype="bfloat16",
                             level=level if level != "O0" else "O1")

    def parameters(self, include_sublayers=True):
        return self.network.parameters(include_sublayers=include_sublayers)

    def _device(self) -> torch.device:
        for p in self.network.parameters():
            return getattr(p, "_data", p).device
        from ..core.device import current_device

        return current_device()

    def _to_device(self, x, device):
        """One input or label as a Tensor on the model's device (a
        non-blocking copy from the host)."""
        t = getattr(x, "_data", x)
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t))
        if t.device != device:
            t = t.to(device, non_blocking=True)
        return Tensor._wrap(t)

    # ------------------------------------------------------------ batches
    def train_batch(self, inputs, labels=None, update=True):
        from ..obs.train_flight import current as _tf_current

        # flight-recorder phase spans: when a TelemetryCallback attached
        # its recorder, each train_batch phase — host->device transfer,
        # forward, backward, optimizer commit, the loss read-back — lands
        # on the step timeline. One module-attr read when uninstrumented.
        rec = _tf_current()
        pc = time.perf_counter if rec is not None else None
        self.network.train()
        if pc:
            t0 = pc()
        dev = self._device()
        inputs = [self._to_device(v, dev) for v in _to_list(inputs)]
        labels = [self._to_device(v, dev) for v in _to_list(labels)]
        if pc:
            rec.program_span("h2d", t0, pc(),
                             tensors=len(inputs) + len(labels))
            t0 = pc()
        with self._amp_ctx():
            outputs = self.network(*inputs)
            losses = self._loss(*(_to_list(outputs) + labels)) \
                if self._loss else outputs
        loss_list = _to_list(losses)
        total = loss_list[0]
        for extra in loss_list[1:]:
            total = total + extra
        if pc:
            rec.program_span("forward", t0, pc())
            t0 = pc()
        total.backward()
        if pc:
            rec.program_span("backward", t0, pc())
            t0 = pc()
        if update and self._optimizer is not None:
            self._optimizer.step()
            self._optimizer.clear_grad()
            if pc:
                rec.program_span("optimizer_commit", t0, pc())
        if pc:
            t0 = pc()
        metrics = self._update_metrics(outputs, labels)
        result = ([_scalar(v) for v in loss_list], metrics) \
            if metrics else [_scalar(v) for v in loss_list]
        if pc:
            # the loss read-back is the host sync every eager step pays:
            # the device's queued work drains here
            rec.program_span("loss_fetch", t0, pc())
        return result

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        dev = self._device()
        with torch.no_grad():
            inputs = [self._to_device(v, dev) for v in _to_list(inputs)]
            labels = [self._to_device(v, dev) for v in _to_list(labels)]
            outputs = self.network(*inputs)
            loss_list = []
            if self._loss:
                losses = self._loss(*(_to_list(outputs) + labels))
                loss_list = [_scalar(v) for v in _to_list(losses)]
            metrics = self._update_metrics(outputs, labels)
        return (loss_list, metrics) if metrics else loss_list

    def predict_batch(self, inputs):
        self.network.eval()
        dev = self._device()
        with torch.no_grad():
            inputs = [self._to_device(v, dev) for v in _to_list(inputs)]
            outputs = self.network(*inputs)
        return [getattr(o, "_data", o).detach().cpu().numpy()
                for o in _to_list(outputs)]

    def _update_metrics(self, outputs, labels):
        res = []
        for m in self._metrics:
            pred = _to_list(outputs)[0]
            stat = m.compute(pred, *labels)
            res.append(m.update(stat))
        return res

    # ------------------------------------------------------------ loops
    def _loader(self, data, batch_size, shuffle, num_workers,
                drop_last=False):
        from ..io import DataLoader

        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        loader = self._loader(train_data, batch_size, shuffle, num_workers,
                              drop_last)
        steps = len(loader) if hasattr(loader, "__len__") else None
        self._save_dir = save_dir
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                verbose=verbose, save_freq=save_freq,
                                save_dir=save_dir,
                                metrics=[m.name() for m in self._metrics])
        self.stop_training = False
        cbks.call("on_train_begin")
        # preemption-safe resume: CheckpointCallback(resume=True) restores
        # model/optimizer/RNG in on_train_begin and leaves the captured
        # data position here; fit fast-forwards to it — skipped batches
        # replay through the loader (same shuffle permutation, numpy
        # state restored below) without any compute
        logs = {}
        # on_train_end runs once on_train_begin installed callback state,
        # even when resume parsing or a batch raises: TelemetryCallback
        # installs process-level hooks (flight recorder, goodput ledger)
        # that would otherwise leak into unrelated later work
        try:
            resume = self.__dict__.pop("_ckpt_resume", None)
            start_epoch, skip_batches = 0, 0
            if resume:
                start_epoch = int(resume.get("epoch", 0) or 0)
                skip_batches = int(resume.get("batch", 0) or 0)
                if resume.get("np_state") is not None:
                    from ..ckpt.train_state import unpack_np_state

                    np.random.set_state(unpack_np_state(resume["np_state"]))
            for epoch in range(start_epoch, epochs):
                cbks.call("on_epoch_begin", epoch)
                for m in self._metrics:
                    m.reset()
                updated = True
                # resume replay wall: batches re-consumed by the
                # fast-forward count against training GOODPUT (category
                # "replay"), not against MFU — and the goodput ledger
                # nets the wall out of the first real step's data_wait
                replay_t0 = time.perf_counter() \
                    if (epoch == start_epoch and skip_batches) else None

                def _book_replay(t0):
                    from ..obs import goodput as _goodput

                    _goodput.note_replay(time.perf_counter() - t0)

                for step, batch in enumerate(loader):
                    if epoch == start_epoch and step < skip_batches:
                        continue   # resume fast-forward: consumed batch
                    if replay_t0 is not None:
                        _book_replay(replay_t0)
                        replay_t0 = None
                    cbks.call("on_train_batch_begin", step)
                    ins, labs = self._split_batch(batch)
                    updated = (step + 1) % accumulate_grad_batches == 0
                    result = self.train_batch(ins, labs, update=updated)
                    logs = self._logs(result)
                    cbks.call("on_train_batch_end", step, logs)
                    if self.stop_training:
                        # a preemption save (CheckpointCallback SIGTERM
                        # path) must stop MID-epoch, not post-drain
                        break
                    if num_iters is not None and step + 1 >= num_iters:
                        break
                if replay_t0 is not None:
                    # checkpoint at an exact epoch boundary: every batch
                    # of start_epoch was skipped and the loop drained
                    # without a real step to book the replay against
                    _book_replay(replay_t0)
                    replay_t0 = None
                if not updated and self._optimizer is not None:
                    # flush a trailing partial accumulation group so
                    # stale grads never leak into the next epoch
                    self._optimizer.step()
                    self._optimizer.clear_grad()
                cbks.call("on_epoch_end", epoch, logs)
                if self.stop_training:
                    # preemption stopped the epoch mid-flight: exit
                    # before a long eval pass blows the grace window
                    break
                if eval_data is not None and (epoch + 1) % eval_freq == 0:
                    self.evaluate(eval_data, batch_size=batch_size,
                                  verbose=0, num_workers=num_workers,
                                  callbacks=cbks)
                if self.stop_training:
                    break
        finally:
            cbks.call("on_train_end", logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, batch_size, False, num_workers)
        cbks = callbacks if hasattr(callbacks, "call") else config_callbacks(
            callbacks, model=self, verbose=verbose, log_freq=log_freq,
            metrics=[m.name() for m in self._metrics])
        for m in self._metrics:
            m.reset()
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks.call("on_eval_begin", {"steps": steps})
        logs = {}
        seen = 0
        for step, batch in enumerate(loader):
            cbks.call("on_eval_batch_begin", step)
            ins, labs = self._split_batch(batch)
            result = self.eval_batch(ins, labs)
            logs = self._logs(result, prefix="eval_")
            cbks.call("on_eval_batch_end", step, logs)
            first = _to_list(ins)[0]
            seen += int(first.shape[0]) if getattr(first, "shape", None) \
                else 1
            if num_samples is not None and seen >= num_samples:
                break
        final = {}
        for m in self._metrics:
            final[m.name()] = m.accumulate()
        final.update({k: v for k, v in logs.items()
                      if k.startswith("eval_loss")})
        cbks.call("on_eval_end", final)
        return final

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._loader(test_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose)
        cbks.call("on_predict_begin")
        outputs = []
        for step, batch in enumerate(loader):
            cbks.call("on_predict_batch_begin", step)
            ins, _ = self._split_batch(batch, has_labels=False)
            outs = self.predict_batch(ins)
            outputs.append(outs)
            cbks.call("on_predict_batch_end", step)
        cbks.call("on_predict_end")
        # transpose list-of-batches -> per-output lists
        n_out = len(outputs[0]) if outputs else 0
        result = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            result = [np.concatenate(r, axis=0) for r in result]
        return result

    def _n_inputs(self):
        """How many positional inputs the network's forward takes: from
        the `inputs` spec when given, else the forward signature (the
        reference splits data from labels by its InputSpecs)."""
        if self._inputs is not None:
            return len(_to_list(self._inputs))
        import inspect

        try:
            sig = inspect.signature(self.network.forward)
            n = 0
            for p in sig.parameters.values():
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) \
                        and p.default is p.empty and p.name != "self":
                    n += 1
            return max(1, n)
        except (TypeError, ValueError):
            return 1

    def _split_batch(self, batch, has_labels=True):
        batch = batch if isinstance(batch, (list, tuple)) else [batch]
        n_in = self._n_inputs()
        if not has_labels:
            return list(batch[:n_in]), []
        return list(batch[:n_in]), list(batch[n_in:])

    def _logs(self, result, prefix=""):
        logs = {}
        if isinstance(result, tuple):
            losses, metrics = result
            logs[prefix + "loss"] = losses
            for m, v in zip(self._metrics, metrics):
                logs[prefix + m.name()] = v
        else:
            logs[prefix + "loss"] = result
        return logs

    # ------------------------------------------------------------ persistence
    def save(self, path, training=True):
        from ..framework_io import save as _save

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework_io import load as _load

        state = _load(path + ".pdparams")
        if skip_mismatch:
            import warnings

            current = dict(self.network.state_dict())
            kept = {}
            for k, v in state.items():
                cur = current.get(k)
                vshape = tuple(getattr(v, "shape", ()) or ())
                if cur is not None and tuple(cur.shape) != vshape:
                    warnings.warn(
                        f"skip loading {k}: shape {vshape} does not match "
                        f"{tuple(cur.shape)}")
                    continue
                kept[k] = v
            state = kept
        self.network.set_state_dict(state)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path))
        return self

    # ------------------------------------------------------------ summary
    def summary(self, input_size=None, dtype=None):
        if input_size is not None:
            from .summary import summary as _summary

            return _summary(self.network, input_size, dtype)
        rows, total, trainable = [], 0, 0
        for name, p in self.network.named_parameters():
            n = int(np.prod(p.shape))
            total += n
            if not p.stop_gradient:
                trainable += n
            rows.append((name, tuple(p.shape), n))
        width = max((len(r[0]) for r in rows), default=10) + 2
        lines = [f"{'Layer (param)':<{width}}{'Shape':<20}{'Params':>12}",
                 "-" * (width + 32)]
        for name, shape, n in rows:
            lines.append(f"{name:<{width}}{str(shape):<20}{n:>12,}")
        lines.append("-" * (width + 32))
        lines.append(f"Total params: {total:,}")
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable}
