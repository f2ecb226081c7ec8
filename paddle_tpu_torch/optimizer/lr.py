"""Learning-rate schedulers: `LRScheduler` and its 17 subclasses.

Port of paddle_tpu/optimizer/lr.py, formula for formula. An optimizer
given a scheduler as `learning_rate` reads its value (`scheduler()`) at
each `step()`, rounded to f32 as the reference's f32 LR array is; the
caller advances the scheduler with `scheduler.step()`. `state_dict` keeps
the scheduler's plain attributes (numbers, strings, flags, lists) and
`set_state_dict` restores them.

A scheduler keeps weak references to the optimizers that take it
(`_bound`) and, at each `step()` and `set_state_dict`, writes its new
value into their `_lr_t`, the device tensor a step reads (as the
reference's `_push` refreshes its optimizers' `_lr_t`), so a captured
train step replays with the current rate. A scheduler stepped inside a
compiled function steps once, at the capture, as the reference's steps
once at its trace: its value is then fixed for the replays, in both.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = learning_rate
        self._bound = []  # weakrefs to the optimizers whose _lr_t we write
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def _push(self):
        """Write the current value, rounded to f32, into every bound
        optimizer's `_lr_t` (on its device: no host read)."""
        for ref in list(self._bound):
            opt = ref()
            if opt is None:
                self._bound.remove(ref)
            else:
                opt._lr_t.fill_(float(np.float32(self.last_lr)))

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        self._push()

    def __call__(self):
        return self.last_lr

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if k != "_bound"
                and isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state):
        self.__dict__.update({k: v for k, v in state.items()
                              if k != "_bound"})
        self._push()

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * self.d_model ** -0.5 * min(step ** -0.5,
                                                         step * self.warmup_steps ** -1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / self.decay_steps) if step > 0 else 1
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, self.decay_steps)
        return (self.base_lr - self.end_lr) * (
            (1 - step / decay_steps) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1,
                 verbose=False):
        self.lr = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / self.warmup_steps \
                + self.start_lr
        if isinstance(self.lr, LRScheduler):
            self.lr.step(self.last_epoch - self.warmup_steps)
            return self.lr()
        return self.lr


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = learning_rate
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t / t_i)) / 2


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.base_lr = learning_rate
        self.last_lr = learning_rate
        self.last_epoch = 0
        self.verbose = verbose
        self._bound = []

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        v = metrics.item() if torch.is_tensor(metrics) else float(metrics)
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        better = False
        if self.best is None:
            better = True
        elif self.mode == "min":
            thr = self.best * (1 - self.threshold) if self.threshold_mode == "rel" \
                else self.best - self.threshold
            better = v < thr
        else:
            thr = self.best * (1 + self.threshold) if self.threshold_mode == "rel" \
                else self.best + self.threshold
            better = v > thr
        if better:
            self.best = v
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        self._push()


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        step = self.last_epoch
        up = int(self.phase_pct * self.total_steps)
        if self.three_phase:
            # warmup → symmetric cooldown back to initial_lr → anneal to end
            if step <= up:
                return self._interp(self.initial_lr, self.max_lr,
                                    step / max(up, 1))
            if step <= 2 * up:
                return self._interp(self.max_lr, self.initial_lr,
                                    (step - up) / max(up, 1))
            pct = (step - 2 * up) / max(self.total_steps - 2 * up, 1)
            return self._interp(self.initial_lr, self.end_lr, min(pct, 1.0))
        if step <= up:
            return self._interp(self.initial_lr, self.max_lr, step / max(up, 1))
        pct = (step - up) / max(self.total_steps - up, 1)
        return self._interp(self.max_lr, self.end_lr, min(pct, 1.0))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode if scale_fn is not None else \
            ("iterations" if mode == "exp_range" else "cycle")
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        cycle = self.last_epoch // total
        pos = self.last_epoch % total
        if pos < self.up:
            pct = pos / self.up
        else:
            pct = 1 - (pos - self.up) / self.down
        amp = (self.max_lr - self.base_lr) * pct
        if self.scale_fn is not None:
            # custom scaling overrides the built-in mode (reference CyclicLR:
            # scale_mode picks the scale_fn argument — cycle count or step)
            arg = cycle if self.scale_mode == "cycle" else self.last_epoch
            return self.base_lr + amp * self.scale_fn(arg)
        if self.mode == "triangular2":
            amp = amp / (2 ** cycle)
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp


class LinearLR(LRScheduler):
    """≙ optimizer/lr.py LinearLR: factor interpolates linearly from
    start_factor to end_factor over total_steps."""

    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        if total_steps <= 0:
            raise ValueError("total_steps must be positive")
        if not 0 < start_factor <= 1:
            raise ValueError("start_factor should be in (0, 1]")
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = min(max(self.last_epoch, 0), self.total_steps)
        factor = self.start_factor + (self.end_factor - self.start_factor) * (
            step / self.total_steps)
        return self.base_lr * factor
