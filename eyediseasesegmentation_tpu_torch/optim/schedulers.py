"""Learning-rate scheduler registry (host-side; torch port).

A copy of ``eyediseasesegmentation_tpu/optim/schedulers.py`` (pure Python),
kept here so that the port imports nothing of the JAX package. Parity with
reference ``src/main/scheduler.py:47-100``: reduce / poly / cos / cos2 /
cosr / cosrd / 1cycle / exp / clr / multistep / simple.

Schedulers are small host-side state machines; the trainer sets the new lr
on the optimizer's parameter groups (``optim.set_learning_rate``) once per
epoch, or once per batch when ``batch_update`` (1cycle, clr), as the
reference's SchedulerCallback dispatches (train.py:306-309).
"""

from __future__ import annotations

import math
from typing import Optional


class Scheduler:
    """Protocol: call ``epoch_lr(epoch, metric)`` once per epoch (or
    ``batch_lr(global_step)`` when ``batch_update``); returns the new lr."""

    batch_update: bool = False

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr

    def epoch_lr(self, epoch: int, metric: Optional[float] = None) -> float:
        return self.lr

    def batch_lr(self, step: int) -> float:
        return self.lr


class ReduceLROnPlateau(Scheduler):
    """torch ReduceLROnPlateau(mode, patience=10, factor=0.1) semantics."""

    def __init__(self, base_lr, mode="max", patience=10, factor=0.1,
                 min_lr=0.0, threshold=1e-4):
        super().__init__(base_lr)
        self.mode = mode
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: Optional[float] = None
        self.num_bad = 0

    def _is_better(self, metric):
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold)
        return metric < self.best * (1.0 - self.threshold)

    def epoch_lr(self, epoch, metric=None):
        if metric is None:
            return self.lr
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


class PolyLR(Scheduler):
    def __init__(self, base_lr, max_iters, power=0.9, min_lr=1e-6):
        super().__init__(base_lr)
        self.max_iters = max_iters
        self.power = power
        self.min_lr = min_lr

    def epoch_lr(self, epoch, metric=None):
        self.lr = max(self.base_lr * (1 - epoch / self.max_iters) ** self.power,
                      self.min_lr)
        return self.lr


class CosineAnnealing(Scheduler):
    def __init__(self, base_lr, t_max, eta_min=1e-6):
        super().__init__(base_lr)
        self.t_max = t_max
        self.eta_min = eta_min

    def epoch_lr(self, epoch, metric=None):
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * epoch / self.t_max)) / 2
        return self.lr


class CosineWarmRestarts(Scheduler):
    """CosineAnnealingWarmRestarts; ``gamma`` < 1 adds the per-epoch decay of
    the reference's CosineAnnealingWarmRestartsWithDecay (scheduler.py:16-34)."""

    def __init__(self, base_lr, t_0, t_mult=1, eta_min=1e-6, gamma=1.0):
        super().__init__(base_lr)
        self.t_0 = t_0
        self.t_mult = t_mult
        self.eta_min = eta_min
        self.gamma = gamma

    def epoch_lr(self, epoch, metric=None):
        t_cur, t_i = epoch, self.t_0
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.t_mult
        base = self.base_lr * (self.gamma ** epoch)
        self.lr = self.eta_min + (base - self.eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)) / 2
        return self.lr


class OneCycle(Scheduler):
    """OneCycleLRWithWarmup(lr_range=(lr, 1e-6), warmup 5%, decay 10%)."""

    batch_update = True

    def __init__(self, base_lr, total_steps, min_lr=1e-6,
                 warmup_fraction=0.05, decay_fraction=0.1):
        super().__init__(base_lr)
        self.total = max(total_steps, 1)
        self.min_lr = min_lr
        self.warm = max(int(self.total * warmup_fraction), 1)
        self.decay = max(int(self.total * decay_fraction), 1)

    def batch_lr(self, step):
        if step < self.warm:
            f = step / self.warm
            self.lr = self.min_lr + f * (self.base_lr - self.min_lr)
        elif step > self.total - self.decay:
            f = (self.total - step) / self.decay
            self.lr = self.min_lr + max(f, 0.0) * (self.base_lr - self.min_lr)
        else:
            self.lr = self.base_lr
        return self.lr


class ExponentialLR(Scheduler):
    def __init__(self, base_lr, gamma=0.95):
        super().__init__(base_lr)
        self.gamma = gamma

    def epoch_lr(self, epoch, metric=None):
        self.lr = self.base_lr * (self.gamma ** epoch)
        return self.lr


class CyclicLR(Scheduler):
    batch_update = True

    def __init__(self, base_lr, max_lr, step_size_up):
        super().__init__(max_lr)
        self.lo = base_lr
        self.hi = max_lr
        self.up = max(step_size_up, 1)

    def batch_lr(self, step):
        cycle_pos = step % (2 * self.up)
        f = cycle_pos / self.up if cycle_pos < self.up else 2 - cycle_pos / self.up
        self.lr = self.lo + f * (self.hi - self.lo)
        return self.lr


class MultiStepLR(Scheduler):
    def __init__(self, base_lr, milestones, gamma):
        super().__init__(base_lr)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def epoch_lr(self, epoch, metric=None):
        n = sum(1 for m in self.milestones if epoch >= m)
        self.lr = self.base_lr * (self.gamma ** n)
        return self.lr


def get_scheduler(scheduler_name: Optional[str], lr: float, num_epochs: int,
                  batches_in_epoch: Optional[int] = None,
                  mode: Optional[str] = None) -> Optional[Scheduler]:
    """Registry matching reference scheduler.py:47-100."""
    if scheduler_name is None or scheduler_name.lower() == "none":
        return None
    name = scheduler_name.lower()
    if name == "reduce":
        return ReduceLROnPlateau(lr, mode=mode or "max", patience=10)
    if name == "poly":
        return PolyLR(lr, num_epochs)
    if name == "cos":
        return CosineAnnealing(lr, num_epochs, eta_min=1e-6)
    if name == "cos2":
        return CosineAnnealing(lr, num_epochs, eta_min=float(lr * 0.5))
    if name == "cosr":
        return CosineWarmRestarts(lr, t_0=max(2, num_epochs // 4))
    if name == "cosrd":
        return CosineWarmRestarts(lr, t_0=max(2, num_epochs // 6), gamma=0.96)
    if name in {"1cycle", "one_cycle"}:
        return OneCycle(lr, (batches_in_epoch or 1) * num_epochs)
    if name == "exp":
        return ExponentialLR(lr, gamma=0.95)
    if name == "clr":
        return CyclicLR(1e-6, lr, (batches_in_epoch or 4) // 4)
    if name == "multistep":
        return MultiStepLR(lr, [int(num_epochs * 0.5), int(num_epochs * 0.7),
                                int(num_epochs * 0.9)], gamma=0.3)
    if name == "simple":
        return MultiStepLR(lr, [int(num_epochs * 0.4), int(num_epochs * 0.7)],
                           gamma=0.1)
    raise KeyError(scheduler_name)
