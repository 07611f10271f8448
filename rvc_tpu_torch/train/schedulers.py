"""LR schedulers (a copy of `rvc_tpu/train/schedulers.py`, host Python; the
port imports nothing of `rvc_tpu`). Capability parity with `rvc_mlx/train/schedulers.py:32-130`:
Exponential (per-epoch 0.999875), CosineAnnealing, Warmup, ReduceOnPlateau.
Per-epoch learning-rate scaling on the host."""

from __future__ import annotations

import math


class ExponentialLR:
    def __init__(self, base_lr: float, gamma: float = 0.999875):
        self.base_lr = base_lr
        self.gamma = gamma

    def __call__(self, epoch: int) -> float:
        return self.base_lr * (self.gamma ** epoch)


class CosineAnnealingLR:
    def __init__(self, base_lr: float, t_max: int, eta_min: float = 0.0):
        self.base_lr = base_lr
        self.t_max = t_max
        self.eta_min = eta_min

    def __call__(self, epoch: int) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * min(epoch, self.t_max) / self.t_max)) / 2


class WarmupLR:
    def __init__(self, base_lr: float, warmup_epochs: int, after=None):
        self.base_lr = base_lr
        self.warmup_epochs = warmup_epochs
        self.after = after or (lambda e: base_lr)

    def __call__(self, epoch: int) -> float:
        if epoch < self.warmup_epochs:
            return self.base_lr * (epoch + 1) / max(self.warmup_epochs, 1)
        return self.after(epoch - self.warmup_epochs)


class ReduceLROnPlateau:
    def __init__(self, base_lr: float, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 1e-7):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best - 1e-8:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
