"""Overtraining detection + batch-size recommendation (a copy of
`rvc_tpu/train/overtraining.py`, host Python; the port imports nothing of
`rvc_tpu`).

Capability parity with `rvc_mlx/train/overtraining_detector.py:24-289`:
EMA-smoothed generator loss, plateau patience and consecutive-rise
counting with a stop signal, plus the dataset-minutes -> batch-size
heuristic (`calculate_recommended_batch_size:189`).
"""

from __future__ import annotations

from typing import List, Optional


class OvertrainingDetector:
    def __init__(
        self,
        threshold: int = 50,
        smoothing: float = 0.95,
        patience: int = 10,
        min_delta: float = 1e-4,
    ):
        self.threshold = threshold
        self.smoothing = smoothing
        self.patience = patience
        self.min_delta = min_delta
        self.ema: Optional[float] = None
        self.best_ema = float("inf")
        self.best_epoch = 0
        self.rising = 0
        self.plateau = 0
        self.history: List[float] = []

    def update(self, epoch: int, g_loss: float) -> bool:
        """Returns True when training should stop."""
        if self.ema is None:
            self.ema = g_loss
        else:
            self.ema = self.smoothing * self.ema + (1 - self.smoothing) * g_loss
        self.history.append(self.ema)

        if self.ema < self.best_ema - self.min_delta:
            self.best_ema = self.ema
            self.best_epoch = epoch
            self.rising = 0
            self.plateau = 0
        else:
            self.plateau += 1
            if len(self.history) >= 2 and self.history[-1] > self.history[-2]:
                self.rising += 1
            else:
                self.rising = max(0, self.rising - 1)

        if self.rising >= self.patience:
            return True
        if epoch - self.best_epoch >= self.threshold:
            return True
        return False

    @property
    def status(self) -> dict:
        return dict(ema=self.ema, best_ema=self.best_ema,
                    best_epoch=self.best_epoch, rising=self.rising,
                    plateau=self.plateau)


def calculate_recommended_batch_size(dataset_minutes: float,
                                     max_batch: int = 16) -> int:
    """Dataset-size heuristic (reference `:189-263`): small datasets get
    small batches to preserve update counts."""
    if dataset_minutes < 5:
        rec = 4
    elif dataset_minutes < 15:
        rec = 8
    elif dataset_minutes < 45:
        rec = 12
    else:
        rec = 16
    return min(rec, max_batch)
