"""The trainer's optimizer: the reference's optax chain, on tensors.

`rvc_tpu/train/train_step.py:make_optimizers` builds, per network,
`optax.chain(clip_by_global_norm(1.0), adamw(lr, b1, b2, eps,
weight_decay=0.01, mu_dtype))` with a staircase exponential learning rate
by `steps_per_epoch`, and the train step sanitizes the gradients before it
(`sanitize_grads`). `AdamW` computes both, step for step, in their order:
the sanitizing, the global-norm clip, Adam's moments (the first one stored
in bf16 when `mu_dtype` says so: optax keeps the new moment in float32 for
the update and casts it after; in its jitted step XLA scales the stored
bf16 moment in float32 by b1 rounded to bf16), bias correction, the
decoupled weight decay on the parameters, the learning rate of the step
count before the update. `torch.optim.AdamW` has no bf16 first moment and
decays before its moment update, so the port keeps its own. Its step is
`ops.kernels.adamw`: on the card one kernel over every tensor of the
optimizer, on the CPU the per-tensor loop (`adamw_update`).

The step count is a device tensor and `step(grads, gate)` takes an
optional boolean device tensor: where it is False, the whole update is
skipped (parameters, moments, count), without a read-back to the host.
It returns the sanitized gradients' global norm (a 0-dim device tensor).

`parallel.train.ShardedAdamW` keeps the moments of a slice of each large
parameter (ZeRO-1): its step is the same `ops.kernels.adamw` call over the
slices `_local` cuts (the norm over the whole gradients), then `_share`.

With RVC_TPU_TRACE=1 each `step` is the span optim/adamw (ZeRO's step
too).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from rvc_tpu_torch.ops.kernels import adamw as K
from rvc_tpu_torch.utils.profiling import trace_span


class AdamW:
    """sanitize -> clip_by_global_norm(MAX_NORM) -> Adam(b1, b2, eps) -> +
    WEIGHT_DECAY p -> x -lr(count), lr(count) = lr * decay_rate **
    floor(count / steps_per_epoch)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, steps_per_epoch: int,
                 decay_rate: float, b1: float = 0.8, b2: float = 0.99, eps: float = 1e-9,
                 mu_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        local = [self._local(i, p) for i, p in enumerate(self.params)]
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in local]
        self.nu = [torch.zeros_like(p) for p in local]
        device = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        # b1 in the stored moment's type, as XLA folds the constant
        self.hyper = K.Hyper(lr, steps_per_epoch, decay_rate, b1, b2, eps,
                             torch.tensor(b1, dtype=mu_dtype or torch.float32).item())
        self._layout: Optional[K.Layout] = None

    def _local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The part of parameter i's tensor t (the parameter, its gradient)
        this optimizer updates."""
        return t

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update from `grads` (one per parameter, in order, not yet
        sanitized); with `gate` (a 0-dim bool tensor) False, nothing changes.
        Returns the sanitized gradients' global norm."""
        with trace_span("optim/adamw"):
            return K.adamw(self.layout(), grads, self.count, self.hyper, gate)

    def layout(self) -> K.Layout:
        """The kernel's layout of the parameters, their `_local` views and the
        moments, made at the first step."""
        if self._layout is None:
            self._layout = K.Layout(self.params, self.mu, self.nu,
                                    [self._local(i, p) for i, p in enumerate(self.params)])
        return self._layout

    def state_dict(self) -> Dict[str, object]:
        return {"mu": [t.detach().cpu() for t in self.mu],
                "nu": [t.detach().cpu() for t in self.nu], "count": self.count.cpu().clone()}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            src = state[key]
            if len(src) != len(dst):
                raise ValueError(f"optimizer state holds {len(src)} {key} tensors, "
                                 f"the model {len(dst)}")
            for d, s in zip(dst, src):
                d.copy_(s)
        self.count.copy_(state["count"])
