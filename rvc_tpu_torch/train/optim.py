"""The trainer's optimizer: the reference's optax chain, on tensors.

`rvc_tpu/train/train_step.py:make_optimizers` builds, per network,
`optax.chain(clip_by_global_norm(1.0), adamw(lr, b1, b2, eps,
weight_decay=0.01, mu_dtype))` with a staircase exponential learning rate
by `steps_per_epoch`. `AdamW` computes that chain step for step, in its
order: the global-norm clip, Adam's moments (the first one stored in bf16
when `mu_dtype` says so: optax keeps the new moment in float32 for the
update and casts it after; in its jitted step XLA scales the stored bf16
moment in float32 by b1 rounded to bf16),
bias correction, the decoupled weight decay on the parameters, the
learning rate of the step count before the update. `torch.optim.AdamW`
has no bf16 first moment and decays before its moment update, so the port
keeps its own.

The step count is a device tensor and `step(grads, gate)` takes an
optional boolean device tensor: where it is False, the whole update is
skipped (parameters, moments, count), without a read-back to the host.

`parallel.train.ShardedAdamW` keeps the moments of a slice of each large
parameter (ZeRO-1): `_local` cuts what a rank updates, `_share` gathers
the updated slices; here both are the whole.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

MAX_NORM = 1.0        # clip_by_global_norm(1.0)
WEIGHT_DECAY = 0.01   # adamw's decoupled decay
CLIP_VALUE = 1e3      # sanitize_grads' bound


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def sanitize_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """nan -> 0, +-inf -> +-CLIP_VALUE, then a clamp to +-CLIP_VALUE
    (`rvc_tpu/train/train_step.py:sanitize_grads`)."""
    return [torch.clamp(torch.nan_to_num(g, nan=0.0, posinf=CLIP_VALUE, neginf=-CLIP_VALUE),
                        -CLIP_VALUE, CLIP_VALUE) for g in grads]


class AdamW:
    """clip_by_global_norm(MAX_NORM) -> Adam(b1, b2, eps) -> + WEIGHT_DECAY p
    -> x -lr(count), lr(count) = lr * decay_rate ** floor(count / steps_per_epoch)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, steps_per_epoch: int,
                 decay_rate: float, b1: float = 0.8, b2: float = 0.99, eps: float = 1e-9,
                 mu_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.lr, self.steps_per_epoch, self.decay_rate = lr, steps_per_epoch, decay_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        local = [self._local(i, p) for i, p in enumerate(self.params)]
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in local]
        # b1 in the stored moment's type, as XLA folds the constant
        self.b1_mu = torch.tensor(b1, dtype=mu_dtype or torch.float32).item()
        self.nu = [torch.zeros_like(p) for p in local]
        device = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """The staircase schedule at `count` (optax.exponential_decay)."""
        p = torch.floor(count.float() / self.steps_per_epoch)
        rate = torch.tensor(self.decay_rate, dtype=torch.float32, device=count.device)
        return torch.where(count <= 0, torch.tensor(self.lr, device=count.device),
                           self.lr * torch.pow(rate, p))

    def _local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The part of parameter i's tensor t (the parameter, its gradient)
        this optimizer updates."""
        return t

    def _share(self) -> None:
        """Make every updated part whole on every rank."""

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], gate: Optional[torch.Tensor] = None) -> None:
        """One update from `grads` (one per parameter, in order); with `gate`
        (a 0-dim bool tensor) False, nothing changes."""
        g_norm = global_norm(grads)
        keep = g_norm < MAX_NORM
        count = self.count + 1
        lr = self.learning_rate(self.count)
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, device=count.device), count.float())
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, device=count.device), count.float())
        for i, (p, g, mu, nu) in enumerate(zip(self.params, grads, self.mu, self.nu)):
            p, g = self._local(i, p), self._local(i, g)
            g = torch.where(keep, g, g / g_norm * MAX_NORM)
            m = (1.0 - self.b1) * g + self.b1_mu * mu.float()
            v = (1.0 - self.b2) * g ** 2 + self.b2 * nu
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + WEIGHT_DECAY * p
            new = p + (-lr) * u
            if gate is None:
                p.copy_(new)
                mu.copy_(m)
                nu.copy_(v)
            else:
                p.copy_(torch.where(gate, new, p))
                mu.copy_(torch.where(gate, m.to(mu.dtype), mu))
                nu.copy_(torch.where(gate, v, nu))
        self.count = count if gate is None else torch.where(gate, count, self.count)
        self._share()

    def state_dict(self) -> Dict[str, object]:
        return {"mu": [t.detach().cpu() for t in self.mu],
                "nu": [t.detach().cpu() for t in self.nu], "count": self.count.cpu()}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            src = state[key]
            if len(src) != len(dst):
                raise ValueError(f"optimizer state holds {len(src)} {key} tensors, "
                                 f"the model {len(dst)}")
            for d, s in zip(dst, src):
                d.copy_(s)
        self.count = state["count"].to(self.count.device, torch.int32)
