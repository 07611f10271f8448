"""The training step's AdamW (wrapper of `csrc/adamw.cu`).

Replaces no TPU kernel: the JAX package's optimizer is the optax chain
inside its jitted train step, which XLA fuses. `adamw` is one step of
`train.optim.AdamW` over all of an optimizer's tensors: the gradients
sanitized (`sanitize_grads`), their global norm, the clip to MAX_NORM,
Adam's moments, the decoupled decay and the step at the staircase learning
rate, gated by an optional boolean device tensor; it returns the norm (a
0-dim float32 device tensor) and advances the count in place. For CPU
tensors it runs the plain version, `adamw_reference` (the per-tensor loop);
for CUDA tensors it launches the kernel or raises.

On the card one call is an asynchronous upload of the gradients' pointers
(pinned host memory, on the current stream) and two launches: the
sanitized sums of squares with the step's scalars, then the update.
`Layout` lays out once per optimizer what the kernel reads of its
tensors; the gradients need only be float32 with the parameters' sizes
(a non-contiguous one is copied). The kernel writes through raw pointers,
so `adamw` bumps the autograd version of every tensor it may write, as an
in-place op would (the `_version`-keyed weight caches see new weights).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import torch

from rvc_tpu_torch.ops.kernels import build, count_launch

MAX_NORM = 1.0        # clip_by_global_norm(1.0)
WEIGHT_DECAY = 0.01   # adamw's decoupled decay
CLIP_VALUE = 1e3      # sanitize_grads' bound
CHUNK = 1 << 14       # elements of a kernel chunk (a multiple of 4)


class Hyper(NamedTuple):
    """An optimizer's constants: `b1_mu` is b1 rounded to the first
    moment's type (XLA folds the constant so)."""
    lr: float
    steps_per_epoch: int
    decay_rate: float
    b1: float
    b2: float
    eps: float
    b1_mu: float


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def sanitize_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """nan -> 0, +-inf -> +-CLIP_VALUE, then a clamp to +-CLIP_VALUE
    (`rvc_tpu/train/train_step.py:sanitize_grads`)."""
    return [torch.clamp(torch.nan_to_num(g, nan=0.0, posinf=CLIP_VALUE, neginf=-CLIP_VALUE),
                        -CLIP_VALUE, CLIP_VALUE) for g in grads]


def learning_rate(count: torch.Tensor, h: Hyper) -> torch.Tensor:
    """The staircase schedule at `count` (optax.exponential_decay)."""
    p = torch.floor(count.float() / h.steps_per_epoch)
    rate = torch.tensor(h.decay_rate, dtype=torch.float32, device=count.device)
    return torch.where(count <= 0, torch.tensor(h.lr, device=count.device),
                       h.lr * torch.pow(rate, p))


def adamw_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], count: torch.Tensor,
                 h: Hyper, g_norm: torch.Tensor, gate: Optional[torch.Tensor] = None) -> None:
    """The per-tensor loop of one step from sanitized `grads` and their norm
    `g_norm`: clip, moments, bias correction, decay, the step; params, mu,
    nu and count in place, none of them where `gate` is False."""
    keep = g_norm < MAX_NORM
    new_count = count + 1
    lr = learning_rate(count, h)
    bc1 = 1.0 - torch.pow(torch.tensor(h.b1, device=count.device), new_count.float())
    bc2 = 1.0 - torch.pow(torch.tensor(h.b2, device=count.device), new_count.float())
    for p, g, m_, v_ in zip(params, grads, mu, nu):
        g = torch.where(keep, g, g / g_norm * MAX_NORM)
        m = (1.0 - h.b1) * g + h.b1_mu * m_.float()
        v = (1.0 - h.b2) * g ** 2 + h.b2 * v_
        u = (m / bc1) / (torch.sqrt(v / bc2) + h.eps) + WEIGHT_DECAY * p
        new = p + (-lr) * u
        if gate is None:
            p.copy_(new)
            m_.copy_(m)
            v_.copy_(v)
        else:
            p.copy_(torch.where(gate, new, p))
            m_.copy_(torch.where(gate, m.to(m_.dtype), m_))
            v_.copy_(torch.where(gate, v, v_))
    count.copy_(new_count if gate is None else torch.where(gate, new_count, count))


class Layout:
    """An optimizer's tensors as the kernel reads them, laid out once:
    parameters (contiguous float32), first moments (bf16 or float32, one
    type for all), second moments (float32), all on one device. On a CUDA
    device also the kernel's tables: a (tensor, 4) int64 row per tensor
    (parameter, first and second moment pointers, size), a (chunk, 2) int32
    row per CHUNK elements (tensor, start), the gradients' pointers (filled
    each step), and scratch."""

    def __init__(self, params: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor]):
        self.params, self.mu, self.nu = list(params), list(mu), list(nu)
        self.device = self.params[0].device if self.params else torch.device("cpu")
        if self.device.type != "cuda":
            return
        mu_types = {m.dtype for m in self.mu}
        if mu_types - {torch.bfloat16, torch.float32} or len(mu_types) > 1:
            raise ValueError(f"adamw: first moments must be all bf16 or all float32, got "
                             f"{sorted(map(str, mu_types))}")
        self.mu_bf16 = mu_types == {torch.bfloat16}
        for i, (p, m, v) in enumerate(zip(self.params, self.mu, self.nu, strict=True)):
            for name, t in (("parameter", p), ("first moment", m), ("second moment", v)):
                if t.device != self.device or not t.is_contiguous() or t.numel() != p.numel():
                    raise ValueError(f"adamw: tensor {i}'s {name} must be contiguous on "
                                     f"{self.device} with {p.numel()} elements")
            if p.dtype != torch.float32 or v.dtype != torch.float32:
                raise ValueError(f"adamw: tensor {i} must be float32 (parameter {p.dtype}, "
                                 f"second moment {v.dtype})")
            if p.numel() >= 1 << 31:
                raise ValueError(f"adamw: tensor {i} has {p.numel()} elements (< 2**31)")
        self.numels = [p.numel() for p in self.params]
        self.param_ptrs = [p.data_ptr() for p in self.params]
        rows = [(p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel())
                for p, m, v in zip(self.params, self.mu, self.nu)]
        chunks = [(i, s) for i, n in enumerate(self.numels) for s in range(0, n, CHUNK)]
        self.n_chunks = len(chunks)
        self.tensors = torch.tensor(rows, dtype=torch.int64).reshape(-1, 4).to(self.device)
        self.chunks = torch.tensor(chunks, dtype=torch.int32).reshape(-1, 2).to(self.device)
        self.grads = torch.zeros(len(rows), dtype=torch.int64, device=self.device)
        self.partials = torch.zeros(max(self.n_chunks, 1), device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.scalars = torch.zeros(8, device=self.device)
        self.written = self.params + self.mu + self.nu

    def __len__(self) -> int:
        return len(self.params)


@functools.cache
def _lib():
    """The kernel's C entry, with its ctypes signature set once."""
    run = build.load("adamw").rvc_adamw
    run.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    run.restype = ctypes.c_int
    return run


def adamw_reference(layout: Layout, grads: Sequence[torch.Tensor], count: torch.Tensor,
                    h: Hyper, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `adamw`, with its signature: sanitize, the global
    norm, then `adamw_update`, one tensor at a time."""
    grads = sanitize_grads(grads)
    g_norm = global_norm(grads)
    adamw_update(layout.params, grads, layout.mu, layout.nu, count, h, g_norm, gate)
    return g_norm


def adamw(layout: Layout, grads: Sequence[torch.Tensor], count: torch.Tensor, h: Hyper,
          gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One AdamW step of `layout`'s tensors from `grads` (one per
    parameter, in order); `count` (0-dim int32) advances in place; with
    `gate` (0-dim bool) False nothing changes. Returns the sanitized
    gradients' global norm."""
    if layout.device.type == "cpu":
        return adamw_reference(layout, grads, count, h, gate)
    if layout.device.type != "cuda":
        raise ValueError(f"adamw: unsupported device {layout.device}")
    if len(grads) != len(layout):
        raise ValueError(f"adamw: {len(grads)} gradients for {len(layout)} parameters")
    if [p.data_ptr() for p in layout.params] != layout.param_ptrs:
        raise ValueError("adamw: a parameter's storage moved since the optimizer was built")
    if (count.device != layout.device or count.dtype != torch.int32 or count.dim() != 0
            or (gate is not None and (gate.device != layout.device or gate.dtype != torch.bool
                                      or gate.dim() != 0))):
        raise ValueError("adamw: count must be a 0-dim int32 and gate a 0-dim bool on "
                         f"{layout.device}")
    ptrs, copies = [], []   # copies: alive until the launch, so none reuses another's block
    for i, (g, n) in enumerate(zip(grads, layout.numels)):
        if g.device != layout.device or g.dtype != torch.float32 or g.numel() != n:
            raise ValueError(f"adamw: gradient {i} must be float32 on {layout.device} with "
                             f"{n} elements, got {g.dtype} {tuple(g.shape)} on {g.device}")
        if not g.is_contiguous():
            g = g.contiguous()
            copies.append(g)
        ptrs.append(g.data_ptr())
    # the caching host allocator keeps a pinned block until the copies that
    # read it are done, so the next step cannot overwrite this one in flight
    layout.grads.copy_(torch.tensor(ptrs, dtype=torch.int64, pin_memory=True),
                       non_blocking=True)
    hyper = (ctypes.c_float * 10)(h.lr, h.decay_rate, h.b1, h.b2, 1.0 - h.b1, 1.0 - h.b2,
                                  h.b1_mu, h.eps, WEIGHT_DECAY, MAX_NORM)
    norm = torch.empty((), device=layout.device)
    stream = torch.cuda.current_stream(layout.device).cuda_stream
    err = _lib()(layout.tensors.data_ptr(), layout.grads.data_ptr(), layout.chunks.data_ptr(),
                 layout.n_chunks, CHUNK, layout.partials.data_ptr(), layout.ticket.data_ptr(),
                 count.data_ptr(), None if gate is None else gate.data_ptr(),
                 layout.scalars.data_ptr(), norm.data_ptr(), int(layout.mu_bf16),
                 h.steps_per_epoch, hyper, stream)
    build.check(err, "adamw")
    count_launch("adamw")
    torch.autograd.graph.increment_version(layout.written + [count])
    return norm
