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

An optimizer may update a view of each parameter (ZeRO-1's slice,
`parallel.train.ShardedAdamW`): `Layout` takes the parameters whole and,
optionally, the views it updates, with moments the views' size. The norm
covers every gradient whole; the update only the views. A view is a narrow
of its contiguous parameter: rows of `row_len` contiguous elements,
`row_stride` apart (`view_rows`). Where the norm needs a collective, the
caller gives it (`norm`) and the step takes it as it is.

On the card one call is an asynchronous upload of the gradients' pointers
(pinned host memory, on the current stream) and two launches: the
sanitized sums of squares with the step's scalars (over every gradient
whole), then the update (over the views, by a second chunk table: the
first's rows again where every view is whole). `Layout` lays out once per optimizer what the
kernel reads of its tensors; the gradients need only be float32 with the
parameters' sizes (a non-contiguous one is copied). The kernel writes
through raw pointers, so `adamw` bumps the autograd version of every tensor
it may write, as an in-place op would (the `_version`-keyed weight caches
see new weights; a view shares its base's counter).
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


class Rows(NamedTuple):
    """A view of a contiguous tensor as the kernel reads it: `rows` rows of
    `row_len` contiguous elements, `row_stride` apart, from element
    `offset` of the whole."""
    offset: int
    rows: int
    row_len: int
    row_stride: int


def view_rows(whole: torch.Tensor, view: torch.Tensor) -> Rows:
    """`view` (a view of the contiguous tensor `whole`, such as a narrow
    along one dimension) as `Rows`; raises where it is no such view."""
    if not whole.is_contiguous() or view.untyped_storage().data_ptr() != \
            whole.untyped_storage().data_ptr():
        raise ValueError("adamw: a parameter's view must lie in its contiguous parameter")
    offset = view.storage_offset() - whole.storage_offset()
    dims = [(n, st) for n, st in zip(view.shape, view.stride()) if n != 1]
    row_len = 1
    while dims and dims[-1][1] == row_len:      # the contiguous inner dimensions
        row_len *= dims.pop()[0]
    rows, row_stride = 1, row_len
    if dims:
        row_stride = dims[-1][1]
        for n, st in reversed(dims):            # the outer ones: one stride between rows
            if st != rows * row_stride:
                raise ValueError(f"adamw: view {tuple(view.shape)} strides {view.stride()} "
                                 f"is not rows of one stride")
            rows *= n
    if offset < 0 or offset + (rows - 1) * row_stride + row_len > whole.numel():
        raise ValueError("adamw: a parameter's view must lie in its parameter")
    return Rows(offset, rows, row_len, row_stride)


class Layout:
    """An optimizer's tensors as the kernel reads them, laid out once:
    parameters (contiguous float32, whole), the views of them it updates
    (`local`; default: the parameters), first moments (bf16 or float32, one
    type for all), second moments (float32), the moments contiguous with
    their views' sizes, all on one device; `rows` each view's `Rows`. On a
    CUDA device also the kernel's tables: a (tensor, 8) int64 row per tensor
    (view, first and second moment pointers, the view's size, row_len,
    row_stride, offset, the parameter's size), a (chunk, 2) int32 row per
    CHUNK elements (tensor, start) of the whole parameters, the same over the
    views (the same rows where every view is whole), the gradients' pointers
    (filled each step), and scratch."""

    def __init__(self, params: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor], local: Optional[Sequence[torch.Tensor]] = None):
        self.params, self.mu, self.nu = list(params), list(mu), list(nu)
        self.local = self.params if local is None else list(local)
        self.rows = [view_rows(p, v) for p, v in zip(self.params, self.local, strict=True)]
        self.device = self.params[0].device if self.params else torch.device("cpu")
        if self.device.type != "cuda":
            return
        mu_types = {m.dtype for m in self.mu}
        if mu_types - {torch.bfloat16, torch.float32} or len(mu_types) > 1:
            raise ValueError(f"adamw: first moments must be all bf16 or all float32, got "
                             f"{sorted(map(str, mu_types))}")
        self.mu_bf16 = mu_types == {torch.bfloat16}
        for i, (p, v, m, n) in enumerate(zip(self.params, self.local, self.mu, self.nu,
                                             strict=True)):
            for name, t, want in (("parameter", p, p.numel()), ("first moment", m, v.numel()),
                                  ("second moment", n, v.numel())):
                if t.device != self.device or not t.is_contiguous() or t.numel() != want:
                    raise ValueError(f"adamw: tensor {i}'s {name} must be contiguous on "
                                     f"{self.device} with {want} elements")
            if p.dtype != torch.float32 or n.dtype != torch.float32:
                raise ValueError(f"adamw: tensor {i} must be float32 (parameter {p.dtype}, "
                                 f"second moment {n.dtype})")
            if p.numel() >= 1 << 31:
                raise ValueError(f"adamw: tensor {i} has {p.numel()} elements (< 2**31)")
        self.numels = [p.numel() for p in self.params]
        self.param_ptrs = [p.data_ptr() for p in self.params]
        rows = [(v.data_ptr(), m.data_ptr(), n.data_ptr(), v.numel(), r.row_len, r.row_stride,
                 r.offset, p.numel())
                for p, v, m, n, r in zip(self.params, self.local, self.mu, self.nu, self.rows)]
        chunks = _chunks(self.numels)
        self.n_chunks = len(chunks)
        self.tensors = torch.tensor(rows, dtype=torch.int64).reshape(-1, 8).to(self.device)
        self.chunks = torch.tensor(chunks, dtype=torch.int32).reshape(-1, 2).to(self.device)
        chunks = _chunks([v.numel() for v in self.local])
        self.n_update_chunks = len(chunks)
        self.update_chunks = torch.tensor(chunks, dtype=torch.int32).reshape(-1, 2).to(
            self.device)
        self.grads = torch.zeros(len(rows), dtype=torch.int64, device=self.device)
        self.partials = torch.zeros(max(self.n_chunks, 1), device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.scalars = torch.zeros(8, device=self.device)
        self.written = self.local + self.mu + self.nu

    def __len__(self) -> int:
        return len(self.params)

    def grad_view(self, i: int, g: torch.Tensor) -> torch.Tensor:
        """Tensor i's view of its whole gradient g, by its `Rows`."""
        r = self.rows[i]
        if r.rows * r.row_len == g.numel():
            return g
        flat = g.contiguous().view(-1)
        return flat.as_strided((r.rows, r.row_len), (r.row_stride, 1),
                               flat.storage_offset() + r.offset).reshape(self.local[i].shape)


def _chunks(numels: Sequence[int]) -> List[tuple]:
    """(tensor, start) of every CHUNK elements of tensors of these sizes."""
    return [(i, s) for i, n in enumerate(numels) for s in range(0, n, CHUNK)]


@functools.cache
def _lib():
    """The kernel's C entry, with its ctypes signature set once."""
    run = build.load("adamw").rvc_adamw
    run.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p] * 2)
    run.restype = ctypes.c_int
    return run


def adamw_reference(layout: Layout, grads: Sequence[torch.Tensor], count: torch.Tensor,
                    h: Hyper, gate: Optional[torch.Tensor] = None,
                    norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `adamw`, with its signature: sanitize, the global
    norm (or `norm`), then `adamw_update` over the views, one tensor at a
    time."""
    grads = sanitize_grads(grads)
    g_norm = global_norm(grads) if norm is None else norm
    adamw_update(layout.local, [layout.grad_view(i, g) for i, g in enumerate(grads)],
                 layout.mu, layout.nu, count, h, g_norm, gate)
    return g_norm


def adamw(layout: Layout, grads: Sequence[torch.Tensor], count: torch.Tensor, h: Hyper,
          gate: Optional[torch.Tensor] = None, norm: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """One AdamW step of `layout`'s views from `grads` (one per parameter,
    whole, in order); `count` (0-dim int32) advances in place; with `gate`
    (0-dim bool) False nothing changes. Returns the sanitized gradients'
    global norm, or `norm` (0-dim float32) where it is given."""
    if layout.device.type == "cpu":
        return adamw_reference(layout, grads, count, h, gate, norm)
    if layout.device.type != "cuda":
        raise ValueError(f"adamw: unsupported device {layout.device}")
    if len(grads) != len(layout):
        raise ValueError(f"adamw: {len(grads)} gradients for {len(layout)} parameters")
    if [p.data_ptr() for p in layout.params] != layout.param_ptrs:
        raise ValueError("adamw: a parameter's storage moved since the optimizer was built")
    if (count.device != layout.device or count.dtype != torch.int32 or count.dim() != 0
            or (gate is not None and (gate.device != layout.device or gate.dtype != torch.bool
                                      or gate.dim() != 0))
            or (norm is not None and (norm.device != layout.device
                                      or norm.dtype != torch.float32 or norm.dim() != 0))):
        raise ValueError("adamw: count must be a 0-dim int32, gate a 0-dim bool and norm a "
                         f"0-dim float32 on {layout.device}")
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
    out = torch.empty((), device=layout.device)
    stream = torch.cuda.current_stream(layout.device).cuda_stream
    err = _lib()(layout.tensors.data_ptr(), layout.grads.data_ptr(), layout.chunks.data_ptr(),
                 layout.n_chunks, layout.update_chunks.data_ptr(), layout.n_update_chunks,
                 CHUNK, layout.partials.data_ptr(), layout.ticket.data_ptr(), count.data_ptr(),
                 None if gate is None else gate.data_ptr(),
                 None if norm is None else norm.data_ptr(), layout.scalars.data_ptr(),
                 out.data_ptr(), int(layout.mu_bf16), h.steps_per_epoch, hyper, stream)
    build.check(err, "adamw")
    count_launch("adamw")
    torch.autograd.graph.increment_version(layout.written + [count])
    return out
