"""Small shared ops (counterpart of `rvc_tpu/ops/commons.py`), and the
batch-shaped random draws of training and of the NSF source (`draw`,
`batch_rows`)."""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Iterator, Optional, Sequence

import torch

_rows = threading.local()


@contextmanager
def batch_rows(start: int, total: int) -> Iterator[None]:
    """Inside, in this thread, every `draw` is made for a batch of `total`
    rows and cut to the caller's rows from `start` on: a shard of a batch
    draws from a generator what the whole batch draws for those rows, so a
    data-parallel rank, or one device of `BatchConverter`'s mesh, gets the
    numbers a single device gets at the whole batch."""
    prev = getattr(_rows, "value", None)
    _rows.value = (start, total)
    try:
        yield
    finally:
        _rows.value = prev


def draw(fn: Callable, shape: Sequence[int], generator: Optional[torch.Generator],
         device) -> torch.Tensor:
    """fn(shape) (`torch.randn` or `torch.rand`) from `generator` on
    `device`; shape[0] is the batch, cut from the whole batch inside
    `batch_rows`."""
    rows = getattr(_rows, "value", None)
    if rows is None:
        return fn(tuple(shape), generator=generator, device=device)
    start, total = rows
    return fn((total, *shape[1:]), generator=generator, device=device)[start: start + shape[0]]


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) float mask (1.0 inside, 0.0 outside)."""
    pos = torch.arange(max_length, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()


def fused_add_tanh_sigmoid_multiply(a: torch.Tensor, b: torch.Tensor,
                                    n_channels: int) -> torch.Tensor:
    """WaveNet gate on (B, T, 2*n_channels): tanh(first half) * sigmoid(second)."""
    x = a + b
    return torch.tanh(x[..., :n_channels]) * torch.sigmoid(x[..., n_channels:])


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor, segment_size: int) -> torch.Tensor:
    """Per-row time slice: x (B, T, C) or (B, T), ids_str (B,) int starts ->
    (B, segment_size, C) / (B, segment_size). A start past T - segment_size
    is clamped there, as `lax.dynamic_slice` does."""
    T = x.shape[1]
    start = ids_str.long().clamp(0, max(T - segment_size, 0))
    idx = start[:, None] + torch.arange(segment_size, device=x.device)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


def rand_slice_segments(x: torch.Tensor, x_lengths: torch.Tensor, segment_size: int,
                        generator: torch.Generator):
    """Random per-row slice for segment training: starts uniform in
    [0, len - segment_size] (0 for rows shorter than a segment), drawn from
    `generator` (on x's device). Returns (segments, ids_str)."""
    max_starts = torch.clamp(x_lengths.long() - segment_size, min=0)
    u = draw(torch.rand, (x.shape[0],), generator, x.device)
    ids = (u * (max_starts + 1).float()).long()
    ids = torch.minimum(ids, max_starts)
    return slice_segments(x, ids, segment_size), ids
