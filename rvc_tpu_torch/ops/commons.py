"""Small shared ops (counterpart of `rvc_tpu/ops/commons.py`)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) float mask (1.0 inside, 0.0 outside)."""
    pos = torch.arange(max_length, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()


def fused_add_tanh_sigmoid_multiply(a: torch.Tensor, b: torch.Tensor,
                                    n_channels: int) -> torch.Tensor:
    """WaveNet gate on (B, T, 2*n_channels): tanh(first half) * sigmoid(second)."""
    x = a + b
    return torch.tanh(x[..., :n_channels]) * torch.sigmoid(x[..., n_channels:])
