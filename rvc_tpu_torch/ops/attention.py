"""VITS windowed relative-position attention (counterpart of
`rvc_tpu/ops/attention.py`).

`relative_attention_xla` keeps the reference's name: it is the plain
PyTorch version of kernel K3, the skew formulation over full (T, T)
score planes. The TextEncoder calls K3's wrapper,
`ops.kernels.attention.rel_attention`, which launches the kernel for
CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def get_relative_embeddings(emb: torch.Tensor, length: int,
                            window_size: int) -> torch.Tensor:
    """Slice the (H, 2w+1, D) table to the (H, 2*length-1, D) band needed."""
    pad_length = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        emb = F.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, start: start + 2 * length - 1, :]


def relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) rel-indexed logits -> (B, H, T, T) absolute logits."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, t * 2 * t), (0, t - 1))
    return x_flat.reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1:]


def absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, T) absolute attention -> (B, H, T, 2T-1) rel-indexed."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    x_flat = F.pad(x.reshape(b, h, t * t + t * (t - 1)), (t, 0))
    return x_flat.reshape(b, h, t, 2 * t)[:, :, :, 1:]


def relative_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           emb_rel_k: torch.Tensor, emb_rel_v: torch.Tensor,
                           window_size: int,
                           attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain rel-pos attention (skew formulation), softmax in float32."""
    d = q.shape[-1]
    t = k.shape[2]
    qs = q * (1.0 / d ** 0.5)
    scores = qs @ k.transpose(-1, -2)
    rel_k = get_relative_embeddings(emb_rel_k, t, window_size)
    scores = scores + relative_to_absolute(qs @ rel_k.transpose(-1, -2))
    if attn_mask is not None:
        scores = scores.masked_fill(attn_mask == 0, -1e4)
    p = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
    out = p @ v
    rel_v = get_relative_embeddings(emb_rel_v, t, window_size)
    return out + absolute_to_relative(p) @ rel_v
