"""TextEncoder, enc_p, and PosteriorEncoder, enc_q (counterpart of
`rvc_tpu/models/encoders.py`).

phone (768) -> Linear (+ pitch Embedding(256, H)) -> * sqrt(H) ->
LeakyReLU(0.1) -> n_layers x [rel-pos MHA + LN + FFN + LN] -> 1x1 conv ->
(m_p, logs_p). The attention goes through kernel K3. The posterior encoder
(training only) takes the linear spectrogram through a 1x1 conv, a WaveNet
and a 1x1 conv to (m_q, logs_q) and draws z = m_q + eps exp(logs_q).

Under tensor parallelism (`parallel.tp`, `tp` set) the attention runs the
rank's H / n heads (QKV column-parallel, K3 on those heads, O
row-parallel) and the FFN the rank's hidden columns (conv_1 column,
conv_2 row); each sums its output over the model group before its whole
bias.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from rvc_tpu_torch.models.layers import Conv1d, LayerNorm, WaveNet, leaky_relu
from rvc_tpu_torch.ops import conv as conv_ops
from rvc_tpu_torch.ops.commons import draw, sequence_mask
from rvc_tpu_torch.ops.kernels.attention import rel_attention
from rvc_tpu_torch.parallel.tp import copy_to_model, local_slice, reduce_from_model


def _conv_shard(x: torch.Tensor, conv: Conv1d, bias) -> torch.Tensor:
    """conv on this rank's shard of its weight, with `bias` (or none)."""
    return conv_ops.conv1d(x, conv.weight.permute(2, 1, 0), bias, padding=conv.padding[0])


class MultiHeadAttention(nn.Module):
    """Self-attention with windowed relative position embeddings
    (window 10, one table shared by the heads)."""

    tp = None    # the model Axis where QKV / O run tensor-parallel

    def tp_pair(self, model_size: int):
        """(column members, row members) of its tensor-parallel pair; None
        where the heads do not split evenly over the model axis."""
        if self.n_heads % model_size:
            return None
        return ("conv_q.weight", "conv_k.weight", "conv_v.weight"), ("conv_o.weight",)

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 10):
        super().__init__()
        self.n_heads = n_heads
        self.window_size = window_size
        d = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, d) * d ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, d) * d ** -0.5)

    def forward(self, x: torch.Tensor, key_lens: torch.Tensor) -> torch.Tensor:
        """x (B, T, C), key_lens (B,) int32; rows past a length are garbage."""
        B, T, C = x.shape
        H = self.n_heads

        tp = self.tp
        if tp is not None:      # the rank's heads
            H, C = H // tp.size, C // tp.size
            x = copy_to_model(x, tp)
            q, k, v = (_conv_shard(x, c, local_slice(c.bias, 0, tp))
                       for c in (self.conv_q, self.conv_k, self.conv_v))
            emb_k, emb_v = copy_to_model(self.emb_rel_k, tp), copy_to_model(self.emb_rel_v, tp)
        else:
            q, k, v = self.conv_q(x), self.conv_k(x), self.conv_v(x)
            emb_k, emb_v = self.emb_rel_k, self.emb_rel_v

        def split(t):
            return t.reshape(B, T, H, C // H).transpose(1, 2)

        out = rel_attention(split(q), split(k), split(v), emb_k, emb_v, self.window_size,
                            key_lens).transpose(1, 2).reshape(B, T, C)
        if tp is None:
            return self.conv_o(out)
        return reduce_from_model(_conv_shard(out, self.conv_o, None), tp) + self.conv_o.bias


class FFN(nn.Module):
    """Conv feed-forward with same padding and ReLU."""

    tp = None    # the model Axis where conv_1 / conv_2 run tensor-parallel

    def tp_pair(self, model_size: int):
        return ("conv_1.weight",), ("conv_2.weight",)

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size, padding=pad)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size, padding=pad)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is None:
            x = torch.relu(self.conv_1(x * x_mask))
            return self.conv_2(x * x_mask) * x_mask
        x = copy_to_model(x * x_mask, tp)
        x = torch.relu(_conv_shard(x, self.conv_1, local_slice(self.conv_1.bias, 0, tp)))
        x = reduce_from_model(_conv_shard(x * x_mask, self.conv_2, None), tp)
        return (x + self.conv_2.bias) * x_mask


class AttentionEncoder(nn.Module):
    """Stack of [rel-pos MHA, post-LN, FFN, post-LN] blocks."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, window_size: int = 10):
        super().__init__()
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, hidden_channels, n_heads, window_size)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels, kernel_size)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        # counted in int32: a bf16 sum of the mask rounds past 256
        key_lens = x_mask[:, :, 0].sum(-1, dtype=torch.int32)
        x = x * x_mask
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1,
                                     self.ffn_layers, self.norm_layers_2):
            x = n1(x + attn(x, key_lens))
            x = n2(x + ffn(x, x_mask))
        return x * x_mask


class TextEncoder(nn.Module):
    def __init__(self, out_channels: int, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int,
                 embedding_dim: int = 768, use_f0: bool = True):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.emb_phone = nn.Linear(embedding_dim, hidden_channels)
        if use_f0:
            self.emb_pitch = nn.Embedding(256, hidden_channels)
        self.encoder = AttentionEncoder(hidden_channels, filter_channels, n_heads,
                                        n_layers, kernel_size)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, phone: torch.Tensor, pitch: Optional[torch.Tensor],
                lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """phone (B, T, 768), pitch (B, T) int or None, lengths (B,) ->
        (m_p, logs_p, x_mask (B, T, 1))."""
        x = self.emb_phone(phone)
        if pitch is not None and hasattr(self, "emb_pitch"):
            x = x + self.emb_pitch(pitch)
        x = leaky_relu(x * math.sqrt(self.hidden_channels), 0.1)
        x_mask = sequence_mask(lengths, x.shape[1])[:, :, None].to(x.dtype)
        x = self.encoder(x, x_mask)
        stats = self.proj(x) * x_mask
        m, logs = torch.chunk(stats, 2, dim=-1)
        return m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """enc_q: spectrogram (B, T, in_channels) -> (z, m_q, logs_q, y_mask)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 0):
        super().__init__()
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WaveNet(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                g: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """eps: the standard normal draw (B, T, out_channels); else drawn
        from `generator` (on x's device)."""
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].to(x.dtype)
        h = self.enc(self.pre(x) * x_mask, x_mask, g=g)
        stats = self.proj(h) * x_mask
        m, logs = torch.chunk(stats, 2, dim=-1)
        if eps is None:
            if generator is None:
                raise ValueError("PosteriorEncoder needs eps or a generator to draw it")
            eps = draw(torch.randn, m.shape, generator, m.device)
        z = (m + eps * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask
