"""FCPE pitch estimator (counterpart of `rvc_tpu/models/fcpe.py`).

    log-mel(128) -> stack (Conv1d -> GroupNorm(4) -> LeakyReLU -> Conv1d)
    -> n_layers x [x += FastAttention(LN(x)); x += ConformerConvModule(x)]
    -> LN -> Linear -> 360-bin sigmoid -> local weighted-argmax cents
    decode with a confidence gate.

Module names are the upstream `FCPE.py`'s (`stack.0/1/3`,
`decoder._layers.N.{norm, attn.to_q/k/v/out,
attn.fast_attention.projection_matrix, conformer.net.0/2/4.conv/6}`, `norm`,
`dense_out`), so an upstream `fcpe.pt` loads after its weight norm is fused
(`utils.weights.fcpe_from_pth`). FastAttention is the performer's
softmax-kernel linear attention over a Gaussian orthogonal projection (a
buffer). The reference computes all of it in XLA, with no Pallas kernel,
so it stays plain PyTorch (cuDNN / cuBLAS in float32 on the card).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from rvc_tpu_torch.ops.stft import mel_filterbank, stft

N_MELS = 128
OUT_DIMS = 360
F0_MIN_CENT = 32.70
F0_MAX_CENT = 1975.5
CENT_TABLE = np.linspace(1200.0 * np.log2(F0_MIN_CENT / 10.0),
                         1200.0 * np.log2(F0_MAX_CENT / 10.0), OUT_DIMS).astype(np.float32)


def gaussian_orthogonal_matrix(nb_rows: int, nb_cols: int,
                               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Orthogonal random features (the performer's, scaling 0): stacked
    (nb_cols, nb_cols) QR blocks, each row scaled by the norm of a
    Gaussian row. (nb_rows, nb_cols) float32, drawn on the host."""
    blocks = []
    for i in range(-(-nb_rows // nb_cols)):
        q, _ = torch.linalg.qr(torch.randn((nb_cols, nb_cols), generator=generator))
        blocks.append(q.T[: nb_rows - i * nb_cols])
    mult = torch.randn((nb_rows, nb_cols), generator=generator).norm(dim=1)
    return mult[:, None] * torch.cat(blocks)


def softmax_kernel(data: torch.Tensor, projection: torch.Tensor, is_query: bool,
                   eps: float = 1e-4) -> torch.Tensor:
    """The exp random-feature map. (B, H, T, D), (M, D) -> (B, H, T, M).
    As the reference: queries subtract their row max; keys add eps inside
    the exp."""
    normalizer = data.shape[-1] ** -0.25
    ratio = projection.shape[0] ** -0.5
    dash = (normalizer * data) @ projection.T
    diag = (data ** 2).sum(-1, keepdim=True) / 2.0 * normalizer ** 2
    if is_query:
        return ratio * (torch.exp(dash - diag - dash.amax(-1, keepdim=True)) + eps)
    return ratio * torch.exp(dash - diag + eps)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """O(T) attention: q (k^T v) / (q . sum_t k)."""
    d_inv = 1.0 / ((q @ k.sum(-2)[..., None])[..., 0] + 1e-8)       # (B, H, T)
    return (q @ (k.transpose(-1, -2) @ v)) * d_inv[..., None]


class FastAttention(nn.Module):
    def __init__(self, dim_head: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        nb_features = int(dim_head * math.log(dim_head))
        self.register_buffer("projection_matrix",
                             gaussian_orthogonal_matrix(nb_features, dim_head, generator))

    def forward(self, q, k, v):
        qp = softmax_kernel(q, self.projection_matrix, is_query=True)
        kp = softmax_kernel(k, self.projection_matrix, is_query=False)
        return linear_attention(qp, kp, v)


class SelfAttention(nn.Module):
    """(B, T, dim) -> (B, T, dim); heads of 64 as upstream fixes them."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.fast_attention = FastAttention(dim_head, generator)
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape

        def split(t):
            return t.reshape(B, T, self.heads, self.dim_head).transpose(1, 2)

        out = self.fast_attention(split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x)))
        return self.to_out(out.transpose(1, 2).reshape(B, T, -1))


class _Transpose(nn.Module):
    def forward(self, x):
        return x.transpose(1, 2)


class DepthWiseConv1d(nn.Module):
    """Depthwise conv on (B, C, T) with upstream's 'same' padding
    (k // 2, k // 2 - (k + 1) % 2)."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.padding = (kernel_size // 2, kernel_size // 2 - (kernel_size + 1) % 2)
        self.conv = nn.Conv1d(channels, channels, kernel_size, groups=channels)

    def forward(self, x):
        return self.conv(F.pad(x, self.padding))


class ConformerConvModule(nn.Module):
    """LN -> 1x1 conv -> GLU -> depthwise conv -> Swish -> 1x1 conv, on
    (B, T, dim), under upstream's `net.N` indices."""

    def __init__(self, dim: int, expansion_factor: int = 2, kernel_size: int = 31):
        super().__init__()
        inner = dim * expansion_factor
        self.net = nn.Sequential(
            nn.LayerNorm(dim), _Transpose(), nn.Conv1d(dim, 2 * inner, 1), nn.GLU(dim=1),
            DepthWiseConv1d(inner, kernel_size), nn.SiLU(), nn.Conv1d(inner, dim, 1),
            _Transpose())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 8, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conformer = ConformerConvModule(dim)
        self.norm = nn.LayerNorm(dim)
        self.attn = SelfAttention(dim, heads, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm(x))
        return x + self.conformer(x)


class PCmer(nn.Module):
    def __init__(self, n_layers: int, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._layers = nn.ModuleList(EncoderLayer(dim, generator=generator)
                                     for _ in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self._layers:
            x = layer(x)
        return x


class FCPEModel(nn.Module):
    """mel (B, T, 128) -> salience (B, T, 360). generator draws the
    attention layers' projection matrices (the default generator when None)."""

    def __init__(self, n_layers: int = 12, n_chans: int = 512, input_channel: int = N_MELS,
                 out_dims: int = OUT_DIMS, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stack = nn.Sequential(
            nn.Conv1d(input_channel, n_chans, 3, padding=1), nn.GroupNorm(4, n_chans),
            nn.LeakyReLU(), nn.Conv1d(n_chans, n_chans, 3, padding=1))
        self.decoder = PCmer(n_layers, n_chans, generator)
        self.norm = nn.LayerNorm(n_chans)
        self.dense_out = nn.Linear(n_chans, out_dims)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = self.stack(mel.transpose(1, 2)).transpose(1, 2)
        return torch.sigmoid(self.dense_out(self.norm(self.decoder(h))))


def cents_local_decoder(y: torch.Tensor, threshold: float = 0.05) -> torch.Tensor:
    """(B, T, 360) -> f0 (B, T): the weighted average of the cents of the 9
    bins around the argmax (indices clipped to [0, 359]), 0 where the peak
    is at or under threshold."""
    ci = torch.from_numpy(CENT_TABLE).to(y.device)
    idx = (y.argmax(-1)[..., None] + torch.arange(-4, 5, device=y.device)).clamp(0, OUT_DIMS - 1)
    y_l = y.gather(-1, idx)
    cents = (ci[idx] * y_l).sum(-1) / y_l.sum(-1).clamp_min(1e-12)
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    return torch.where(y.amax(-1) > threshold, f0, torch.zeros_like(f0))


class FCPE:
    """16 kHz audio -> f0 at hop 160. model: an `FCPEModel` (kept where it
    lives); None builds the 12 x 512 one on the host from torch seed `seed`
    and moves it to `device` (the CPU when None)."""

    def __init__(self, model: Optional[FCPEModel] = None, seed: int = 0,
                 threshold: float = 0.05, device=None):
        if model is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = FCPEModel(generator=torch.Generator().manual_seed(seed))
            model = model.to(device or "cpu")
        self.model = model.eval().requires_grad_(False)
        self.device = next(model.parameters()).device
        self.threshold = threshold

    def mel(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, 1 + (T - 160) // 160, 128) log-mel: reflect pad
        (432, 432), center=False STFT, Slaney mel to 8 kHz, log(clamp 1e-5)."""
        n_fft, hop = 1024, 160
        y = F.pad(audio[:, None], ((n_fft - hop) // 2, (n_fft - hop + 1) // 2),
                  mode="reflect")[:, 0]
        z = stft(y, n_fft, hop, n_fft, center=False)
        mag = torch.sqrt(z.real ** 2 + z.imag ** 2 + 1e-9)
        fb = torch.from_numpy(mel_filterbank(16000, n_fft, N_MELS, 0, 8000, htk=False))
        return torch.log(torch.clamp(mag @ fb.to(mag.device).T, min=1e-5))

    def infer_from_audio(self, audio, threshold: Optional[float] = None) -> np.ndarray:
        """audio (T,) or (B, T) 16 kHz -> f0 per frame, numpy float32."""
        audio = torch.as_tensor(np.asarray(audio, dtype=np.float32))
        squeeze = audio.dim() == 1
        with torch.inference_mode():
            x = audio[None] if squeeze else audio
            sal = self.model(self.mel(x.to(self.device)))
            f0 = cents_local_decoder(sal, threshold or self.threshold).cpu().numpy()
        return f0[0] if squeeze else f0
