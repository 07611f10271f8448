"""CREPE pitch estimator, full and tiny (counterpart of
`rvc_tpu/models/crepe.py`).

`CREPEModel` is torchcrepe's network under torchcrepe's names (`conv1` ..
`conv6`, `conv{i}_BN`, `classifier`), so a torchcrepe state dict loads with
strict=True: 1024-sample frames, six layers of pad -> Conv2d (k = (512, 1)
stride (4, 1), then (64, 1)) -> ReLU -> BatchNorm (eps 1e-3) -> MaxPool
(2, 1), a flatten in (H, C) order, Linear -> 360-bin sigmoid. `CREPE.get_f0`
frames the whole clip at once (no 512-frame chunks, as the reference),
decodes the weighted local average of +-4 bins around the peak, smooths,
gates on periodicity, and resamples other hops onto the 10 ms grid.
Convolutions and the classifier are cuDNN / cuBLAS calls in float32; the
reference has no Pallas kernel here.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

PITCH_BINS = 360
SAMPLE_RATE = 16000
HOP_SIZE = 160
WINDOW_SIZE = 1024
CENTS_PER_BIN = 20.0
FMIN_REF = 10.0
CENTS = (CENTS_PER_BIN * np.arange(PITCH_BINS) + 1997.3794084376191).astype(np.float32)

_SIZES = {
    "full": dict(channels=(1024, 128, 128, 128, 256, 512), in_features=2048),
    "tiny": dict(channels=(128, 16, 16, 16, 32, 64), in_features=256),
}


class CREPEModel(nn.Module):
    """Frames (B, 1024) -> pitch-bin probabilities (B, 360)."""

    def __init__(self, variant: str = "full"):
        super().__init__()
        spec = _SIZES[variant]
        self.variant = variant
        self.in_features = spec["in_features"]
        in_ch = 1
        for i, out_ch in enumerate(spec["channels"]):
            k, s = ((512, 1), (4, 1)) if i == 0 else ((64, 1), (1, 1))
            setattr(self, f"conv{i + 1}", nn.Conv2d(in_ch, out_ch, k, s))
            setattr(self, f"conv{i + 1}_BN", nn.BatchNorm2d(out_ch, eps=1e-3))
            in_ch = out_ch
        self.classifier = nn.Linear(self.in_features, PITCH_BINS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :, None]                               # (B, 1, 1024, 1)
        for i in range(1, 7):
            h = F.pad(h, (0, 0, 254, 254) if i == 1 else (0, 0, 31, 32))
            h = F.relu(getattr(self, f"conv{i}")(h))
            h = F.max_pool2d(getattr(self, f"conv{i}_BN")(h), (2, 1), (2, 1))
        # torchcrepe's permute(0, 2, 1, 3): flatten in (H, C) order
        h = h.permute(0, 2, 1, 3).reshape(x.shape[0], self.in_features)
        return torch.sigmoid(self.classifier(h))


def frame_audio(audio: torch.Tensor, hop: int = HOP_SIZE) -> torch.Tensor:
    """(B, T) -> frames (B, n_frames, 1024), reflect-padded by 512 and each
    normalized by its mean and population std (as `jnp.std`)."""
    pad = WINDOW_SIZE // 2
    audio = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = audio.unfold(-1, WINDOW_SIZE, hop)
    mean = frames.mean(-1, keepdim=True)
    std = frames.std(-1, correction=0, keepdim=True)
    return (frames - mean) / std.clamp_min(1e-10)


def decode_probabilities(probs: torch.Tensor, f0_min: float, f0_max: float) -> tuple:
    """(T, 360) -> (f0 (T,), periodicity (T,)): the weighted average of the
    cents of the 9 bins around the peak inside [f0_min, f0_max] (bins past
    the ends weigh 0)."""
    cents = torch.from_numpy(CENTS).to(probs.device)
    valid = (cents >= 1200.0 * math.log2(f0_min / FMIN_REF)) & \
            (cents <= 1200.0 * math.log2(f0_max / FMIN_REF))
    p = torch.where(valid, probs, torch.zeros_like(probs))
    peak = p.argmax(-1)
    periodicity = p.gather(-1, peak[:, None])[:, 0]
    idx = peak[:, None] + torch.arange(9, device=p.device)     # in bins padded by 4
    w = F.pad(p, (4, 4)).gather(-1, idx)
    cw = F.pad(cents, (4, 4))[idx]
    wsum = w.sum(-1)
    f0_cents = torch.where(wsum > 0, (w * cw).sum(-1) / wsum.clamp_min(1e-12),
                           torch.zeros_like(wsum))
    return FMIN_REF * 2.0 ** (f0_cents / 1200.0), periodicity


def _mean_filter3(x: torch.Tensor) -> torch.Tensor:
    xp = F.pad(x[None, None], (1, 1), mode="replicate")[0, 0]
    return (xp[:-2] + xp[1:-1] + xp[2:]) / 3.0


def _median_filter3(x: torch.Tensor) -> torch.Tensor:
    xp = F.pad(x[None, None], (1, 1), mode="replicate")[0, 0]
    return torch.stack([xp[:-2], xp[1:-1], xp[2:]]).median(0).values


class CREPE:
    """``CREPE(variant).get_f0(audio)``. model: a `CREPEModel` (kept where
    it lives); None builds one on the host from torch seed `seed` and moves
    it to `device` (the CPU when None)."""

    def __init__(self, variant: str = "full", model: Optional[CREPEModel] = None,
                 seed: int = 0, device=None):
        if model is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = CREPEModel(variant)
            model = model.to(device or "cpu")
        self.variant = model.variant
        self.model = model.eval().requires_grad_(False)
        self.device = next(model.parameters()).device

    def get_f0(self, audio: np.ndarray, f0_min: float = 50.0, f0_max: float = 1100.0,
               threshold: float = 0.1, return_periodicity: bool = False, hop: int = HOP_SIZE):
        """audio (T,) 16 kHz -> f0 (0 = unvoiced) on the 10 ms grid, numpy
        float32; with return_periodicity also the smoothed periodicity."""
        audio = np.asarray(audio, dtype=np.float32)
        n_samples = len(audio)
        with torch.inference_mode():
            frames = frame_audio(torch.from_numpy(audio)[None].to(self.device), hop)[0]
            f0, per = decode_probabilities(self.model(frames), f0_min, f0_max)
            f0_raw = _mean_filter3(f0).cpu().numpy()
            per = _median_filter3(per).cpu().numpy()
        f0 = np.where(per < threshold, 0.0, f0_raw).astype(np.float32)
        if hop != HOP_SIZE:
            # onto the 10 ms grid: interpolate the pitch before the gate, so
            # frames next to unvoiced ones do not glide toward 0 Hz
            t_src = np.arange(len(f0_raw)) * hop
            t_dst = np.arange(n_samples // HOP_SIZE + 1) * HOP_SIZE
            per_i = np.interp(t_dst, t_src, per)
            f0 = np.interp(t_dst, t_src, f0_raw)
            f0 = np.where(per_i < threshold, 0.0, f0).astype(np.float32)
            per = per_i.astype(np.float32)
        if return_periodicity:
            return f0, per
        return f0
