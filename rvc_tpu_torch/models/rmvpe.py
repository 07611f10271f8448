"""RMVPE pitch detector (counterpart of `rvc_tpu/models/rmvpe.py`, canonical
path): log-mel (B, T, 128) -> DeepUnet -> 3-channel conv -> BiGRU ->
Linear -> 360-bin sigmoid salience, and `decode_salience` to f0 in Hz.
`RMVPE` is the predictor over an `E2E`: audio -> log-mel (kernel K4 on the
card) -> reflect pad to a multiple of 32 frames -> E2E -> decode.

Module names follow the upstream torch E2E (`rvc/lib/predictors/RMVPE.py`):
`unet.{encoder,intermediate,decoder}.layers.i`, `conv.j.conv.{0,1,3,4}`,
`shortcut`, `conv1.{0,1}`, `conv2.j`, `cnn`, `fc.0.gru`, `fc.1`. Activations
stay channels-last (B, T, M, C) as in the reference. The reference's packed-
frequency U-Net (`ops/packed_freq.py`, `prepack_unet_variables`) is a TPU
layout of the same function and has no counterpart here.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from rvc_tpu_torch.models.layers import BatchNorm, Conv2d, ConvTranspose2d
from rvc_tpu_torch.ops.gru import BiGRU
from rvc_tpu_torch.ops.kernels.melspec import log_mel

N_MELS = 128
N_CLASS = 360
CENTS_MAPPING = (20.0 * np.arange(N_CLASS) + 1997.3794084376191).astype(np.float32)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, on (B, H, W, C); odd edges dropped."""
    B, H, W, C = x.shape
    x = x[:, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


class ConvBlockRes(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, momentum: float = 0.01):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm(out_channels, momentum=momentum),
            nn.ReLU(),
            Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm(out_channels, momentum=momentum),
            nn.ReLU(),
        )
        if in_channels != out_channels:
            self.shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.shortcut(x) if hasattr(self, "shortcut") else x
        return self.conv(x) + res


class ResEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_blocks: int = 1,
                 pool: bool = True):
        super().__init__()
        self.pool = pool
        self.conv = nn.ModuleList(
            ConvBlockRes(in_channels if i == 0 else out_channels, out_channels)
            for i in range(n_blocks))

    def forward(self, x: torch.Tensor):
        for block in self.conv:
            x = block(x)
        if not self.pool:
            return x
        return x, _avg_pool2(x)


class ResDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_blocks: int = 1):
        super().__init__()
        self.conv1 = nn.Sequential(
            ConvTranspose2d(in_channels, out_channels, 3, stride=2, padding=1,
                            output_padding=1, bias=False),
            BatchNorm(out_channels, momentum=0.01),
            nn.ReLU(),
        )
        self.conv2 = nn.ModuleList(
            ConvBlockRes(out_channels * 2 if i == 0 else out_channels, out_channels)
            for i in range(n_blocks))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        th, tw = skip.shape[1], skip.shape[2]
        # crop / zero-pad to the skip's spatial shape before the concat
        x = F.pad(x, (0, 0, 0, max(0, tw - x.shape[2]), 0, max(0, th - x.shape[1])))
        x = torch.cat([x[:, :th, :tw], skip], dim=-1)
        for block in self.conv2:
            x = block(x)
        return x


class Encoder(nn.Module):
    def __init__(self, in_channels: int, n_layers: int, out_channels: int, n_blocks: int):
        super().__init__()
        self.bn = BatchNorm(in_channels, momentum=0.01)
        self.layers = nn.ModuleList()
        cin, cout = in_channels, out_channels
        for _ in range(n_layers):
            self.layers.append(ResEncoderBlock(cin, cout, n_blocks))
            cin, cout = cout, cout * 2
        self.out_channels = cin

    def forward(self, x: torch.Tensor):
        x = self.bn(x)
        skips = []
        for layer in self.layers:
            skip, x = layer(x)
            skips.append(skip)
        return x, skips


class Intermediate(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_inters: int, n_blocks: int):
        super().__init__()
        self.layers = nn.ModuleList(
            ResEncoderBlock(in_channels if i == 0 else out_channels, out_channels,
                            n_blocks, pool=False) for i in range(n_inters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class Decoder(nn.Module):
    def __init__(self, in_channels: int, n_layers: int, n_blocks: int):
        super().__init__()
        self.layers = nn.ModuleList()
        cin = in_channels
        for _ in range(n_layers):
            self.layers.append(ResDecoderBlock(cin, cin // 2, n_blocks))
            cin //= 2

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, skips[-1 - i])
        return x


class DeepUnet(nn.Module):
    def __init__(self, n_blocks: int = 4, en_de_layers: int = 5, inter_layers: int = 4,
                 in_channels: int = 1, en_out_channels: int = 16):
        super().__init__()
        self.encoder = Encoder(in_channels, en_de_layers, en_out_channels, n_blocks)
        c = self.encoder.out_channels
        self.intermediate = Intermediate(c, 2 * c, inter_layers, n_blocks)
        self.decoder = Decoder(2 * c, en_de_layers, n_blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, skips = self.encoder(x)
        return self.decoder(self.intermediate(x), skips)


class E2E(nn.Module):
    """mel (B, T, 128) -> salience (B, T, 360). T must be a multiple of
    2 ** en_de_layers (the pipeline reflect-pads to a multiple of 32)."""

    def __init__(self, n_blocks: int = 4, n_gru: int = 1, en_de_layers: int = 5,
                 inter_layers: int = 4, en_out_channels: int = 16,
                 gru_hidden: int = 256):
        super().__init__()
        self.unet = DeepUnet(n_blocks, en_de_layers, inter_layers, 1, en_out_channels)
        self.cnn = Conv2d(en_out_channels, 3, 3, padding=1)
        if n_gru:
            self.fc = nn.Sequential(BiGRU(3 * N_MELS, gru_hidden, n_gru),
                                    nn.Linear(2 * gru_hidden, N_CLASS))
        else:
            self.fc = nn.Sequential(nn.Linear(3 * N_MELS, N_CLASS))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.cnn(self.unet(mel[..., None]))          # (B, T, M, 3)
        B, T, M, C = x.shape
        # upstream flattens (B, T, C, M) -> (B, T, C*M)
        x = x.permute(0, 1, 3, 2).reshape(B, T, C * M)
        # the BiGRU / fc / sigmoid head runs float32 whatever the trunk's
        # dtype (`rvc_tpu/models/rmvpe.py:294-297`)
        return torch.sigmoid(self.fc(x.float()))


@lru_cache(maxsize=4)
def _cents_padded(device: str) -> torch.Tensor:
    """CENTS_MAPPING with 4 zero bins each side, kept on `device`, so a
    decode copies nothing from the host (such a copy waits for the queue)."""
    return F.pad(torch.from_numpy(CENTS_MAPPING), (4, 4)).to(device)


def decode_salience(hidden: torch.Tensor, thred: float = 0.03) -> torch.Tensor:
    """(B, T, 360) salience -> (B, T) f0 in Hz (0 = unvoiced): the weighted
    average of cents over 9 bins around the argmax, gated on the peak."""
    center = torch.argmax(hidden, dim=-1)
    idx = center[..., None] + torch.arange(9, device=hidden.device)  # in padded bins
    weights = torch.gather(F.pad(hidden, (4, 4)), -1, idx)
    cents_pad = _cents_padded(str(hidden.device))
    wsum = weights.sum(-1)
    wcent = (weights * cents_pad[idx]).sum(-1)
    cents = torch.where(wsum > 0, wcent / wsum.clamp_min(1e-12), torch.zeros_like(wsum))
    cents = torch.where(hidden.amax(-1) > thred, cents, torch.zeros_like(cents))
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    return torch.where(cents > 0, f0, torch.zeros_like(f0))


class RMVPE:
    """audio -> f0, as the reference's `RMVPE` predictor. model: an `E2E`
    (kept where it lives: the pipeline passes its own); None builds the
    full-size one on the host from torch seed `seed` and moves it to
    `device` (the CPU when None)."""

    def __init__(self, model: Optional[E2E] = None, seed: int = 0, device=None):
        if model is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = E2E()
            model = model.to(device or "cpu").eval().requires_grad_(False)
        self.model = model
        self.device = next(model.parameters()).device

    @staticmethod
    def mel(audio: torch.Tensor) -> torch.Tensor:
        """(B, T) 16 kHz -> (B, 1 + T // 160, 128) log-mel (HTK, 30-8000 Hz): K4."""
        return log_mel(audio, 1024, 160, N_MELS, 16000, 30.0, 8000.0, htk=True)

    def mel2hidden(self, mel: torch.Tensor,
                   unet_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(B, T, 128) -> salience (B, T, 360) float32, through a reflect pad
        of the frames to a multiple of 32. unet_dtype bf16 casts the padded
        mel so that the U-Net trunk runs in bf16 (the float32 weights cast at
        use, norm statistics float32; `RVC_TPU_BF16_F0`)."""
        n_frames = mel.shape[1]
        pad = 32 * ((n_frames - 1) // 32 + 1) - n_frames
        if pad:
            mel = F.pad(mel.transpose(1, 2), (0, pad), mode="reflect").transpose(1, 2)
        return self.model(mel.to(unet_dtype))[:, :n_frames]

    def infer_from_audio(self, audio, thred: float = 0.03) -> np.ndarray:
        """audio (T,) or (B, T) 16 kHz -> f0 per frame (hop 160), numpy."""
        audio = torch.as_tensor(np.asarray(audio, dtype=np.float32))
        squeeze = audio.dim() == 1
        with torch.inference_mode():
            x = (audio[None] if squeeze else audio).to(self.device)
            f0 = decode_salience(self.mel2hidden(self.mel(x)), thred).cpu().numpy()
        return f0[0] if squeeze else f0
