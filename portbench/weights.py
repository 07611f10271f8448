"""Seeded weights: one state dict per network, made on the device from the
seed in one large draw, float32 (the type the program is handed).

Scales follow the networks' own initialisations, so that every layer
shows in the output: convolutions and linear layers N(0, 1 / (3 fan_in))
(the spread of torch's default uniform init), the GRU N(0, 1 / (3 H)),
embeddings N(0, 1), the relative-position tables N(0, 1 / d), norms near 1
and 0, batch-norm statistics near 0 and 1. The NSF decoder's upsampling
convolutions and ResBlocks take HiFi-GAN's N(0, 0.01), and the upsampling
convolutions are then scaled by `UPS_GAIN` (10). At gain 1 to 6 a random
full-width decoder emits little but its sine source (another speaker id
moves the waveform by under 6%); at 20, as the repository's small-width
tests scale them, 89% of the samples saturate the output tanh; at 10 the
speaker id moves the waveform by ~40% and ~14% of samples pass 0.9.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

UPS_GAIN = 10.0


def _scale(module: nn.Module, name: str, shape) -> tuple:
    """(mean, std) of the draw for one tensor of `module`."""
    owner_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    owner = module.get_submodule(owner_name)
    if isinstance(owner, nn.Embedding):
        return 0.0, 1.0
    if leaf == "running_var":
        return 1.0, 0.1
    if leaf == "running_mean":
        return 0.0, 0.1
    norm = isinstance(owner, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)) or leaf in ("gamma",
                                                                                     "beta")
    if norm:
        return (1.0, 0.1) if leaf in ("weight", "gamma") else (0.0, 0.1)
    if leaf.startswith("emb_rel"):
        return 0.0, shape[-1] ** -0.5
    if isinstance(owner, nn.GRU):
        return 0.0, shape[0] ** -0.5                    # 1 / sqrt(3 H)
    if name.startswith("dec.") and (".ups." in name or ".resblocks." in name) \
            and leaf == "weight":
        return 0.0, 0.01 * (UPS_GAIN if ".ups." in name else 1.0)
    w = owner.weight
    return 0.0, (3.0 * w.shape[1] * math.prod(w.shape[2:])) ** -0.5


def make(module: nn.Module, seed: int, device, stream: int = 0) -> Dict[str, torch.Tensor]:
    """A state dict with `module`'s names and shapes (the reference network
    of the same architecture as the program's), drawn from (seed, stream)."""
    sd = module.state_dict()
    floats = [(k, v.shape) for k, v in sd.items() if v.is_floating_point()]
    total = sum(math.prod(s) for _, s in floats)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + stream) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = torch.zeros_like(v, device=device)
            continue
        n = v.numel()
        mean, std = _scale(module, k, v.shape)
        out[k] = (flat[at: at + n].view(v.shape) * std + mean)
        if k.endswith("running_var"):
            out[k] = out[k].abs()
        at += n
    return out
