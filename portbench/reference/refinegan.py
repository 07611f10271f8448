"""The plain reference of RefineGAN, Applio's third vocoder, in float32
PyTorch, and of conversion through a RefineGAN voice.

The decoder follows upstream `rvc/lib/algorithm/generators/refinegan.py`
(`RefineGANGenerator`, line 268) step by step:

1. f0 (B, T) linearly interpolated to audio rate (T * upp samples, edges
   held: `F.interpolate(..., mode="linear")`);
2. the sine template (`SineGenerator`, one harmonic): phase = 2 pi
   cumsum(f0 / sr mod 1 + wrap), wrap -1 where the running fraction wraps;
   amplitude 0.1 where voiced, noise of 0.003 voiced and 0.1 / 3 unvoiced;
3. its 1 -> 1 merge (`m_source.merge.0`, no bias) and tanh, `pre_conv`;
4. for each rate from the last: LReLU 0.2, the tap kept as a skip,
   anti-aliased decimation by the rate, `downsample_blocks.i`;
5. `mel_conv` of the latent plus `cond` of the speaker, joined with the
   decimated template (latent first);
6. for each rate: LReLU 0.2, linear upsampling by the rate, the skip tap
   of the same rate joined (cut to the shorter), a `ParallelResBlock`:
   `input_conv` (k 7), then the mean over kernel sizes 3, 7, 11 of AdaIN
   -> ResBlock (dilations 1, 3, 5, two convolutions a step, LReLU 0.2
   before each, a residual) -> AdaIN; AdaIN adds Gaussian noise times a
   learned per-channel weight, then LReLU 0.2;
7. LReLU 0.2, `conv_post` (k 7, no bias), tanh.

Departures, each kept as small as the comparison needs:
- the noise comes from one `torch.Generator` handed in (upstream draws
  from torch's global generator), in this order: the sine template's
  initial phases `rand` (rows, 1) (zero for the one harmonic, but drawn),
  its noise `randn` (rows, T * upp, 1); then for each stage and each of
  its three branches AdaIN before and AdaIN after, `randn` at
  (rows, T_stage, C_stage), time before channel (upstream's `randn_like`
  of a channels-first tensor draws (rows, C, T)), transposed here. A
  conversion's dispatch of `rows` windows draws for all of them and each
  window takes its row (`rows`), so on the same device this noise is the
  program's, number for number;
- upstream decimates with `torchaudio.functional.resample` (Kaiser
  window, width 64, rolloff 0.9476, beta 14.77); here that filter is a
  depthwise convolution of stride `rate` over the signal padded by its
  half width with zeros, its taps made in float64 and normalised to sum
  to 1 (`sinc_taps`);
- upstream fixes 16 start channels, which is upsample_initial_channel /
  2^(stages + 1) at its one size (512, four rates); that formula here,
  so that smaller widths build;
- weight norm is folded into plain weights (the checkpoint's names
  without `_g` / `_v`, as an exported voice carries them).

Parameter names are the port's and upstream's (`dec.pre_conv`,
`dec.downsample_blocks.N`, `dec.mel_conv`, `dec.cond`,
`dec.upsample_conv_blocks.N.input_conv`, `....blocks.J.{0,1,2}`,
`dec.conv_post`, `dec.m_source.merge.0`), so one state dict loads here
and into the program. Every convolution and product goes through
`nets.conv1d` / `nets.linear` / `nets.rnd` under the part "dec", so the
control's "dec": "bf16" computes the decoder in bf16. Activations are
channels-first (B, C, T). Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from portbench.reference import dsp, nets
from portbench.reference.offline import NOISE_SEED, SR, WIN, f0_program, long_jobs

SLOPE = 0.2
KERNELS = (3, 7, 11)
DILATIONS = (1, 3, 5)
SINE_AMP, NOISE_STD = 0.1, 0.003
WIDTH, ROLLOFF, BETA = 64, 0.9475937167399596, 14.769656459379492


class Noise:
    """Draws from `generator` (None: no noise) for a dispatch of rows[0]
    rows, of which this call's batch starts at row rows[1]."""

    def __init__(self, generator: Optional[torch.Generator], rows: Optional[Tuple[int, int]]):
        self.generator, self.rows = generator, rows

    def __call__(self, fn, shape: Sequence[int], device) -> Optional[torch.Tensor]:
        if self.generator is None:
            return None
        total, start = self.rows or (shape[0], 0)
        return fn((total, *shape[1:]), generator=self.generator, device=device
                  )[start: start + shape[0]]


def sinc_taps(factor: int, device, width: int = WIDTH, rolloff: float = ROLLOFF,
              beta: float = BETA) -> torch.Tensor:
    """The decimation's lowpass (2 width factor + 1 taps), Kaiser-windowed
    sinc at rolloff / 2 of the lower rate, summing to 1, float32."""
    half = width * factor
    t = torch.arange(-half, half + 1, dtype=torch.float64)
    cutoff = rolloff * 0.5 / factor
    taps = 2 * cutoff * torch.sinc(2 * cutoff * t) * torch.kaiser_window(
        2 * half + 1, periodic=False, beta=beta, dtype=torch.float64)
    return (taps / taps.sum()).float().to(device)


def decimate(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, C, T) -> (B, C, ceil(T / factor)) through `sinc_taps`."""
    C = x.shape[1]
    taps = sinc_taps(factor, x.device)[None, None].expand(C, 1, -1)
    return F.conv1d(nets.rnd(x, "dec"), nets.rnd(taps, "dec"), stride=factor,
                    padding=WIDTH * factor, groups=C)


def sine_template(f0_up: torch.Tensor, sr: int, noise: Noise) -> torch.Tensor:
    """Audio-rate f0 (B, N) -> the one-harmonic sine template (B, N)."""
    B, N = f0_up.shape
    rad = (f0_up / sr) % 1
    ini = noise(torch.rand, (B, 1), f0_up.device)
    if ini is not None:
        ini[:, 0] = 0.0                      # the fundamental's phase starts at 0
        rad = torch.cat([rad[:, :1] + ini, rad[:, 1:]], dim=1)
    tmp = torch.cumsum(rad, dim=1) % 1
    shift = torch.zeros_like(rad)
    shift[:, 1:] = ((tmp[:, 1:] - tmp[:, :-1]) < 0).float() * -1.0
    sines = torch.sin(torch.cumsum(rad + shift, dim=1) * 2 * math.pi) * SINE_AMP
    uv = (f0_up > 0).float()
    out = sines * uv
    draw = noise(torch.randn, (B, N, 1), f0_up.device)
    if draw is not None:
        out = out + (uv * NOISE_STD + (1 - uv) * SINE_AMP / 3) * draw[:, :, 0]
    return out


class AdaIN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((c,), 1e-4))

    def forward(self, x: torch.Tensor, noise: Noise) -> torch.Tensor:
        B, C, T = x.shape
        n = noise(torch.randn, (B, T, C), x.device)
        if n is not None:
            x = x + n.transpose(1, 2) * self.weight[None, :, None]
        return nets.leaky(x, SLOPE)


class ResBlock(nn.Module):
    def __init__(self, c: int, k: int, dils: Sequence[int] = DILATIONS):
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(c, c, k, dilation=d, padding=(k * d - d) // 2)
                                    for d in dils)
        self.convs2 = nn.ModuleList(nn.Conv1d(c, c, k, padding=(k - 1) // 2) for _ in dils)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = conv1d_dec(nets.leaky(x, SLOPE), c1)
            x = conv1d_dec(nets.leaky(xt, SLOPE), c2) + x
        return x


def conv1d_dec(x, conv):
    return nets.conv1d(x, conv, "dec")


class ParallelResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kernels: Sequence[int] = KERNELS):
        super().__init__()
        self.input_conv = nn.Conv1d(cin, cout, 7, padding=3)
        self.blocks = nn.ModuleList(nn.ModuleList([AdaIN(cout), ResBlock(cout, k), AdaIN(cout)])
                                    for k in kernels)

    def forward(self, x: torch.Tensor, noise: Noise) -> torch.Tensor:
        x = conv1d_dec(x, self.input_conv)
        outs = [a2(res(a1(x, noise)), noise) for a1, res, a2 in self.blocks]
        return torch.stack(outs, dim=0).mean(dim=0)


class _Merge(nn.Module):
    def __init__(self):
        super().__init__()
        self.merge = nn.Sequential(nn.Linear(1, 1, bias=False))


class RefineGAN(nn.Module):
    """The decoder: latent (B, C, T), f0 (B, T), speaker (B, gin, 1) ->
    waveform (B, T * upp)."""

    def __init__(self, sr: int, rates: Sequence[int], num_mels: int, c0: int = 512,
                 gin: int = 256):
        super().__init__()
        self.sr, self.rates = sr, tuple(rates)
        self.upp = math.prod(rates)
        self.m_source = _Merge()
        start = max(c0 // 2 ** (len(rates) + 1), 2)
        self.pre_conv = nn.Conv1d(1, start, 7, padding=3)
        self.downsample_blocks = nn.ModuleList(
            nn.Conv1d(start * 2 ** i, start * 2 ** (i + 1), 7, padding=3)
            for i in range(len(rates)))
        self.mel_conv = nn.Conv1d(num_mels, c0 // 2, 7, padding=3)
        self.cond = nn.Conv1d(gin, c0 // 2, 1)
        self.upsample_conv_blocks = nn.ModuleList(
            ParallelResBlock(c0 // 2 ** i + c0 // 2 ** i // 4, c0 // 2 ** (i + 1))
            for i in range(len(rates)))
        self.conv_post = nn.Conv1d(c0 // 2 ** len(rates), 1, 7, padding=3, bias=False)

    def source(self, f0: torch.Tensor, frames: int, noise: Noise):
        """(the decimated template (B, C, T), the skip taps, audio rate first)."""
        f0_up = F.interpolate(f0[:, None].float(), size=frames * self.upp, mode="linear",
                              align_corners=False)[:, 0]
        har = sine_template(f0_up, self.sr, noise)
        x = torch.tanh(nets.linear(har[:, :, None], self.m_source.merge[0], "dec"))
        x = conv1d_dec(x.transpose(1, 2), self.pre_conv)
        downs = []
        for i, block in enumerate(self.downsample_blocks):
            x = nets.leaky(x, SLOPE)
            downs.append(x)
            x = conv1d_dec(decimate(x, self.rates[-i - 1]), block)
        return x, downs

    def forward(self, z: torch.Tensor, f0: torch.Tensor, g: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        noise = Noise(generator, rows)
        x, downs = self.source(f0, z.shape[2], noise)
        m = conv1d_dec(z, self.mel_conv)
        if g is not None:
            m = m + conv1d_dec(g, self.cond)
        x = torch.cat([m, x], dim=1)
        for rate, block, d in zip(self.rates, self.upsample_conv_blocks, reversed(downs)):
            x = stage(x, d, rate, block, noise)
        return torch.tanh(conv1d_dec(nets.leaky(x, SLOPE), self.conv_post))[:, 0]


def stage(x: torch.Tensor, skip: torch.Tensor, rate: int, block: ParallelResBlock,
          noise: Noise) -> torch.Tensor:
    """One upsampling stage: (B, C, T) -> (B, C / 2, T * rate)."""
    x = F.interpolate(nets.leaky(x, SLOPE), size=x.shape[2] * rate, mode="linear",
                      align_corners=False)
    n = min(x.shape[2], skip.shape[2])
    return block(torch.cat([x[:, :, :n], skip[:, :, :n]], dim=1), noise)


class Synthesizer(nn.Module):
    """enc_p, the flow and emb_g of `nets`, with the RefineGAN decoder."""

    def __init__(self, model: dict, sr: int):
        super().__init__()
        m = model
        C = m["inter_channels"]
        self.enc_p = nets.TextEncoder(C, m["hidden_channels"], m["filter_channels"],
                                      m["n_heads"], m["n_layers"], m["kernel_size"],
                                      m["text_enc_hidden_dim"])
        self.flow = nets.Flow(C, m["hidden_channels"], gin=m["gin_channels"])
        self.dec = RefineGAN(sr, m["upsample_rates"], C, m["upsample_initial_channel"],
                             m["gin_channels"])
        self.emb_g = nn.Embedding(m["spk_embed_dim"], m["gin_channels"])

    def infer(self, phone, lengths, pitch, f0, sid, generator=None, rows=None):
        """phone (B, T, 768), lengths (B,), coarse pitch and f0 (B, T), sid
        (B,) -> wave (B, T * upp); the decoder's noise from `generator`."""
        g = self.emb_g(sid)[:, :, None]
        m_p, _, mask = self.enc_p(phone, pitch, lengths)
        z = self.flow(m_p * mask, mask, g, reverse=True)
        return self.dec(z * mask, f0, g, generator, rows)


def build(config: dict) -> Synthesizer:
    return Synthesizer(config["model"], config["data"]["sample_rate"])


# ---------------------------------------------------------------- conversion
def generator(device) -> torch.Generator:
    """The decoder's noise of one dispatch: a generator seeded NOISE_SEED."""
    g = torch.Generator(device=device)
    g.manual_seed(NOISE_SEED)
    return g


def convert_padded(m, audio: torch.Tensor, sid: int,
                   rows: Tuple[int, int] = (1, 0)) -> torch.Tensor:
    """A window (B, T) at 16 kHz -> (B, 2 * frames * upp), as
    `offline.convert_padded` over all frames (which hands the NSF decoder
    its source noise), the decoder drawing the noise of row rows[1] of a
    dispatch of rows[0] windows."""
    B, T = audio.shape
    f0 = f0_program(m.rmvpe, audio)
    feats = m.hubert(audio)
    frames = T // WIN
    hub_pad = (frames + 1) // 2 - feats.shape[1]
    if hub_pad > 0:
        feats = torch.cat([feats, feats[:, -1:].expand(B, hub_pad, feats.shape[2])], dim=1)
    t_feat = feats.shape[1] * 2
    f0 = f0[:, :t_feat] if frames >= t_feat else F.pad(f0, (0, t_feat - frames))
    phone = feats.repeat_interleave(2, dim=1)
    lengths = torch.full((B,), t_feat, dtype=torch.int64, device=audio.device)
    sids = torch.full((B,), sid, dtype=torch.int64, device=audio.device)
    return m.synth.infer(phone, lengths, dsp.coarse_f0(f0), f0, sids, generator(audio.device),
                         rows)


def convert_long(m, utterances: Sequence[np.ndarray], which: Sequence[int],
                 sids: Sequence[int], chunk_s: float = 10.0, pad_s: float = 1.0,
                 batch: int = 8) -> Dict[int, np.ndarray]:
    """`offline.convert_long` through this decoder: each window's noise is
    its row of its group's dispatch."""
    device = next(m.synth.parameters()).device
    chunk, pad = int(chunk_s * SR), int(pad_s * SR)
    lengths = [len(u) for u in utterances]
    tgt = m.sr / SR
    pad_t, chunk_t = int(pad * tgt), int(chunk * tgt)
    want = set(which)
    pieces: Dict[Tuple[int, int], np.ndarray] = {}
    for pos, (u, c) in enumerate(long_jobs(lengths, chunk)):
        if u not in want:
            continue
        up = np.pad(np.asarray(utterances[u], np.float32), (pad, pad), mode="reflect")
        seg = up[c * chunk: c * chunk + chunk + 2 * pad]
        seg = np.pad(seg, (0, chunk + 2 * pad - len(seg)))
        x = torch.from_numpy(seg)[None].to(device)
        wave = convert_padded(m, x, sids[u], (batch, pos % batch))
        pieces[(u, c)] = wave[0, pad_t: pad_t + chunk_t].cpu().numpy()
    return {u: np.concatenate([pieces[(u, c)] for c in range(max(1, -(-lengths[u] // chunk)))]
                              )[: int(lengths[u] * tgt)] for u in which}

