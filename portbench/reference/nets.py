"""The plain reference of the RVC v2 networks, in float32 PyTorch.

Written for the benchmark from the published architectures (RVC v2 / VITS:
HuBERT-base as the content encoder, RMVPE as the pitch estimator, the VITS
prior encoder with windowed relative attention, a four-step residual
coupling flow, the NSF HiFi-GAN decoder; for training the posterior encoder
and the v2 multi-period discriminator). Parameter names and shapes are the
upstream checkpoints', so one state dict loads into this reference and into
the program under test alike. Activations are torch's channels-first
(B, C, T) and (B, C, H, W); nothing here imports the program.

Every matrix product and convolution takes its operands through `rnd(t,
part)`, which is the identity under the default policy (float32). The
benchmark's lower-precision control sets `POLICY` for a part to "bf16" or
"fp8" (per-tensor scaled e4m3), which rounds both operands there and keeps
the sums in float32.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

# parts: f0 (RMVPE), content (HuBERT), prior (enc_p, flow, emb_g), dec
# (the NSF decoder), post (enc_q), disc (the discriminators)
POLICY: Dict[str, str] = {}


@contextmanager
def policy(**parts: str) -> Iterator[None]:
    """Run the block with these parts in lower precision ("bf16" / "fp8")."""
    old = dict(POLICY)
    POLICY.update(parts)
    try:
        yield
    finally:
        POLICY.clear()
        POLICY.update(old)


def rnd(t: torch.Tensor, part: str) -> torch.Tensor:
    mode = POLICY.get(part, "f32")
    if mode == "f32" or t is None:
        return t
    if mode == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    if mode == "fp8":
        scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    raise ValueError(f"unknown precision {mode!r}")


def conv1d(x, conv: nn.Conv1d, part: str, **kw):
    return F.conv1d(rnd(x, part), rnd(conv.weight, part), conv.bias, stride=conv.stride,
                    padding=conv.padding, dilation=conv.dilation, groups=conv.groups, **kw)


def linear(x, lin: nn.Linear, part: str):
    return F.linear(rnd(x, part), rnd(lin.weight, part), lin.bias)


def leaky(x, slope: float = 0.1):
    return F.leaky_relu(x, slope)


# ---------------------------------------------------------------- HuBERT
class _HConv(nn.Module):
    def __init__(self, cin, cout, k, s, norm):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=s, bias=False)
        if norm:
            self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5)


class _HAttn(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))


class _HFF(nn.Module):
    def __init__(self, d, f):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, f)
        self.output_dense = nn.Linear(f, d)


class _HLayer(nn.Module):
    def __init__(self, d, f):
        super().__init__()
        self.attention = _HAttn(d)
        self.layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.feed_forward = _HFF(d, f)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)


class _HFeat(nn.Module):
    KERNELS = (10, 3, 3, 3, 3, 2, 2)
    STRIDES = (5, 2, 2, 2, 2, 2, 2)

    def __init__(self, c):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            _HConv(1 if i == 0 else c, c, k, s, i == 0)
            for i, (k, s) in enumerate(zip(self.KERNELS, self.STRIDES)))


class _HProj(nn.Module):
    def __init__(self, c, d):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c, eps=1e-5)
        self.projection = nn.Linear(c, d)


class _HPos(nn.Module):
    def __init__(self, d, k, groups):
        super().__init__()
        self.conv = nn.Conv1d(d, d, k, padding=k // 2, groups=groups)


class _HEnc(nn.Module):
    def __init__(self, d, f, n_layers, k, groups):
        super().__init__()
        self.pos_conv_embed = _HPos(d, k, groups)
        self.layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.layers = nn.ModuleList(_HLayer(d, f) for _ in range(n_layers))


class Hubert(nn.Module):
    """HuBERT-base, post-LN (HF `do_stable_layer_norm=False`): 16 kHz audio
    (B, T) -> the last hidden states (B, frames, 768)."""

    def __init__(self, d: int = 768, f: int = 3072, n_layers: int = 12, heads: int = 12,
                 conv_dim: int = 512):
        super().__init__()
        self.heads = heads
        self.feature_extractor = _HFeat(conv_dim)
        self.feature_projection = _HProj(conv_dim, d)
        self.encoder = _HEnc(d, f, n_layers, 128, 16)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        P = "content"
        h = audio[:, None, :]
        for i, layer in enumerate(self.feature_extractor.conv_layers):
            h = conv1d(h, layer.conv, P)
            if i == 0:
                h = layer.layer_norm(h)
            h = F.gelu(h)
        h = h.transpose(1, 2)                                     # (B, L, 512)
        fp = self.feature_projection
        h = linear(fp.layer_norm(h), fp.projection, P)
        enc = self.encoder
        pos = conv1d(h.transpose(1, 2), enc.pos_conv_embed.conv, P)[:, :, :-1]
        h = enc.layer_norm(h + F.gelu(pos).transpose(1, 2))
        B, T, C = h.shape
        H = self.heads
        for layer in enc.layers:
            a = layer.attention

            def split(t):
                return t.reshape(B, T, H, C // H).transpose(1, 2)

            q = split(linear(h, a.q_proj, P)) * (C // H) ** -0.5
            k, v = split(linear(h, a.k_proj, P)), split(linear(h, a.v_proj, P))
            p = torch.softmax(rnd(q, P) @ rnd(k, P).transpose(-1, -2), dim=-1)
            o = (rnd(p, P) @ rnd(v, P)).transpose(1, 2).reshape(B, T, C)
            h = layer.layer_norm(h + linear(o, a.out_proj, P))
            ff = layer.feed_forward
            y = linear(F.gelu(linear(h, ff.intermediate_dense, P)), ff.output_dense, P)
            h = layer.final_layer_norm(h + y)
        return h


# ---------------------------------------------------------------- RMVPE
class _BN(nn.BatchNorm2d):
    """Inference batch norm over channels (running statistics)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class _ConvBlockRes(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False), _BN(cout),
                                  nn.ReLU(), nn.Conv2d(cout, cout, 3, padding=1, bias=False),
                                  _BN(cout), nn.ReLU())
        if cin != cout:
            self.shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        c = self.conv
        y = F.relu(c[1](_conv2d(x, c[0])))
        y = F.relu(c[4](_conv2d(y, c[3])))
        return y + (_conv2d(x, self.shortcut) if hasattr(self, "shortcut") else x)


def _conv2d(x, conv: nn.Conv2d):
    return F.conv2d(rnd(x, "f0"), rnd(conv.weight, "f0"), conv.bias, stride=conv.stride,
                    padding=conv.padding)


class _ResEnc(nn.Module):
    def __init__(self, cin, cout, n_blocks, pool=True):
        super().__init__()
        self.pool = pool
        self.conv = nn.ModuleList(_ConvBlockRes(cin if i == 0 else cout, cout)
                                  for i in range(n_blocks))

    def forward(self, x):
        for b in self.conv:
            x = b(x)
        return (x, F.avg_pool2d(x, 2)) if self.pool else x


class _ResDec(nn.Module):
    def __init__(self, cin, cout, n_blocks):
        super().__init__()
        self.conv1 = nn.Sequential(nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                                                      output_padding=1, bias=False),
                                   _BN(cout), nn.ReLU())
        self.conv2 = nn.ModuleList(_ConvBlockRes(cout * 2 if i == 0 else cout, cout)
                                   for i in range(n_blocks))

    def forward(self, x, skip):
        t = self.conv1[0]
        x = F.conv_transpose2d(rnd(x, "f0"), rnd(t.weight, "f0"), None, stride=2, padding=1,
                               output_padding=1)
        x = F.relu(self.conv1[1](x))
        th, tw = skip.shape[2], skip.shape[3]
        x = F.pad(x, (0, max(0, tw - x.shape[3]), 0, max(0, th - x.shape[2])))
        x = torch.cat([x[:, :, :th, :tw], skip], dim=1)
        for b in self.conv2:
            x = b(x)
        return x


class _UEnc(nn.Module):
    def __init__(self, cin, n_layers, cout, n_blocks):
        super().__init__()
        self.bn = _BN(cin)
        self.layers = nn.ModuleList()
        for _ in range(n_layers):
            self.layers.append(_ResEnc(cin, cout, n_blocks))
            cin, cout = cout, cout * 2
        self.out_channels = cin


class _UInter(nn.Module):
    def __init__(self, cin, cout, n, n_blocks):
        super().__init__()
        self.layers = nn.ModuleList(_ResEnc(cin if i == 0 else cout, cout, n_blocks, pool=False)
                                    for i in range(n))


class _UDec(nn.Module):
    def __init__(self, cin, n_layers, n_blocks):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(n_layers):
            self.layers.append(_ResDec(cin, cin // 2, n_blocks))
            cin //= 2


class _Unet(nn.Module):
    def __init__(self, n_blocks=4, layers=5, inter=4, cin=1, cout=16):
        super().__init__()
        self.encoder = _UEnc(cin, layers, cout, n_blocks)
        c = self.encoder.out_channels
        self.intermediate = _UInter(c, 2 * c, inter, n_blocks)
        self.decoder = _UDec(2 * c, layers, n_blocks)

    def forward(self, x):
        x = self.encoder.bn(x)
        skips = []
        for layer in self.encoder.layers:
            skip, x = layer(x)
            skips.append(skip)
        for layer in self.intermediate.layers:
            x = layer(x)
        for i, layer in enumerate(self.decoder.layers):
            x = layer(x, skips[-1 - i])
        return x


class _BiGRU(nn.Module):
    def __init__(self, n_in, hidden):
        super().__init__()
        self.gru = nn.GRU(n_in, hidden, batch_first=True, bidirectional=True)


class RMVPE(nn.Module):
    """E2E: log-mel (B, T, 128), T a multiple of 32 -> salience (B, T, 360)."""

    def __init__(self):
        super().__init__()
        self.unet = _Unet()
        self.cnn = nn.Conv2d(16, 3, 3, padding=1)
        self.fc = nn.Sequential(_BiGRU(384, 256), nn.Linear(512, 360))

    def trunk(self, mel: torch.Tensor) -> torch.Tensor:
        """The U-Net and the 3-channel conv: (B, T, 128) -> (B, T, 384)."""
        x = _conv2d(self.unet(mel[:, None]), self.cnn)                  # (B, 3, T, M)
        B, C, T, M = x.shape
        return x.permute(0, 2, 1, 3).reshape(B, T, C * M)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.trunk(mel)
        gru = self.fc[0].gru
        if POLICY.get("f0", "f32") == "f32":
            h = gru(x)[0]
        else:       # the GRU's matrices rounded too
            with torch.no_grad():
                saved = {n: p.detach().clone() for n, p in gru.named_parameters()}
                for n, p in gru.named_parameters():
                    p.copy_(rnd(p, "f0"))
            try:
                h = gru(rnd(x, "f0"))[0]
            finally:
                with torch.no_grad():
                    for n, p in gru.named_parameters():
                        p.copy_(saved[n])
        return torch.sigmoid(linear(h, self.fc[1], "f0"))


# ---------------------------------------------------------------- prior encoder
class _LN(nn.Module):
    """VITS channel layer norm, parameters gamma / beta, on (B, C, T)."""

    def __init__(self, c):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x.transpose(1, 2), x.shape[1:2], self.gamma, self.beta,
                            1e-5).transpose(1, 2)


class _MHA(nn.Module):
    def __init__(self, c, heads, window=10):
        super().__init__()
        self.heads, self.window = heads, window
        d = c // heads
        self.conv_q, self.conv_k, self.conv_v, self.conv_o = (nn.Conv1d(c, c, 1)
                                                              for _ in range(4))
        self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window + 1, d) * d ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window + 1, d) * d ** -0.5)


def _rel_emb(emb, length, window):
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start: start + 2 * length - 1]


def _rel_to_abs(x):
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, t * 2 * t)
    return F.pad(x, (0, t - 1)).reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1:]


def _abs_to_rel(x):
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1)).reshape(b, h, t * t + t * (t - 1))
    return F.pad(x, (t, 0)).reshape(b, h, t, 2 * t)[:, :, :, 1:]


def rel_attention(q, k, v, emb_k, emb_v, window, mask, part):
    """VITS windowed relative attention (B, H, T, D), mask (B, 1, T, T)."""
    t = k.shape[2]
    q = q / math.sqrt(q.shape[-1])
    scores = rnd(q, part) @ rnd(k, part).transpose(-1, -2)
    scores = scores + _rel_to_abs(rnd(q, part) @ rnd(_rel_emb(emb_k, t, window), part)
                                  .transpose(-1, -2))
    p = torch.softmax(scores.masked_fill(mask == 0, -1e4), dim=-1)
    out = rnd(p, part) @ rnd(v, part)
    return out + rnd(_abs_to_rel(p), part) @ rnd(_rel_emb(emb_v, t, window), part)


class _FFN(nn.Module):
    def __init__(self, c, f, k):
        super().__init__()
        self.conv_1 = nn.Conv1d(c, f, k, padding=(k - 1) // 2)
        self.conv_2 = nn.Conv1d(f, c, k, padding=(k - 1) // 2)


class _AttnEnc(nn.Module):
    def __init__(self, c, f, heads, n_layers, k):
        super().__init__()
        self.attn_layers = nn.ModuleList(_MHA(c, heads) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(_LN(c) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(_FFN(c, f, k) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(_LN(c) for _ in range(n_layers))

    def forward(self, x, mask, part="prior"):
        """x (B, C, T), mask (B, 1, T)."""
        amask = mask[:, :, None, :] * mask[:, :, :, None]       # (B, 1, T, T)
        x = x * mask
        B, C, T = x.shape
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                     self.norm_layers_2):
            H = attn.heads

            def split(t):
                return t.reshape(B, H, C // H, T).transpose(2, 3)

            q, k, v = (split(conv1d(x, c, part)) for c in (attn.conv_q, attn.conv_k,
                                                            attn.conv_v))
            o = rel_attention(q, k, v, attn.emb_rel_k, attn.emb_rel_v, attn.window, amask,
                              part)
            o = conv1d(o.transpose(2, 3).reshape(B, C, T), attn.conv_o, part)
            x = n1(x + o)
            y = conv1d(F.relu(conv1d(x * mask, ffn.conv_1, part)) * mask, ffn.conv_2, part)
            x = n2(x + y * mask)
        return x * mask


class TextEncoder(nn.Module):
    def __init__(self, out, hidden, filt, heads, n_layers, k, emb_dim=768):
        super().__init__()
        self.hidden = hidden
        self.emb_phone = nn.Linear(emb_dim, hidden)
        self.emb_pitch = nn.Embedding(256, hidden)
        self.encoder = _AttnEnc(hidden, filt, heads, n_layers, k)
        self.proj = nn.Conv1d(hidden, out * 2, 1)

    def forward(self, phone, pitch, lengths):
        """phone (B, T, 768), pitch (B, T), lengths (B,) -> m, logs (B, C, T), mask (B, 1, T)."""
        x = linear(phone, self.emb_phone, "prior") + self.emb_pitch(pitch)
        x = leaky(x * math.sqrt(self.hidden), 0.1).transpose(1, 2)
        mask = (torch.arange(x.shape[2], device=x.device)[None] < lengths[:, None])
        mask = mask[:, None].to(x.dtype)
        x = self.encoder(x, mask)
        m, logs = torch.chunk(conv1d(x, self.proj, "prior") * mask, 2, dim=1)
        return m, logs, mask


# ---------------------------------------------------------------- flow and WaveNet
class WaveNet(nn.Module):
    def __init__(self, hidden, k, rate, n_layers, gin):
        super().__init__()
        self.hidden, self.n_layers = hidden, n_layers
        self.cond_layer = nn.Conv1d(gin, 2 * hidden * n_layers, 1)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = rate ** i
            self.in_layers.append(nn.Conv1d(hidden, 2 * hidden, k, dilation=d,
                                            padding=(k * d - d) // 2))
            self.res_skip_layers.append(nn.Conv1d(hidden, 2 * hidden if i < n_layers - 1
                                                  else hidden, 1))

    def forward(self, x, mask, g, part):
        H = self.hidden
        out = torch.zeros_like(x)
        g = conv1d(g, self.cond_layer, part)
        for i in range(self.n_layers):
            a = conv1d(x, self.in_layers[i], part) + g[:, i * 2 * H:(i + 1) * 2 * H]
            acts = torch.tanh(a[:, :H]) * torch.sigmoid(a[:, H:])
            rs = conv1d(acts, self.res_skip_layers[i], part)
            if i < self.n_layers - 1:
                x = (x + rs[:, :H]) * mask
                out = out + rs[:, H:]
            else:
                out = out + rs
        return out * mask


class _Coupling(nn.Module):
    def __init__(self, c, hidden, k, rate, n_layers, gin):
        super().__init__()
        self.half = c // 2
        self.pre = nn.Conv1d(self.half, hidden, 1)
        self.enc = WaveNet(hidden, k, rate, n_layers, gin)
        self.post = nn.Conv1d(hidden, self.half, 1)

    def forward(self, x, mask, g, reverse):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.enc(conv1d(x0, self.pre, "prior") * mask, mask, g, "prior")
        m = conv1d(h, self.post, "prior") * mask
        x1 = (x1 - m) * mask if reverse else (m + x1) * mask
        return torch.cat([x0, x1], dim=1)


class _Flip(nn.Module):
    def forward(self, x, mask, g, reverse):
        return torch.flip(x, dims=(1,))


class Flow(nn.Module):
    def __init__(self, c, hidden, k=5, rate=1, n_layers=3, n_flows=4, gin=256):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(_Coupling(c, hidden, k, rate, n_layers, gin))
            self.flows.append(_Flip())

    def forward(self, x, mask, g, reverse=True):
        for f in (reversed(self.flows) if reverse else self.flows):
            x = f(x, mask, g, reverse)
        return x


class PosteriorEncoder(nn.Module):
    def __init__(self, cin, out, hidden, k=5, rate=1, n_layers=16, gin=256):
        super().__init__()
        self.pre = nn.Conv1d(cin, hidden, 1)
        self.enc = WaveNet(hidden, k, rate, n_layers, gin)
        self.proj = nn.Conv1d(hidden, out * 2, 1)

    def forward(self, spec, lengths, g, eps):
        """spec (B, T, F), eps (B, T, C) -> z, m, logs (B, C, T), mask (B, 1, T)."""
        x = spec.transpose(1, 2)
        mask = (torch.arange(x.shape[2], device=x.device)[None] < lengths[:, None])
        mask = mask[:, None].to(x.dtype)
        h = self.enc(conv1d(x, self.pre, "post") * mask, mask, g, "post")
        m, logs = torch.chunk(conv1d(h, self.proj, "post") * mask, 2, dim=1)
        z = (m + eps.transpose(1, 2) * torch.exp(logs)) * mask
        return z, m, logs, mask


# ---------------------------------------------------------------- NSF HiFi-GAN
def sine_source(f0, upp, sr, noise, sine_amp=0.1, noise_std=0.003):
    """Frame f0 (B, L) -> the harmonic-plus-noise source (B, 1, L * upp)
    before its linear layer: one sine whose phase runs on continuously
    across frames, voiced where f0 > 0, plus noise (B, L * upp) (standard
    normal) at 0.003 where voiced and sine_amp / 3 elsewhere."""
    B, L = f0.shape
    grid = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    inc = (f0[:, :, None] / sr) * grid                                  # (B, L, upp)
    rem = torch.fmod(inc[:, :-1, -1] + 0.5, 1.0) - 0.5
    cum = F.pad(torch.fmod(torch.cumsum(rem, dim=1), 1.0), (1, 0))
    phase = (inc + cum[:, :, None]).reshape(B, L * upp)
    voiced = (f0 > 0).float().repeat_interleave(upp, dim=1)
    src = torch.sin(2 * math.pi * phase) * sine_amp * voiced
    src = src + (voiced * noise_std + (1 - voiced) * sine_amp / 3) * noise
    return src[:, None]


class _ResBlock(nn.Module):
    def __init__(self, c, k, dils):
        super().__init__()
        self.k, self.dils = k, tuple(dils)
        self.convs1 = nn.ModuleList(nn.Conv1d(c, c, k, dilation=d, padding=(k * d - d) // 2)
                                    for d in dils)
        self.convs2 = nn.ModuleList(nn.Conv1d(c, c, k, padding=(k - 1) // 2) for _ in dils)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + conv1d(leaky(conv1d(leaky(x), c1, "dec")), c2, "dec")
        return x


class _Source(nn.Module):
    def __init__(self):
        super().__init__()
        self.l_linear = nn.Linear(1, 1)


class NSFDecoder(nn.Module):
    def __init__(self, cin, ks, dils, rates, c0, up_ks, gin, sr):
        super().__init__()
        self.sr, self.rates = sr, tuple(rates)
        self.upp = math.prod(rates)
        self.n_res = len(ks)
        self.m_source = _Source()
        self.conv_pre = nn.Conv1d(cin, c0, 7, padding=3)
        self.cond = nn.Conv1d(gin, c0, 1)
        self.ups, self.noise_convs, self.resblocks = nn.ModuleList(), nn.ModuleList(), nn.ModuleList()
        for i, (u, k) in enumerate(zip(rates, up_ks)):
            c = c0 // 2 ** (i + 1)
            pad = (k - u) // 2 if u % 2 == 0 else u // 2 + u % 2
            self.ups.append(nn.ConvTranspose1d(c0 // 2 ** i, c, k, stride=u, padding=pad,
                                               output_padding=u % 2))
            s = math.prod(rates[i + 1:]) if i + 1 < len(rates) else 1
            nk = 1 if s == 1 else 2 * s - s % 2
            self.noise_convs.append(nn.Conv1d(1, c, nk, stride=s,
                                              padding=0 if s == 1 else (nk - s) // 2))
            for kk, dd in zip(ks, dils):
                self.resblocks.append(_ResBlock(c, kk, dd))
        self.conv_post = nn.Conv1d(c0 // 2 ** len(rates), 1, 7, padding=3, bias=False)

    def forward(self, z, f0, g, noise, stage_hook=None):
        """z (B, C, T), f0 (B, T), g (B, gin, 1), noise (B, T * upp) -> (B, T * upp)."""
        lin = self.m_source.l_linear
        har = torch.tanh(sine_source(f0, self.upp, self.sr, noise) * lin.weight[0, 0]
                         + lin.bias[0])
        x = conv1d(z, self.conv_pre, "dec") + conv1d(g, self.cond, "dec")
        for i, (up, nc) in enumerate(zip(self.ups, self.noise_convs)):
            x = F.conv_transpose1d(rnd(leaky(x), "dec"), rnd(up.weight, "dec"), up.bias,
                                   stride=up.stride, padding=up.padding,
                                   output_padding=up.output_padding)
            n = conv1d(har, nc, "dec")
            m = min(x.shape[2], n.shape[2])
            x = x[:, :, :m] + n[:, :, :m]
            blocks = self.resblocks[i * self.n_res:(i + 1) * self.n_res]
            x = sum(b(x) for b in blocks) / len(blocks)
        return torch.tanh(conv1d(leaky(x, 0.01), self.conv_post, "dec"))[:, 0]


class Synthesizer(nn.Module):
    """enc_p, the flow, the NSF decoder and emb_g (and enc_q for training)."""

    def __init__(self, model: dict, sr: int, training: bool = False, spec_channels: int = 1025):
        super().__init__()
        m = model
        C = m["inter_channels"]
        self.enc_p = TextEncoder(C, m["hidden_channels"], m["filter_channels"], m["n_heads"],
                                 m["n_layers"], m["kernel_size"], m["text_enc_hidden_dim"])
        if training:
            self.enc_q = PosteriorEncoder(spec_channels, C, m["hidden_channels"],
                                          gin=m["gin_channels"])
        self.flow = Flow(C, m["hidden_channels"], gin=m["gin_channels"])
        self.dec = NSFDecoder(C, m["resblock_kernel_sizes"], m["resblock_dilation_sizes"],
                              m["upsample_rates"], m["upsample_initial_channel"],
                              m["upsample_kernel_sizes"], m["gin_channels"], sr)
        self.emb_g = nn.Embedding(m["spk_embed_dim"], m["gin_channels"])

    def infer(self, phone, lengths, pitch, f0, sid, noise):
        """phone (B, T, 768), lengths (B,), coarse pitch and f0 (B, T), sid (B,),
        source noise (B, T * upp) -> wave (B, T * upp)."""
        g = self.emb_g(sid)[:, :, None]
        m_p, _, mask = self.enc_p(phone, pitch, lengths)
        z = self.flow(m_p * mask, mask, g, reverse=True)
        return self.dec(z * mask, f0, g, noise)


# ---------------------------------------------------------------- discriminators
class _DiscS(nn.Module):
    SPECS = ((1, 16, 15, 1, 7, 1), (16, 64, 41, 4, 20, 4), (64, 256, 41, 4, 20, 16),
             (256, 1024, 41, 4, 20, 64), (1024, 1024, 41, 4, 20, 256),
             (1024, 1024, 5, 1, 2, 1))

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv1d(ci, co, k, stride=s, padding=p, groups=g)
                                   for ci, co, k, s, p, g in self.SPECS)
        self.conv_post = nn.Conv1d(1024, 1, 3, padding=1)

    def forward(self, x):
        """x (B, T) -> (score (B, n), feature maps)."""
        x = x[:, None]
        fmap = []
        for c in self.convs:
            x = leaky(conv1d(x, c, "disc"))
            fmap.append(x)
        x = conv1d(x, self.conv_post, "disc")
        fmap.append(x)
        return x.flatten(1), fmap


class _DiscP(nn.Module):
    def __init__(self, period, k=5, s=3):
        super().__init__()
        self.period = period
        chans = ((1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024))
        self.convs = nn.ModuleList(nn.Conv2d(ci, co, (k, 1), stride=(st, 1),
                                             padding=((k - 1) // 2, 0))
                                   for (ci, co), st in zip(chans, (s, s, s, s, 1)))
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, x):
        B, T = x.shape
        p = self.period
        if T % p:
            x = F.pad(x[:, None], (0, p - T % p), mode="reflect")[:, 0]
            T = x.shape[1]
        x = x.reshape(B, 1, T // p, p)
        fmap = []
        for c in self.convs:
            x = leaky(F.conv2d(rnd(x, "disc"), rnd(c.weight, "disc"), c.bias, stride=c.stride,
                               padding=c.padding))
            fmap.append(x)
        c = self.conv_post
        x = F.conv2d(rnd(x, "disc"), rnd(c.weight, "disc"), c.bias, padding=c.padding)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11, 17, 23, 37)):
        super().__init__()
        self.discriminators = nn.ModuleList([_DiscS()] + [_DiscP(p) for p in periods])

    def forward(self, y, y_hat):
        """y, y_hat (B, T) -> (real scores, fake scores, real maps, fake maps)."""
        out = ([], [], [], [])
        for d in self.discriminators:
            r, fr = d(y)
            g, fg = d(y_hat)
            for lst, v in zip(out, (r, g, fr, fg)):
                lst.append(v)
        return out


def build(kind: str, cfg: Optional[dict] = None, training: bool = False) -> nn.Module:
    """A reference network by name: "hubert", "rmvpe", "synthesizer" (of a
    configuration file's dict) or "discriminator"."""
    if kind == "hubert":
        return Hubert()
    if kind == "rmvpe":
        return RMVPE()
    if kind == "synthesizer":
        return Synthesizer(cfg["model"], cfg["data"]["sample_rate"], training,
                           cfg["data"]["filter_length"] // 2 + 1)
    if kind == "discriminator":
        return MultiPeriodDiscriminator()
    raise ValueError(kind)
