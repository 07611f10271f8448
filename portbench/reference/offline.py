"""The plain reference of offline conversion: RVC's pipeline (high-pass,
chunking at quiet points, per chunk the f0 program, HuBERT, the
synthesizer, the trim, then peak normalisation), and batched long-form
conversion by windows. No retrieval: no cell retrieves yet.

It follows the RVC reference's published semantics (`rvc/infer/pipeline.py`) at the pipeline's fixed settings
(x_pad 1 s, x_query 6 s, x_center 38 s, x_max 41 s; chunks padded to whole
buckets of 96 frames). Everything runs in float32 unless the `nets.policy`
of the control says otherwise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from portbench.reference import dsp

SR = 16000
WIN = 160
NOISE_SEED = 0x5EED      # the NSF source noise: one generator seeded so per dispatch
X_PAD, X_QUERY, X_CENTER, X_MAX = 1, 6, 38, 41
BUCKET = 96


def f0_program(rmvpe, audio: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz -> f0 (B, T // 160): log-mel, RMVPE on frames reflect-
    padded to a multiple of 32, the decode at threshold 0.03, the 50-1100 Hz
    gate."""
    mel = dsp.rmvpe_log_mel(audio)
    n = mel.shape[1]
    pad = 32 * ((n - 1) // 32 + 1) - n
    if pad:
        mel = F.pad(mel.transpose(1, 2), (0, pad), mode="reflect").transpose(1, 2)
    f0 = dsp.decode_salience(rmvpe(mel)[:, :n], 0.03)[:, :audio.shape[1] // WIN]
    return torch.where((f0 >= dsp.F0_MIN) & (f0 <= dsp.F0_MAX), f0, torch.zeros_like(f0))


# ---------------------------------------------------------------- conversion
class Models:
    """The reference networks of one voice: HuBERT, RMVPE, the synthesizer,
    at the synthesizer's output rate `sr`."""

    def __init__(self, hubert, rmvpe, synth, sr: int):
        self.hubert, self.rmvpe, self.synth, self.sr = hubert, rmvpe, synth, sr
        self.upp = synth.dec.upp


def noise_rows(rows: int, samples: int, device) -> torch.Tensor:
    """The NSF source noise of one dispatch: (rows, samples) standard normal
    from a generator seeded NOISE_SEED on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(NOISE_SEED)
    return torch.randn((rows, samples, 1), generator=g, device=device)[:, :, 0]


def convert_padded(m: Models, audio: torch.Tensor, p_len: Optional[int], sid: int,
                   noise_row: Tuple[int, int] = (1, 0)) -> torch.Tensor:
    """The conversion of padded 16 kHz audio (B, T): f0, HuBERT features,
    each edge-padded to cover the frames, f0 zero past each row's p_len frames, the features
    doubled in time (protect 0.5 leaves them so), the synthesizer over
    p_len frames (None: all of them) -> (B, 2 * frames * upp) at the output
    rate. The source noise is row noise_row[1] of a dispatch of
    noise_row[0] rows."""
    B, T = audio.shape
    f0 = f0_program(m.rmvpe, audio)
    feats = m.hubert(audio)
    frames = T // WIN
    hub_pad = (frames + 1) // 2 - feats.shape[1]
    if hub_pad > 0:
        feats = torch.cat([feats, feats[:, -1:].expand(B, hub_pad, feats.shape[2])], dim=1)
    t_feat = feats.shape[1] * 2
    f0 = f0[:, :t_feat] if frames >= t_feat else F.pad(f0, (0, t_feat - frames))
    if p_len is None:
        p_len = t_feat
    f0 = torch.where(torch.arange(t_feat, device=f0.device)[None] < p_len, f0,
                     torch.zeros_like(f0))
    phone = feats.repeat_interleave(2, dim=1)
    rows, row = noise_row
    noise = noise_rows(rows, t_feat * m.upp, audio.device)[row: row + B]
    lengths = torch.full((B,), p_len, dtype=torch.int64, device=audio.device)
    sids = torch.full((B,), sid, dtype=torch.int64, device=audio.device)
    return m.synth.infer(phone, lengths, dsp.coarse_f0(f0), f0, sids, noise)


def chunk_bounds(audio: np.ndarray) -> List[Tuple[int, int]]:
    """The chunks of a recording: past x_max seconds it is cut every
    ~x_center seconds at the quietest 10 ms (|moving average|) within
    x_query seconds, on the 10 ms grid."""
    if len(audio) <= SR * X_MAX:
        return [(0, len(audio))]
    smooth = np.convolve(np.abs(audio), np.ones(WIN) / WIN, mode="same")
    bounds, prev = [], 0
    for center in range(SR * X_CENTER, len(audio), SR * X_CENTER):
        lo, hi = max(center - SR * X_QUERY, 0), min(center + SR * X_QUERY, len(audio))
        t = (lo + int(np.argmin(smooth[lo:hi]))) // WIN * WIN
        bounds.append((prev, t))
        prev = t
    bounds.append((prev, len(audio)))
    return bounds


def convert_song(m: Models, audio: np.ndarray, sid: int) -> np.ndarray:
    """A whole recording (16 kHz) -> the converted waveform at the model's
    rate, as RVC's pipeline: high-pass, a 1 s reflect pad, chunks with 1 s of
    context each side, each padded to whole buckets (reflect where the pad
    is shorter than the chunk), converted, trimmed of its context; joined,
    peak-normalised to 0.99."""
    device = next(m.synth.parameters()).device
    audio = dsp.highpass(np.asarray(audio, np.float32))
    t_pad = SR * X_PAD
    padded = np.pad(audio, (t_pad, t_pad), mode="reflect")
    spf = m.sr // 100
    trim = t_pad // WIN
    out = []
    for s, e in chunk_bounds(audio):
        chunk = padded[s: e + 2 * t_pad]
        n = len(chunk)
        b = BUCKET * WIN
        n_pad = -(-n // b) * b
        x = np.pad(chunk, (0, n_pad - n), mode="reflect" if n_pad - n < n else "constant")
        x = torch.from_numpy(x.astype(np.float32))[None].to(device)
        p_len = n // WIN
        wave = convert_padded(m, x, p_len, sid)
        wave = wave[:, trim * spf: wave.shape[1] - trim * spf]
        out.append(wave[0, : max(p_len - 2 * trim, 0) * spf].cpu().numpy())
    return dsp.peak_normalize(np.concatenate(out), 0.99)


def long_jobs(lengths: Sequence[int], chunk: int) -> List[Tuple[int, int]]:
    """(utterance, window) of every window of a long-form batch, in order."""
    return [(u, c) for u, n in enumerate(lengths) for c in range(max(1, -(-n // chunk)))]


def convert_long(m: Models, utterances: Sequence[np.ndarray], which: Sequence[int],
                 sids: Sequence[int], chunk_s: float = 10.0, pad_s: float = 1.0,
                 batch: int = 8) -> Dict[int, np.ndarray]:
    """Long-form conversion of a job, for the utterances in `which`: each
    utterance reflect-padded by pad_s, cut into windows of chunk_s + 2 pad_s
    (the last zero-filled), the windows of the job converted in groups of
    `batch` (the source noise one draw for the group, a row each), each
    window's middle chunk_s kept, joined and cut to the utterance's length
    at the model's rate."""
    device = next(m.synth.parameters()).device
    chunk, pad = int(chunk_s * SR), int(pad_s * SR)
    lengths = [len(u) for u in utterances]
    jobs = long_jobs(lengths, chunk)
    tgt = m.sr / SR
    pad_t, chunk_t = int(pad * tgt), int(chunk * tgt)
    want = set(which)
    pieces: Dict[Tuple[int, int], np.ndarray] = {}
    for pos, (u, c) in enumerate(jobs):
        if u not in want:
            continue
        up = np.pad(np.asarray(utterances[u], np.float32), (pad, pad), mode="reflect")
        seg = up[c * chunk: c * chunk + chunk + 2 * pad]
        seg = np.pad(seg, (0, chunk + 2 * pad - len(seg)))
        x = torch.from_numpy(seg)[None].to(device)
        wave = convert_padded(m, x, None, sids[u], (batch, pos % batch))
        pieces[(u, c)] = wave[0, pad_t: pad_t + chunk_t].cpu().numpy()
    return {u: np.concatenate([pieces[(u, c)] for c in range(max(1, -(-lengths[u] // chunk)))]
                              )[: int(lengths[u] * tgt)] for u in which}


