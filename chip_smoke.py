#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`rvc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (a `kernel` line per kernel call):
  device    the card's name and power limit (nvidia-smi)
  build     nvcc builds every kernel of `rvc_tpu_torch/csrc/` (seconds)
  pipeline  the full-width 48 kHz model (random weights from seed 0)
            converts a 13.5 s clip through `RVC.infer`; wall ms after a warm
            call, the realtime factor, and each kernel's launches in that run
  stages    device ms of each stage of one 13.5 s chunk (f0 program, HuBERT,
            enc_p, flow, decoder) and the host's preparation time
  kernel    every kernel-wrapper call of one more conversion of the clip,
            recorded with its inputs (`ops.kernels.record_calls`) and
            replayed: the kernel against its plain PyTorch version on the
            same inputs (TF32 off; K3 and K4 against the plain version run
            in float64, and where the float32 plain version misses the bar
            there, within twice its distance), max_abs / rel_l2 / tolerance, ms for
            both (CUDA events around one call, the host's launch work
            included; the median of 5 runs after warmup), `ms_queued` and
            `plain_ms_queued` for both (10 calls queued back to back, over
            10, as in a conversion), and the bound at the kernel's own
            peak. K1/K2 (bf16 operands, float32 sums, as the
            TPU kernel) are also held to the plain version's bf16 emulation
            (`bf16_operands=True`) run in float64, beside the same emulation
            run in float32 by cuDNN (`emu_rel_l2`, `cudnn_emu_rel_l2`), and
            carry `cudnn_bf16_ms`: the plain chain on
            bf16 copies of the inputs (cuDNN bf16 convs, bf16 residual), a
            yardstick, not the same function. K3 and K4 carry their launch
            `grid` (blocks, blocks an SM, waves on the card's SMs); K3 also
            `sdpa_ms`: PyTorch's scaled_dot_product_attention in float32 on
            the same q, k, v with the band logits and the length folded into
            a dense additive mask built outside the timed region, a
            yardstick without the band weights' rel-v term (and
            `sdpa_ms_queued`); every line carries `device_ms`, each CUDA
            kernel's device time per call from torch.profiler. The replay
            must launch each kernel as often as the timed run did.
  parity    a 2 s clip on the card and through the port's CPU path (the
            plain versions), same weights, source noise off: waveform corr
  retrieval the same 48 kHz model written as an upstream `.pth` (fp16
            weights, the 18-element config list) and an IVFFlat index built
            on the card from the port's HuBERT features of seeded chirps
            (60,000 x 768, nlist 1538, nprobe 1), written as a FAISS file
            and read back; `RVC(model_path=..., index_path=...)` converts the
            13.5 s clip at index_rate 0.75: index build / write / read
            seconds, wall ms after a warm call, the launches (K1-K4 > 0), the
            search and blend ms of the clip's frames (CUDA events) beside the
            search's bound, and GPU-vs-CPU waveform corr on a 2 s clip
  f0less    an f0-less 40 kHz model at full width (plain HiFi-GAN decoder,
            stages C = 256, 128, 64, 32) from its `.pth`, with the same
            index, through the staged path: wall ms, the launches (K1-K3 > 0,
            K4 = 0), every kernel call of one conversion held against its
            plain version at the bars above (not timed), GPU-vs-CPU corr
  pitch     the staged path's pitch methods on the main path's model and
            clip: crepe (full), crepe-tiny, fcpe (12 x 512), pm, dio,
            harvest, hybrid[rmvpe+crepe-tiny+harvest], rmvpe with
            proposed_pitch, and input_f0 (the clip's RMVPE contour through a
            text file); per run the wall ms after a warm call, the realtime
            factor, the output length, the launches (K1-K3 > 0; K4 > 0
            exactly where RMVPE runs), the voiced share, and the extractor
            alone on its 15.5 s chunk (CUDA events for the networks, the
            host clock for DSP and hybrids; CREPE full and FCPE beside their
            FLOP and float32 bound); every kernel call of one staged crepe
            conversion held against its plain version; crepe (0.5 s) and
            fcpe (2 s) f0 on the card against the host (voicing >= 99%,
            median |cents| < 1); the staged crepe-tiny waveform on a 2 s
            clip, GPU vs CPU corr > 0.99
  postfx    `RVC.infer` with split_audio, clean_audio, formant_shifting
            (timbre 1.2), post_process and all ten effects on the 13.5 s clip
            with two 0.8 s silences cut in: wall ms, the segments, the output
            length, each host part alone (formant shift, split, merge, noise
            reduction, the FX chain and each effect; host clock), and FLAC /
            MP3 export through `encode_audio` (written and read back where
            soundfile or ffmpeg is on the machine, else its RuntimeError)
  vocoders  the 48 kHz model with the MRF HiFi-GAN, then RefineGAN decoder
            (full width, seed 0), written as `.safetensors` + `.json` and
            loaded through `RVC(model_path=...)`: wall ms, launches (K1 = K2
            = 0, K3 = 6, K4 = 1), the decoder alone (CUDA events) and per
            part, its FLOP and float32 bound, GPU-vs-CPU corr on a 2 s clip,
            and the audio-rate sine bank's float32 drift from float64
  longform  `BatchConverter.convert_long_batch` on the main path's model:
            64 x 60 s utterances in 10 s windows with 1 s of context, 8 a
            dispatch (first call, wall, audio-seconds per second, peak
            memory, launches per dispatch: K1 27, K2 9, K3 6, K4 1); the
            first 16 at 1, 8 and 16 a dispatch; then (`longform_b8`) one
            B = 8 dispatch's stages and every kernel call held against its
            plain version (K3 / K4 with their grid), and one window at B = 8
            against B = 1, noise off
  realtime  `VoiceChanger` on the main path's model at the reference's
            session (read_chunk_size 192 = 512 ms blocks, crossfade 0.1 s,
            extra 0.5 s, rmvpe, fused; the gate at -90 dB, since the
            reference's default of 0 dB gates any block under RMS 1): 40
            blocks of the chirp after 3 warm ones, `on_request` ms
            (median, p95, max) against the 512 ms budget, launches per block
            (K1 27, K2 9, K3 6, K4 1), ms of the block program and its stages
            (CUDA events around one call) with each stage's trace (kernels,
            busy ms) and host ms of the host's parts, torch.profiler over one
            block (CUDA kernels, copies, busy ms, the top kernels), and every kernel
            call of one block held against its plain version (with grid) and
            timed beside its bound
  realtime_checks  the staged block against the fused one (corr > 0.999,
            atol 5e-3); three silent blocks (zeros, no launch); 4 blocks on
            the card against the port's CPU path, noise off (corr > 0.99);
            index_rate 0.75 on the retrieval phase's index (ms per block, beside
            a fresh engine without it on the same blocks);
            `VoiceChangerPool` at N = 1, 4, 16 (step ms, launches per step,
            real-time streams per card = N x 512 / step ms; every kernel
            call of one N = 16 step held, with grid); 10 blocks over
            `RealtimeSocketServer` on 127.0.0.1 (ms per round trip; replies
            within 1e-4 of an in-process engine)
  train     a voice model made as users make one, at the 48 kHz model's full
            width (random init from seed 0): 2 speakers x 3 seeded harmonic
            utterances of 10 s through the port's AudioPreprocessor
            (Automatic), FeatureExtractor (full-size random HuBERT and RMVPE,
            K4 on the card, same-length groups of 8) and DatasetBuilder (with
            the mute rows), then RVCTrainer at batch 8 for 2 epochs, a save
            and a resume (params, moments, epoch, step equal), the `.pth`
            export converting a 2 s clip through `RVC` on the card; K4's
            launches over the extraction
  train_step  one batch of that loader: 20 steps after 3 warm ones (median,
            p95, steps/s, segment audio-s/s, peak memory), one step split by
            CUDA events (G forward, G backward, G optimizer, D forward +
            backward, D optimizer), torch.profiler over one step, launches
            per step (K1 27, K2 9, K3 6; K1/K2 twice with checkpointing)
  train_checks  30 warmup-mode steps on that batch with fixed segment starts
            (the mel loss falls: the mean of the last 5 under the first 5);
            every K1-K3 call of one step held forward at the bars above and
            through its autograd Function against the plain version's
            autograd (every input and weight gradient, rel_l2 < 1e-5); one
            full-width G+D step at batch 2 on the card against the port's
            CPU step with the same parameters, batch and draws (losses rel
            2e-2; gradient corr > 0.99 per module against the CPU step with
            K1/K2's bf16 forward emulated, and for all but the decoder
            against the float32 one)
  train_vocoder  the MRF HiFi-GAN and RefineGAN (v3 D) models: 2 steps each
            after a warm one, split, launches (K3 only), memory, a trace
  longform_mesh  (after `longform`) `BatchConverter` on a mesh naming the
            card twice (each B = 8 dispatch split 4 + 4, one host thread a
            shard) against one replica, the first 16 long-form utterances,
            noise on: wall, audio-s/s, launches (twice the one replica's a
            dispatch), each utterance at corr > 0.9999; on a mesh of every
            card too where there are two or more
  ddp_gloo  (after the train phases) two data-parallel ranks spawned on the
            card, joined by gloo (NCCL refuses two ranks on one card), the
            48 kHz model at full width, global batch 8 at bucket 400, 3
            steps, against the single-card trainer's step on the same batch
            and draws: step ms per rank, bytes all-reduced and all-gathered
            a step with ms of one each, ZeRO-1 optimizer bytes per rank
            against the single card, step-1 losses (rel 1e-4), parameters
            after the steps (rel_l2 1e-3), the ranks bit-identical, launches
            per rank (K1 27, K2 9, K3 6 a step)
  ddp_nccl  `train` through its own bootstrap on the train phase's dataset,
            one epoch: rank 0 of 1 joined by NCCL at a localhost coordinator
            (wall, steps/s, launches); one rank a card started by `train`
            itself where there are two cards or more, else "skipped"
  tp_gloo   (after ddp_gloo) two tensor-parallel ranks on mesh (1, 2)
            spawned on the card (gloo), at ddp_gloo's full width and batch
            and the default min_size, 3 steps from the single card's init and
            draws: step-1 losses and the gathered G / D after the steps
            against ddp_gloo's single-card run at its bars, each rank's param
            and optimizer bytes against the rules (`rule_bytes`) and the
            single card, launches per rank (K1 21 + K1_tp 6, K2_tp 9, K3 6 a
            step), the model axis's all-reduces and all-gathers a step (count,
            bytes), step ms; then every `resblock_chain_tp` /
            `resblock_group_tp` call of one more step, replayed on both ranks
            together: against its plain partial version (float32, at K1/K2's
            bars) and its bf16 emulation in float64, ms of the call (its gloo
            all-reduces included) and of the plain version, the kernels'
            device ms, the bound of its kernels
  tp_nccl   (after ddp_nccl) `train --mesh_model 2` through its bootstrap,
            one rank a card over NCCL, one epoch, where the machine has an
            even count of two cards or more; else "skipped" and why
  tools     model_information, convert, model_blender (the model with its
            own conversion at 0.5 is the conversion, bit for bit) and
            audio_analyzer on the train phase's `.pth` export
Then the `kernels` summary line (per kernel: the sums over its calls; the
launches of each path's run beside the main path's, `staged_crepe`,
`staged_rmvpe`, `postfx`, `mrf`, `refinegan` and `longform` among them;
`realtime` per block and `realtime_pool` per step at N = 16, `extract`
over the train phase's extraction and `train_step` per step;
`longform_mesh` over its run, `ddp_gloo_rank0` / `ddp_gloo_rank1` over
their 3 steps, `tp_gloo_rank0` / `tp_gloo_rank1` over theirs and
`ddp_nccl` over its epoch; the `_tp` variants' lines from `tp_gloo`, their
calls on rank 0 in one step),
the card line, and
last {"ok": true, "device": {...}}. Any failed check raises: the exit code
is non-zero and the last line is not printed. Without a CUDA device, or
run outside the repository, it fails before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

CLIP_S = 13.5
PARITY_S = 2.0
SEED = 0
KERNEL_CALLS = 10                         # calls queued per timed run in the kernel phase
INDEX_N = 60_000     # index vectors: ~20 min of training audio at HuBERT's 50 frames/s
INDEX_RATE = 0.75    # the reference's default
PEAK_F32 = (67e12, "float32")            # H100 SXM, outside the tensor cores
PEAK_BF16 = (989e12, "bf16 dense")        # H100 SXM tensor cores
PEAK_HBM_BYTES = 3.35e12                  # H100 SXM HBM3
# K1/K2 against the float32 plain version: the JAX test's bar for its Pallas
# kernel against XLA (tests/unit/test_pallas_resblock.py). Against the bf16
# emulation run in float64 (the same operands, exact sums): rel_l2 <= max(1e-4,
# 2 x the float32 run's), since two float32 sums round some bf16 operands apart
# and each such flip moves the next conv (tests/test_torch_cuda.py).
BF16_BAR = dict(atol=2e-2, rtol=1e-2, min_corr=0.9999, emu_rel_l2=1e-4)

# keyed by wrapper name, which is also its launch counter's
KERNELS = {
    "resblock_group": dict(
        name="K1 resblock_group", module="resblock", entry="rvc_resblock_step",
        source="rvc_tpu_torch/csrc/resblock.cu",
        replaces="rvc_tpu/ops/pallas/resblock.py:287 fused_resblock_group",
        peak=PEAK_BF16, **BF16_BAR),
    "resblock_chain": dict(
        name="K2 resblock_chain", module="resblock", entry="rvc_resblock_step",
        source="rvc_tpu_torch/csrc/resblock.cu",
        replaces="rvc_tpu/ops/pallas/resblock.py:141 fused_resblock",
        peak=PEAK_BF16, **BF16_BAR),
    "rel_attention": dict(
        name="K3 rel_attention", module="attention", entry="rvc_rel_attention",
        source="rvc_tpu_torch/csrc/rel_attention.cu",
        replaces="rvc_tpu/ops/pallas/attention.py:87 fused_rel_attention",
        peak=PEAK_F32, atol=1e-4, rtol=1e-4),
    "log_mel": dict(
        name="K4 log_mel", module="melspec", entry="rvc_log_mel",
        source="rvc_tpu_torch/csrc/melspec.cu",
        replaces="rvc_tpu/ops/pallas/melspec.py:61 pallas_log_mel",
        peak=PEAK_F32, atol=2e-3, rtol=1e-3),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, reps: int = 5, calls: int = 1) -> float:
    """Median over reps of the CUDA-event milliseconds of `calls` fn()s
    queued back to back, over calls; after warmup. With calls > 1 the
    host's launch work overlaps the device's, as in a conversion."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def test_clip(seconds: float, seed: int):
    """A voiced chirp (110 -> 330 Hz, with a 2nd harmonic) plus noise, 16 kHz."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f = 110.0 * 3.0 ** (t / seconds)
    phase = 2 * np.pi * np.cumsum(f) / 16000
    y = 0.4 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.02 * rng.standard_normal(len(t))
    return (y * (0.6 + 0.4 * np.sin(2 * np.pi * 0.5 * t) ** 2)).astype(np.float32)


def device_kernel_ms(fn, calls: int = KERNEL_CALLS) -> dict:
    """Device milliseconds per call of each CUDA kernel that fn() launches,
    from torch.profiler over `calls` queued calls ({} if it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            key = e.key.replace("(anonymous namespace)::", "")
            name = re.match(r"(?:void\s+)?(?:[\w:]*::)?(\w+)", key).group(1)
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def rel_l2(got, ref) -> float:
    import torch

    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def compare(got, ref, atol: float, rtol: float, what: str, min_corr=None) -> dict:
    import torch

    diff = (got - ref).abs()
    max_abs = float(diff.max())
    out = {"max_abs": max_abs, "rel_l2": rel_l2(got, ref),
           "tol": f"|d| <= {atol} + {rtol}|ref|"}
    ok = bool((diff <= atol + rtol * ref.abs()).all()) and math.isfinite(max_abs)
    if min_corr is not None:
        out["corr"] = float(torch.corrcoef(torch.stack([got.flatten(), ref.flatten()])
                                           .double())[0, 1])
        out["tol"] += f", corr > {min_corr}"
        ok = ok and out["corr"] > min_corr
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version ({out})")
    return out


def compare_exact(got, plain32, exact, atol: float, rtol: float, what: str) -> dict:
    """A float32 kernel against its plain version run in float64 (`exact`):
    |d| <= atol + rtol |exact| at every element. Where the float32 plain
    version misses that bar too (inputs of large magnitude, bands at a
    clamp), the kernel is held as K1/K2 are: no further from float64 than
    twice the float32 plain version, in max |d| and in rel_l2. Raises on a
    miss."""
    got, plain32 = got.double(), plain32.double()
    bar = atol + rtol * exact.abs()
    d, d_plain = (got - exact).abs(), (plain32 - exact).abs()
    out = {"max_abs": float(d.max()), "rel_l2": rel_l2(got, exact),
           "tol": f"|d| <= {atol} + {rtol}|ref| against float64; where the float32 plain "
                  "version misses it, max |d| and rel_l2 <= 2 x the plain version's",
           "excess": float((d - bar).max()),
           "plain_f32_excess": float((d_plain - bar).max()),
           "plain_f32_vs_f64_max_abs": float(d_plain.max()),
           "plain_f32_vs_f64_rel_l2": rel_l2(plain32, exact),
           "vs_plain_f32_max_abs": float((got - plain32).abs().max())}
    within = out["excess"] <= 0 or (
        out["plain_f32_excess"] > 0
        and out["max_abs"] <= 2 * out["plain_f32_vs_f64_max_abs"]
        and out["rel_l2"] <= 2 * out["plain_f32_vs_f64_rel_l2"])
    if not (math.isfinite(out["max_abs"]) and within):
        raise AssertionError(f"{what}: kernel disagrees with its plain version ({out})")
    return out


def emulation(got, plain, args, kwargs, x) -> dict:
    """K1/K2 against the plain version's bf16 emulation run in float64 (exact
    sums), on the output and on its update (output - x), which the residual
    cannot dilute, beside the same emulation run in float32 by cuDNN."""
    import torch

    f64 = torch.float64
    exact = plain(*cast(args, f64), **cast(kwargs, f64), bf16_operands=True)
    emu = plain(*args, **kwargs, bf16_operands=True).double()
    got, x = got.double(), x.double()
    return {"emu_rel_l2": rel_l2(got, exact), "emu_update_rel_l2": rel_l2(got - x, exact - x),
            "cudnn_emu_rel_l2": rel_l2(emu, exact),
            "cudnn_emu_update_rel_l2": rel_l2(emu - x, exact - x)}


def emulation_holds(out: dict, bar: float) -> bool:
    """rel_l2 <= max(bar, 2 x the float32 emulation's), output and update."""
    return (out["emu_rel_l2"] <= max(bar, 2 * out["cudnn_emu_rel_l2"]) and
            out["emu_update_rel_l2"] <= max(bar, 2 * out["cudnn_emu_update_rel_l2"]))


def check_emulation(got, plain, args, kwargs, x, bar: float, what: str) -> dict:
    """`emulation`, raising where it misses `emulation_holds`."""
    out = emulation(got, plain, args, kwargs, x)
    if not emulation_holds(out, bar):
        raise AssertionError(f"{what}: kernel off its bf16 emulation ({out}, "
                             f"bar max({bar}, 2 x cudnn))")
    return out


def cast(obj, dtype):
    """Copies of every floating tensor in obj as dtype (tuples walked)."""
    if isinstance(obj, (tuple, list)):
        return type(obj)(cast(o, dtype) for o in obj)
    if isinstance(obj, dict):
        return {k: cast(v, dtype) for k, v in obj.items()}
    if hasattr(obj, "is_floating_point") and obj.is_floating_point():
        return obj.to(dtype)
    return obj


def work(name: str, a: dict) -> tuple:
    """(FLOP, bytes) one wrapper call must do on these inputs: the bytes read
    each input once and write each output once; the FLOP count the keys
    this run's lengths leave valid."""
    nbytes = 4 * sum(t.numel() for v in a.values()
                     for t in (v if isinstance(v, (tuple, list)) else (v,))
                     if hasattr(t, "numel"))
    if name == "log_mel":
        B, T = a["audio"].shape
        frames, bins = 1 + T // a["hop"], a["n_fft"] // 2 + 1
        flop = 2 * B * frames * bins * (2 * a["n_fft"] + a["n_mels"])
        return flop, nbytes + 4 * B * frames * a["n_mels"]
    if name == "rel_attention":
        B, H, T, D = a["q"].shape
        keys = sum(min(int(n), T) for n in a["key_lens"])   # valid keys over the batch
        flop = 4 * H * T * keys * D + 4 * B * H * T * (2 * a["window_size"] + 1) * D
        return flop, nbytes + a["q"].numel() * 4
    B, T, C = a["x"].shape
    if name == "resblock_chain":
        taps = 2 * len(a["dilations"]) * a["kernel_size"]
    else:
        taps = sum(2 * len(d) * k for k, d in zip(a["kernel_sizes"], a["dilations"]))
    return 2 * B * T * C * C * taps, nbytes + 4 * B * T * C


def describe(a: dict) -> dict:
    return {k: (list(v.shape) if v.numel() > 4 else v.tolist()) if hasattr(v, "numel")
            else f"{len(v)} tensors" if isinstance(v, tuple) and hasattr(v[0], "numel")
            else v for k, v in a.items()}


def bound(flop: int, nbytes: int, peak: tuple) -> tuple:
    t_ops, t_bytes = flop / peak[0], nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound_text(peak: tuple) -> str:
    return (f"max(FLOP / {peak[0] / 1e12:g} TFLOP/s {peak[1]}, bytes / 3.35 TB/s): "
            "H100 SXM peaks at 700 W")


def sdpa_mask(a: dict):
    """K3's band logits and key mask as a dense (B, H, T, T) additive mask
    for scaled_dot_product_attention (float32)."""
    import torch

    q, w = a["q"], a["window_size"]
    B, H, T, D = q.shape
    band = (q / D ** 0.5) @ a["emb_rel_k"].transpose(-1, -2)           # (B, H, T, 2w+1)
    t = torch.arange(T, device=q.device)
    rel = t[None, :] - t[:, None] + w                                  # key - row + w
    in_band = (rel >= 0) & (rel <= 2 * w)
    mask = band.gather(-1, rel.clamp(0, 2 * w).expand(B, H, T, T)) * in_band
    lens = a["key_lens"].to(q.device)
    return mask.masked_fill(t[None, None, None, :] >= lens[:, None, None, None], -1e4)


def kernel_grid(name: str, a: dict) -> dict:
    """The launch grid of K3's split kernel or K4's DFT kernel for this call."""
    if name == "rel_attention":
        from rvc_tpu_torch.ops.kernels.attention import launch_plan

        B, H, T, D = a["q"].shape
        return launch_plan(B * H, T, D, a["window_size"])
    from rvc_tpu_torch.ops.kernels.melspec import launch_plan

    B, T = a["audio"].shape
    return launch_plan(B, T, a["n_fft"], a["hop"], a["n_mels"])


def check_calls(calls: list) -> list:
    """Hold each recorded wrapper call's kernel against its plain version on
    the same inputs, at the kernel's bars (raises on a miss). Returns
    (fn, args, kwargs, plain, bound arguments, description, comparison)."""
    import importlib

    import torch

    checked = []
    for fn, args, kwargs in calls:
        name = fn.__name__
        spec = KERNELS[name]
        plain = getattr(importlib.import_module(f"rvc_tpu_torch.ops.kernels.{spec['module']}"),
                        name + "_reference")
        bound_args = inspect.signature(fn).bind(*args, **kwargs)
        bound_args.apply_defaults()
        a = bound_args.arguments
        got, ref = fn(*args, **kwargs), plain(*args, **kwargs)
        desc = describe(a)
        what = f"{name} {desc}"
        if name in ("rel_attention", "log_mel"):
            # float32 kernels, held against their plain version run in float64:
            # two float32 runs can each miss the bar against exact
            # arithmetic, and then differ from each other by twice it
            exact = plain(*cast(args, torch.float64), **cast(kwargs, torch.float64))
            if name == "rel_attention":  # rows past the length differ by design
                T = a["q"].shape[2]
                valid = (torch.arange(T, device=got.device)[None, :]
                         < a["key_lens"].to(got.device)[:, None])[:, None, :, None]
                got, ref, exact = got * valid, ref * valid, exact * valid
            cmp = compare_exact(got, ref, exact, spec["atol"], spec["rtol"], what)
            del exact
        else:
            cmp = compare(got, ref, spec["atol"], spec["rtol"], what, spec.get("min_corr"))
        if "emu_rel_l2" in spec:
            cmp.update(check_emulation(got, plain, args, kwargs, a["x"],
                                       spec["emu_rel_l2"], what))
        checked.append((fn, args, kwargs, plain, a, desc, cmp))
        del got, ref
    return checked


def held_calls(calls: list, time_them: bool = False) -> dict:
    """check_calls over one block's recorded wrapper calls, per kernel: the
    calls, the worst comparison numbers, the grid (K3, K4), and with
    time_them the ms of the kernel and of its plain version summed over
    the calls (one call between CUDA events, median of 5) beside the bound."""
    import torch

    with torch.inference_mode():
        checked = check_calls(calls)
        held = {}
        for fn, args, kwargs, plain, a, desc, cmp in checked:
            name = fn.__name__
            h = held.setdefault(name, {"calls": 0, "max_abs": 0.0, "rel_l2": 0.0, "inputs": []})
            h["calls"] += 1
            shape = desc.get("x", desc.get("q", desc.get("audio")))
            if shape not in h["inputs"]:
                h["inputs"].append(shape)
            for k in ("max_abs", "rel_l2", "emu_rel_l2", "emu_update_rel_l2", "excess",
                      "plain_f32_excess", "plain_f32_vs_f64_max_abs",
                      "plain_f32_vs_f64_rel_l2", "vs_plain_f32_max_abs"):
                if k in cmp:
                    h[k] = max(h[k], cmp[k]) if k in h else cmp[k]
            if name in ("rel_attention", "log_mel"):
                h["grid"] = kernel_grid(name, a)
            if time_them:
                flop, nbytes = work(name, a)
                h["ms"] = h.get("ms", 0.0) + cuda_ms(lambda: fn(*args, **kwargs))
                h["plain_ms"] = h.get("plain_ms", 0.0) + cuda_ms(lambda: plain(*args, **kwargs))
                h["flop"] = h.get("flop", 0) + flop
                h["bytes"] = h.get("bytes", 0) + nbytes
    for name, h in held.items():
        if time_them:
            h["bound_ms"], h["bound_by"] = bound(h.pop("flop"), h.pop("bytes"),
                                                 KERNELS[name]["peak"])
    return held


def phase_kernels(calls: list, launches: dict) -> list:
    """Replay each recorded wrapper call: check the kernel against its plain
    version, then time both. Returns the per-kernel summary."""
    import torch

    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    results = {}
    with torch.inference_mode():
        reset_launches()
        checked = check_calls(calls)
        torch.cuda.synchronize()
        replayed = dict(LAUNCHES)
        if replayed != launches:
            raise AssertionError(f"the recorded calls launch {replayed}, "
                                 f"the timed conversion launched {launches}")
        for fn, args, kwargs, plain, a, desc, cmp in checked:
            name = fn.__name__
            spec = KERNELS[name]
            flop, nbytes = work(name, a)
            ms = cuda_ms(lambda: fn(*args, **kwargs))
            plain_ms = cuda_ms(lambda: plain(*args, **kwargs))
            extra = {"ms_queued": cuda_ms(lambda: fn(*args, **kwargs), calls=KERNEL_CALLS),
                     "plain_ms_queued": cuda_ms(lambda: plain(*args, **kwargs),
                                                calls=KERNEL_CALLS)}
            if "emu_rel_l2" in spec:
                bf_args, bf_kwargs = cast(args, torch.bfloat16), cast(kwargs, torch.bfloat16)
                extra["cudnn_bf16_ms"] = cuda_ms(lambda: plain(*bf_args, **bf_kwargs))
                del bf_args, bf_kwargs
            else:
                extra["grid"] = kernel_grid(name, a)
            extra["device_ms"] = device_kernel_ms(lambda: fn(*args, **kwargs))
            if name == "rel_attention":
                mask = sdpa_mask(a)

                def sdpa():
                    torch.nn.functional.scaled_dot_product_attention(a["q"], a["k"], a["v"],
                                                                     attn_mask=mask)
                extra["sdpa_ms"] = cuda_ms(sdpa)
                extra["sdpa_ms_queued"] = cuda_ms(sdpa, calls=KERNEL_CALLS)
                del mask
            bound_ms, bound_by = bound(flop, nbytes, spec["peak"])
            emit({"phase": "kernel", "name": spec["name"], "inputs": desc, **cmp,
                  "ms": ms, "plain_ms": plain_ms, **extra, "bound_ms": bound_ms,
                  "bound_by": bound_by, "bound": bound_text(spec["peak"])})
            r = results.setdefault(name, dict(flop=0, bytes=0, calls=0, max_abs_err=0.0,
                                              ms=0.0, plain_ms=0.0, ms_queued=0.0,
                                              plain_ms_queued=0.0))
            r["flop"] += flop
            r["bytes"] += nbytes
            r["calls"] += 1
            r["max_abs_err"] = max(r["max_abs_err"], cmp["max_abs"])
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["ms_queued"] += extra["ms_queued"]
            r["plain_ms_queued"] += extra["plain_ms_queued"]
            if "grid" in extra:
                r["grid"] = extra["grid"]
            dev = r.setdefault("device_ms", {})
            for k, t in extra["device_ms"].items():
                dev[k] = dev.get(k, 0.0) + t
            if "sdpa_ms" in extra:
                for k in ("sdpa_ms", "sdpa_ms_queued"):
                    r[k] = r.get(k, 0.0) + extra[k]
            if "cudnn_bf16_ms" in extra:
                r["cudnn_bf16_ms"] = r.get("cudnn_bf16_ms", 0.0) + extra["cudnn_bf16_ms"]
                for k in ("emu_rel_l2", "emu_update_rel_l2", "cudnn_emu_rel_l2"):
                    r[k] = max(r.get(k, 0.0), cmp[k])
    summary = []
    for name, spec in KERNELS.items():
        r = results.get(name)
        if r is None:
            raise AssertionError(f"the main path made no call of {name}")
        bound_ms, bound_by = bound(r["flop"], r["bytes"], spec["peak"])
        summary.append(dict(
            name=spec["name"], route="cuda", source=spec["source"], entry=spec["entry"],
            replaces=spec["replaces"], launches=launches[name], calls=r["calls"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], ms_queued=r["ms_queued"],
            device_ms=r.get("device_ms"), plain_ms=r["plain_ms"],
            plain_ms_queued=r["plain_ms_queued"],
            bound_ms=bound_ms, bound_by=bound_by, bound=bound_text(spec["peak"]),
            library_ms=None, cudnn_bf16_ms=r.get("cudnn_bf16_ms"), sdpa_ms=r.get("sdpa_ms"),
            sdpa_ms_queued=r.get("sdpa_ms_queued"),
            grid=r.get("grid"),
            emu_rel_l2=r.get("emu_rel_l2"), emu_update_rel_l2=r.get("emu_update_rel_l2"),
            cudnn_emu_rel_l2=r.get("cudnn_emu_rel_l2")))
    return summary


def phase_stages(rvc) -> None:
    """Device time of each stage of one 13.5 s chunk (median CUDA-event ms),
    beside the host's share of a conversion."""
    import numpy as np
    import torch
    from torch.nn import functional as F

    from rvc_tpu_torch.ops.kernels.melspec import log_mel
    from rvc_tpu_torch.pipelines.offline import coarse_f0_torch, upsample_protect
    from rvc_tpu_torch.utils import audio as audio_utils

    p, synth = rvc.pipeline, rvc.pipeline.synthesizer
    clip = test_clip(CLIP_S, SEED)
    t0 = time.perf_counter()
    chunk = np.pad(audio_utils.highpass_filter(clip, 16000, 48.0, 5), (p.t_pad, p.t_pad),
                   mode="reflect")
    n = len(chunk)
    padded = np.pad(chunk, (0, p._bucket_samples(n) - n), mode="reflect")
    host_ms = 1e3 * (time.perf_counter() - t0)
    audio = torch.from_numpy(padded)[None].to(rvc.device)
    st = {}
    with torch.inference_mode():
        mel = log_mel(audio)
        pad = 32 * ((mel.shape[1] - 1) // 32 + 1) - mel.shape[1]
        melp = F.pad(mel.transpose(1, 2), (0, pad), mode="reflect").transpose(1, 2)
        st["f0 program"] = cuda_ms(lambda: p.f0(audio, 0.0, 0.0))
        st["  log-mel (K4)"] = cuda_ms(lambda: log_mel(audio))
        st["  RMVPE E2E"] = cuda_ms(lambda: p.rmvpe(melp))
        st["    U-Net + cnn"] = cuda_ms(lambda: p.rmvpe.cnn(p.rmvpe.unet(melp[..., None])))
        trunk = p.rmvpe.cnn(p.rmvpe.unet(melp[..., None]))
        trunk = trunk.permute(0, 1, 3, 2).reshape(*trunk.shape[:2], -1)
        st["    BiGRU + fc"] = cuda_ms(lambda: p.rmvpe.fc(trunk))
        st["HuBERT"] = cuda_ms(lambda: p.hubert(audio))
        f0 = p.f0(audio, 0.0, 0.0)
        feats = p.hubert(audio)
        feats = F.pad(feats.transpose(1, 2), (0, max(0, (f0.shape[1] + 1) // 2 - feats.shape[1])),
                      mode="replicate").transpose(1, 2)
        phone = upsample_protect(feats, feats, f0, 0.5)
        lengths = torch.tensor([n // 160], device=rvc.device)
        sid = torch.tensor([0], device=rvc.device)
        pitch = coarse_f0_torch(f0)
        st["synthesizer"] = cuda_ms(lambda: synth.infer(phone, lengths, pitch, f0, sid))
        m_p, _, x_mask = synth.enc_p(phone, pitch, lengths)
        g = synth.emb_g(sid)[:, None, :]
        st["  enc_p (K3)"] = cuda_ms(lambda: synth.enc_p(phone, pitch, lengths))
        st["  flow"] = cuda_ms(lambda: synth.flow(m_p * x_mask, x_mask, g=g))
        z = synth.flow(m_p * x_mask, x_mask, g=g) * x_mask
        st["  decoder (K1, K2)"] = cuda_ms(lambda: synth.dec(z, f0, g=g))
    emit({"phase": "stages", "clip_s": CLIP_S, "host_prep_ms": host_ms, "device_ms": st})


def timed_conversion(rvc, clip, samples=None, **kwargs) -> tuple:
    """(output, wall ms, launches) of one conversion after a warm call, the
    launch counts set to 0 just before it and read just after; the output
    must be finite and `samples` long (the clip's length at the model's
    rate when None)."""
    import numpy as np
    import torch

    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    rvc.infer(clip, **kwargs)            # warm: cuDNN plans, allocator, index upload
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = rvc.infer(clip, **kwargs)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    want = samples or int(len(clip) * rvc.cfg.data.sample_rate / 16000)
    if len(out) != want or not np.isfinite(out).all():
        raise AssertionError(f"output: {len(out)} samples (want {want}), "
                             f"finite={bool(np.isfinite(out).all())}")
    return out, wall_ms, launches


def gpu_cpu_corr(rvc, model_path: str, index_path: str) -> dict:
    """A 2 s clip through `rvc` on the card and through the same files on
    the port's CPU path, source noise off: waveform corr > 0.99."""
    import numpy as np

    from rvc_tpu_torch.api import RVC

    clip = test_clip(PARITY_S, SEED + 1)
    rvc.pipeline.source_noise = False
    gpu = rvc.infer(clip)
    t0 = time.perf_counter()
    cpu = RVC(model_path=model_path, index_path=index_path, seed=SEED, device="cpu",
              source_noise=False).infer(clip)
    if len(gpu) != len(cpu):
        raise AssertionError(f"GPU gave {len(gpu)} samples, CPU {len(cpu)}")
    corr = float(np.corrcoef(gpu, cpu)[0, 1])
    if not corr > 0.99:
        raise AssertionError(f"GPU vs CPU waveform corr {corr}")
    return {"clip_s": PARITY_S, "waveform_corr": corr,
            "max_abs": float(np.abs(gpu - cpu).max()), "cpu_seconds": time.perf_counter() - t0}


def index_features(hubert, device, n: int):
    """(n, 768) HuBERT features, as the pipeline takes them, of seeded
    chirps of 10-40 s (each spans 110-330 Hz over its length), on the card."""
    import numpy as np
    import torch

    feats, total, seed = [], 0, 100
    with torch.inference_mode():
        while total < n:
            audio = torch.from_numpy(test_clip(10.0 + 5.0 * (seed % 7), seed))[None].to(device)
            feats.append(hubert(audio, output_hidden_states=True)[0].cpu().numpy())
            total += len(feats[-1])
            seed += 1
    return np.concatenate(feats)[:n]


def phase_retrieval(rvc, work: str) -> tuple:
    """The 48 kHz model from an upstream .pth with a FAISS index of INDEX_N
    vectors built on the card, at index_rate 0.75. Returns (the index's
    path, the launches of the timed conversion)."""
    import numpy as np
    import torch

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.pipelines.offline import retrieve
    from rvc_tpu_torch.retrieval import build_index, read_faiss_index, write_faiss_index
    from rvc_tpu_torch.retrieval.ivf import default_nlist, index_blend
    from rvc_tpu_torch.utils import audio as audio_utils
    from rvc_tpu_torch.utils.weights import export_pth

    model_path = export_pth(rvc.pipeline.synthesizer.state_dict(), rvc.cfg,
                            os.path.join(work, "model48k.pth"))
    t0 = time.perf_counter()
    feats = index_features(rvc.pipeline.hubert, rvc.device, INDEX_N)
    feats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_index(feats, nprobe=1, seed=SEED, device=rvc.device)
    build_s = time.perf_counter() - t0
    index_path = os.path.join(work, "model.index")
    t0 = time.perf_counter()
    write_faiss_index(index, index_path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = read_faiss_index(index_path)
    read_s = time.perf_counter() - t0
    if (index.ntotal, index.d, index.nlist) != (INDEX_N, 768, default_nlist(INDEX_N)):
        raise AssertionError(f"index read back as {index.ntotal} x {index.d}, "
                             f"{index.nlist} lists")
    sizes = np.bincount(index.list_ids, minlength=index.nlist)

    t0 = time.perf_counter()
    rvc_r = RVC(model_path=model_path, index_path=index_path, seed=SEED, device="cuda")
    load_s = time.perf_counter() - t0
    clip = test_clip(CLIP_S, SEED)
    out, wall_ms, launches = timed_conversion(rvc_r, clip, index_rate=INDEX_RATE)
    missing = [k for k in KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the retrieval path never launched {missing}")
    plain = rvc_r.infer(clip, index_rate=0.0)

    # the retrieval stage alone, on the clip's one chunk of HuBERT frames
    p = rvc_r.pipeline
    chunk = np.pad(audio_utils.highpass_filter(clip, 16000, 48.0, 5), (p.t_pad, p.t_pad),
                   mode="reflect")
    with torch.inference_mode():
        feats = p.hubert(p._upload(chunk), output_hidden_states=True)
        q = feats[0]
        vectors, _, _, centroids = rvc_r.index.tensors(q.device)
        d, i = rvc_r.index.search_device(q, 8)
        search_ms = cuda_ms(lambda: rvc_r.index.search_device(q, 8))
        blend_ms = cuda_ms(lambda: index_blend(q, vectors[i], d, INDEX_RATE))
        retrieve_ms = cuda_ms(lambda: retrieve(feats, rvc_r.index, INDEX_RATE))
        blended = retrieve(feats, rvc_r.index, INDEX_RATE)
        moved = rel_l2(blended, feats)
        # the same search and blend on the host: a near-tie may pick another
        # neighbour, so hold the blended features, not the ids
        _, i_cpu = rvc_r.index.search_device(q.cpu(), 8)
        blended_cpu = retrieve(feats.cpu(), rvc_r.index, INDEX_RATE)
        host = {"ids_equal": float((i.cpu() == i_cpu).float().mean()),
                "rel_l2": rel_l2(blended.cpu(), blended_cpu),
                "corr": float(torch.corrcoef(torch.stack([blended.cpu().flatten(),
                                                          blended_cpu.flatten()]))[0, 1])}
        if not host["corr"] > 0.999:
            raise AssertionError(f"retrieval on the card against the host: {host}")
    Q, D = q.shape
    N, K = vectors.shape[0], centroids.shape[0]
    flop = 2 * Q * (N + K) * D
    # read the queries, vectors, |v|^2, list ids and centroids once; write (Q, 8) d and ids
    nbytes = 4 * (Q * D + N * D + N + K * D + Q * 8) + 8 * (N + Q * 8)
    bound_ms, bound_by = bound(flop, nbytes, PEAK_F32)
    parity = gpu_cpu_corr(rvc_r, model_path, index_path)
    emit({"phase": "retrieval", "index": {"vectors": INDEX_N, "d": index.d, "nlist": index.nlist,
                                          "nprobe": index.nprobe, "list_sizes_min_median_max":
                                          [int(sizes.min()), float(np.median(sizes)),
                                           int(sizes.max())],
                                          "file_mb": os.path.getsize(index_path) / 1e6},
          "features_s": feats_s, "build_s": build_s, "write_s": write_s, "read_s": read_s,
          "model_load_s": load_s, "clip_s": CLIP_S, "index_rate": INDEX_RATE,
          "wall_ms": wall_ms, "realtime_x": CLIP_S * 1e3 / wall_ms, "launches": launches,
          "queries": Q, "search_ms": search_ms, "blend_ms": blend_ms,
          "search_and_blend_ms": retrieve_ms, "search_gflop": flop / 1e9,
          "search_bound_ms": bound_ms, "search_bound_by": bound_by,
          "median_nearest_d": float(d[:, 0].median()), "features_moved_rel_l2": moved,
          "card_vs_host": host,
          "corr_with_index_rate_0": float(np.corrcoef(out, plain)[0, 1]),
          "parity": parity})
    return index_path, launches


def phase_f0less(index_path: str, work: str) -> dict:
    """An f0-less 40 kHz model at full width from its .pth, with the same
    index, through the staged path; every kernel call of one conversion
    held against its plain version. Returns the timed run's launches."""
    import torch

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.synthesizer import build_synthesizer
    from rvc_tpu_torch.ops.kernels import record_calls
    from rvc_tpu_torch.utils.weights import export_pth

    cfg = get_config(40000, model_use_f0=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        synth = build_synthesizer(cfg)
    model_path = export_pth(synth.state_dict(), cfg, os.path.join(work, "f0less40k.pth"),
                            pitch_guidance=False)
    rvc = RVC(model_path=model_path, index_path=index_path, seed=SEED, device="cuda")
    if rvc.cfg.model.use_f0 or rvc.cfg.data.sample_rate != 40000:
        raise AssertionError("the f0-less .pth loaded as another model")
    clip = test_clip(CLIP_S, SEED)
    _, wall_ms, launches = timed_conversion(rvc, clip, index_rate=INDEX_RATE)
    wrong = {k: launches[k] for k in KERNELS if (launches[k] > 0) != (k != "log_mel")}
    if wrong:
        raise AssertionError(f"the f0-less path launched {launches}: K1-K3 > 0, K4 = 0 expected")
    with record_calls() as calls:
        rvc.infer(clip, index_rate=INDEX_RATE)
    held = held_calls(calls)
    del calls
    emit({"phase": "f0less", "config": "get_config(40000, model_use_f0=False)",
          "decoder_channels": [m.out_channels for m in rvc.pipeline.synthesizer.dec.ups],
          "clip_s": CLIP_S, "index_rate": INDEX_RATE, "wall_ms": wall_ms,
          "realtime_x": CLIP_S * 1e3 / wall_ms, "launches": launches, "checked": held,
          "parity": gpu_cpu_corr(rvc, model_path, index_path)})
    return launches


NEURAL = ("rmvpe", "crepe", "crepe-tiny", "fcpe")
# the pitch phase's staged runs: name -> RVC.infer arguments ("input_f0" is
# filled in from the clip's RMVPE contour, read back from a text file)
PITCH_RUNS = {
    "crepe": dict(f0_method="crepe"),
    "crepe-tiny": dict(f0_method="crepe-tiny"),
    "fcpe": dict(f0_method="fcpe"),
    "pm": dict(f0_method="pm"),
    "dio": dict(f0_method="dio"),
    "harvest": dict(f0_method="harvest"),
    "hybrid[rmvpe+crepe-tiny+harvest]": dict(f0_method="hybrid[rmvpe+crepe-tiny+harvest]"),
    "rmvpe+proposed_pitch": dict(f0_method="rmvpe", proposed_pitch=True),
    "input_f0": dict(),
}


def crepe_work(model, frames: int) -> tuple:
    """(FLOP, bytes) of CREPE's network on `frames` frames: every conv
    output position's MACs and the classifier's; the frames, the weights
    and the probabilities each moved once."""
    macs, h = 0, 1024
    for i in range(1, 7):
        conv = getattr(model, f"conv{i}")
        cout, cin, k, _ = conv.weight.shape
        h = (h + (508 if i == 1 else 63) - k) // conv.stride[0] + 1
        macs += h * cout * cin * k
        h //= 2
    macs += model.classifier.weight.numel()
    params = sum(p.numel() for p in model.parameters())
    return 2 * frames * macs, 4 * (frames * (1024 + 360) + params)


def fcpe_work(model, frames: int) -> tuple:
    """(FLOP, bytes) of FCPE's network on `frames` frames: every Conv1d and
    Linear (each weight used once a frame), and each layer's performer
    feature maps and linear attention (4 H M D MACs a frame); the mel, the
    weights and the salience each moved once."""
    from torch import nn

    macs = sum(m.weight.numel() for m in model.modules() if isinstance(m, (nn.Conv1d, nn.Linear)))
    for layer in model.decoder._layers:
        m, d = layer.attn.fast_attention.projection_matrix.shape
        macs += 4 * layer.attn.heads * m * d
    params = sum(p.numel() for p in model.parameters())
    return 2 * frames * macs, 4 * (frames * (128 + 360) + params)


def crepe_layers(model, frames) -> list:
    """Each of CREPE's six layers alone on the clip's frames: the conv's
    CUDA-event ms (cuDNN's default algorithm, and the one its autotuner
    picks with `cudnn.benchmark`), its FLOP and achieved TFLOP/s, and the
    ms of the ReLU, BatchNorm and pool after it."""
    import torch
    from torch.nn import functional as F

    out, h = [], frames[:, None, :, None]
    with torch.inference_mode():
        for i in range(1, 7):
            conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
            x = F.pad(h, (0, 0, 254, 254) if i == 1 else (0, 0, 31, 32))
            y = conv(x)
            ms = cuda_ms(lambda: conv(x))
            torch.backends.cudnn.benchmark = True
            try:
                bench_ms = cuda_ms(lambda: conv(x))
            finally:
                torch.backends.cudnn.benchmark = False
            flop = 2 * y.numel() * conv.in_channels * conv.kernel_size[0]
            rest_ms = cuda_ms(lambda: F.max_pool2d(bn(F.relu(y)), (2, 1), (2, 1)))
            out.append({"layer": i, "out": list(y.shape), "conv_ms": ms,
                        "conv_ms_benchmark": bench_ms, "tflop": flop / 1e12,
                        "tflop_per_s": flop / ms / 1e9, "relu_bn_pool_ms": rest_ms})
            h = F.max_pool2d(bn(F.relu(y)), (2, 1), (2, 1))
            del x, y
    return out


def pitch_vs_host(method: str, seconds: float) -> dict:
    """`method`'s f0 of a seeded clip on the card against the port's CPU
    path with the same seeded weights: voicing agreement >= 99% of frames
    and a median |delta cents| < 1 on frames voiced on both."""
    import numpy as np

    from rvc_tpu_torch.pitch import PitchExtractor

    clip = test_clip(seconds, SEED + 2)
    gpu = PitchExtractor(method, device="cuda").extract(clip)
    cpu = PitchExtractor(method, device="cpu").extract(clip)
    if gpu.shape != cpu.shape:
        raise AssertionError(f"{method}: card gave {gpu.shape} frames, host {cpu.shape}")
    both = (gpu > 0) & (cpu > 0)
    out = {"clip_s": seconds, "frames": len(gpu), "voiced_share": float(both.mean()),
           "voicing_agreement": float(((gpu > 0) == (cpu > 0)).mean()),
           "median_abs_cents": float(np.median(np.abs(1200 * np.log2(gpu[both] / cpu[both]))))
           if both.any() else None}
    if not (out["voicing_agreement"] >= 0.99 and both.any() and out["median_abs_cents"] < 1):
        raise AssertionError(f"{method} f0 on the card against the host: {out}")
    return out


def phase_pitch(rvc, work: str) -> dict:
    """The staged path's pitch methods on the main path's 48 kHz model and
    the 13.5 s clip: a warm and a timed conversion each, then the
    extractor alone on the chunk it sees; card-vs-host checks; every kernel
    call of one staged crepe conversion held against its plain version.
    Returns {"staged_crepe": launches, "staged_rmvpe": launches}."""
    import numpy as np
    import torch

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.rmvpe import RMVPE
    from rvc_tpu_torch.ops.kernels import record_calls
    from rvc_tpu_torch.utils import audio as audio_utils

    p = rvc.pipeline
    p.source_noise = True                # as in the main path's timed run
    clip = test_clip(CLIP_S, SEED)
    # the chunk the extractor sees: high-passed, reflect-padded by t_pad
    chunk = np.pad(audio_utils.highpass_filter(clip, 16000, 48.0, 5), (p.t_pad, p.t_pad),
                   mode="reflect")
    # a user's f0 file: the clip's RMVPE contour, read back as the CLI reads it
    f0_path = os.path.join(work, "f0.txt")
    np.savetxt(f0_path, RMVPE(p.rmvpe).infer_from_audio(clip))
    input_f0 = np.loadtxt(f0_path, dtype=np.float32).ravel()
    runs, by_path = {}, {}
    for name, kwargs in PITCH_RUNS.items():
        if name == "input_f0":
            kwargs = dict(input_f0=input_f0)
        out, wall_ms, launches = timed_conversion(rvc, clip, **kwargs)
        rmvpe_runs = "rmvpe" in kwargs.get("f0_method", "")
        wrong = {k: launches[k] for k in KERNELS
                 if (launches[k] > 0) != (k != "log_mel" or rmvpe_runs)}
        if wrong:
            raise AssertionError(f"staged {name} launched {launches}: K1-K3 > 0 and K4 "
                                 f"{'> 0' if rmvpe_runs else '= 0'} expected")
        run = {"wall_ms": wall_ms, "realtime_x": CLIP_S * 1e3 / wall_ms,
               "out_samples": len(out), "launches": launches}
        if name == "input_f0":
            f0 = input_f0
        else:
            ext = p.pitch_extractor
            if ext.method in NEURAL:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                f0 = ext.extract(chunk)
                end.record()
                end.synchronize()
                run.update(extract_ms=start.elapsed_time(end), extract_clock="cuda events")
            else:
                t0 = time.perf_counter()
                f0 = ext.extract(chunk)
                run.update(extract_ms=1e3 * (time.perf_counter() - t0), extract_clock="host")
            run["f0_frames"] = len(f0)
            if ext.method in ("crepe", "fcpe"):
                model = ext._model.model
                flop, nbytes = (crepe_work if ext.method == "crepe" else fcpe_work)(
                    model, len(f0))
                bound_ms, bound_by = bound(flop, nbytes, PEAK_F32)
                run.update(network_tflop=flop / 1e12, bound_ms=bound_ms, bound_by=bound_by,
                           bound=bound_text(PEAK_F32))
            if ext.method == "crepe":
                from rvc_tpu_torch.models.crepe import frame_audio

                frames = frame_audio(torch.from_numpy(chunk)[None].to(rvc.device))[0]
                run["layers"] = crepe_layers(ext._model.model, frames)
                del frames
        run["voiced_share"] = float((np.asarray(f0) > 0).mean())
        runs[name] = run
        if name == "crepe":
            by_path["staged_crepe"] = launches
        elif name == "rmvpe+proposed_pitch":
            by_path["staged_rmvpe"] = launches

    # every kernel call of one staged crepe conversion against its plain version
    with record_calls() as calls:
        rvc.infer(clip, f0_method="crepe")
    held = held_calls(calls)
    del calls

    # the staged crepe-tiny waveform on the card against the host, source noise off
    short = test_clip(PARITY_S, SEED + 1)
    p.source_noise = False
    gpu = rvc.infer(short, f0_method="crepe-tiny")
    t0 = time.perf_counter()
    cpu = RVC(config=get_config(48000), seed=SEED, device="cpu",
              source_noise=False).infer(short, f0_method="crepe-tiny")
    corr = float(np.corrcoef(gpu, cpu)[0, 1]) if len(gpu) == len(cpu) else float("nan")
    parity = {"clip_s": PARITY_S, "waveform_corr": corr,
              "cpu_seconds": time.perf_counter() - t0}
    if not corr > 0.99:
        raise AssertionError(f"staged crepe-tiny, GPU vs CPU: {len(gpu)} / {len(cpu)} "
                             f"samples, waveform corr {corr}")
    emit({"phase": "pitch", "clip_s": CLIP_S, "chunk_samples": len(chunk), "runs": runs,
          "crepe_checked": held, "crepe_vs_host": pitch_vs_host("crepe", 0.5),
          "fcpe_vs_host": pitch_vs_host("fcpe", 2.0), "crepe_tiny_parity": parity})
    return by_path


# ---------------------------------------------------------------------------
# postfx: formant shift, split, noise reduction, the ten effects, export
# ---------------------------------------------------------------------------

SILENCES_S = ((4.0, 4.8), (9.0, 9.8))     # cut into the 13.5 s clip for the split
POSTFX = dict(split_audio=True, clean_audio=True, clean_strength=0.5,
              formant_shifting=True, formant_qfrency=1.0, formant_timbre=1.2,
              post_process=True)
# all ten effects on, at values that change the signal
FX_ALL = dict(reverb=True, pitch_shift=True, pitch_shift_semitones=2.0, limiter=True,
              limiter_threshold=-8.0, gain=True, gain_db=3.0, distortion=True,
              distortion_gain=12.0, chorus=True, bitcrush=True, bitcrush_bit_depth=12.0,
              clipping=True, clipping_threshold=-1.0, compressor=True,
              compressor_threshold=-18.0, compressor_ratio=3.0, delay=True,
              delay_seconds=0.25, delay_feedback=0.3)


def gapped_clip():
    """The 13.5 s clip with SILENCES_S cut to zero, so the split finds
    several non-silent intervals."""
    clip = test_clip(CLIP_S, SEED)
    for a, b in SILENCES_S:
        clip[int(a * 16000):int(b * 16000)] = 0.0
    return clip


def export_check(audio, sr: int, work: str, fmt: str) -> dict:
    """Export `audio` as fmt through `encode_audio`. Where soundfile or the
    ffmpeg binary is on the machine the file must be written and read back
    (soundfile may refuse a format, and then ffmpeg must be absent); where
    neither is, the RuntimeError must be raised."""
    import importlib.util
    import shutil

    import numpy as np

    from rvc_tpu_torch.utils import audio as audio_utils

    has = {"soundfile": importlib.util.find_spec("soundfile") is not None,
           "ffmpeg": shutil.which("ffmpeg") is not None}
    out = {"format": fmt, "encoders_present": has}
    try:
        path = audio_utils.encode_audio(audio, sr, os.path.join(work, "postfx"), fmt)
    except RuntimeError as e:
        if has["ffmpeg"]:
            raise
        return {**out, "written": False, "raised": "RuntimeError", "message": str(e)[:160]}
    if has["soundfile"]:
        import soundfile as sf

        back, back_sr = sf.read(path, dtype="float32")
    else:
        wav = path + ".wav"
        subprocess.run([shutil.which("ffmpeg"), "-y", "-loglevel", "error", "-i", path, wav],
                       check=True, timeout=120)
        back, back_sr = audio_utils.load_wav(wav)
    back = audio_utils.to_mono(np.asarray(back, dtype=np.float32))
    if back_sr != sr or not len(back) >= 0.95 * len(audio) or not np.isfinite(back).all():
        raise AssertionError(f"{fmt} read back as {len(back)} samples at {back_sr} Hz "
                             f"(wrote {len(audio)} at {sr})")
    return {**out, "written": True, "bytes": os.path.getsize(path), "read_back_samples": len(back)}


def phase_postfx(rvc, work: str) -> dict:
    """`RVC.infer` with every flag of the rest of `infer` on the gapped clip:
    the wall, each host part alone, and FLAC / MP3 export. Returns the
    timed run's launches."""
    import numpy as np

    from rvc_tpu_torch.realtime.fx import build_fx_chain
    from rvc_tpu_torch.utils.formant import formant_shift
    from rvc_tpu_torch.utils.noise import reduce_noise
    from rvc_tpu_torch.utils.split_audio import merge_audio, split_silence_nonsilent

    sr = rvc.cfg.data.sample_rate
    rvc.pipeline.source_noise = True
    clip = gapped_clip()
    want = int(len(clip) * sr / 16000) + 1           # merge_audio's length
    out, wall_ms, launches = timed_conversion(rvc, clip, samples=want, **POSTFX, **FX_ALL)
    missing = [k for k in KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the postfx path never launched {missing}")

    # each host part alone, on what it sees in the conversion
    host = {}
    t0 = time.perf_counter()
    shifted = formant_shift(clip, 16000, POSTFX["formant_qfrency"], POSTFX["formant_timbre"])
    host["formant_shift"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    intervals, segments = split_silence_nonsilent(shifted, 16000)
    host["split"] = 1e3 * (time.perf_counter() - t0)
    converted = [rvc.infer(seg) for seg in segments]
    t0 = time.perf_counter()
    merged = merge_audio(intervals, converted, len(shifted), 16000, sr)
    host["merge"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    cleaned = reduce_noise(merged, sr, POSTFX["clean_strength"])
    host["reduce_noise"] = 1e3 * (time.perf_counter() - t0)
    chain = build_fx_chain(**FX_ALL)
    t0 = time.perf_counter()
    final = chain(cleaned, sr)
    host["fx_chain"] = 1e3 * (time.perf_counter() - t0)
    effects, x = {}, cleaned
    for fx in chain.effects:
        t0 = time.perf_counter()
        x = np.asarray(fx(x, sr), dtype=np.float32)
        effects[fx.__qualname__.split(".")[0]] = 1e3 * (time.perf_counter() - t0)
    if len(segments) < 2 or len(chain.effects) != 10:
        raise AssertionError(f"{len(segments)} segments, {len(chain.effects)} effects")
    emit({"phase": "postfx", "clip_s": CLIP_S, "silences_s": SILENCES_S,
          "flags": {**POSTFX, **FX_ALL}, "wall_ms": wall_ms,
          "realtime_x": CLIP_S * 1e3 / wall_ms, "segments": len(segments),
          "segment_s": [round((e - s) / 16000, 3) for s, e in intervals],
          "out_samples": len(out), "launches": launches, "host_ms": host,
          "host_ms_split_and_merge": host["split"] + host["merge"], "effect_ms": effects,
          "parts_vs_timed_run_max_abs": float(np.abs(final - out).max()),
          "export": [export_check(out, sr, work, fmt) for fmt in ("FLAC", "MP3")]})
    return launches


# ---------------------------------------------------------------------------
# vocoders: the MRF HiFi-GAN and RefineGAN at full width
# ---------------------------------------------------------------------------

VOCODERS = {"mrf": "MRF HiFi-GAN", "refinegan": "RefineGAN"}
# plain torch decoders: K1/K2 are not reached, as in the reference
VOCODER_LAUNCHES = {"resblock_group": 0, "resblock_chain": 0, "rel_attention": 6, "log_mel": 1,
                    "resblock_group_tp": 0, "resblock_chain_tp": 0}


def decoder_inputs(rvc, clip) -> tuple:
    """The decoder's inputs (z, f0, g) for the clip's one chunk, as the
    fused path makes them."""
    import numpy as np
    import torch
    from torch.nn import functional as F

    from rvc_tpu_torch.pipelines.offline import coarse_f0_torch, upsample_protect
    from rvc_tpu_torch.utils import audio as audio_utils

    p, synth = rvc.pipeline, rvc.pipeline.synthesizer
    chunk = np.pad(audio_utils.highpass_filter(clip, 16000, 48.0, 5), (p.t_pad, p.t_pad),
                   mode="reflect")
    with torch.inference_mode():
        audio = p._upload(chunk)
        f0 = p.f0(audio, 0.0, 0.0)
        feats, _ = p._features(audio, audio.shape[1] // 160, None, 0.0)
        t_feat = feats.shape[1] * 2
        f0 = F.pad(f0, (0, max(0, t_feat - f0.shape[1])))[:, :t_feat]
        phone = upsample_protect(feats, feats, f0, 0.5)
        lengths = p._one(len(chunk) // 160)
        g = synth.emb_g(p._one(0))[:, None, :]
        m_p, _, x_mask = synth.enc_p(phone, coarse_f0_torch(f0), lengths)
        z = synth.flow(m_p * x_mask, x_mask, g=g) * x_mask
    return z, f0, g


def decoder_work(dec, z, f0, g) -> tuple:
    """(FLOP, bytes) of one decoder call: the multiply-adds of every conv,
    transposed conv and linear layer (forward hooks) and of RefineGAN's
    decimation filters; the inputs, weights and waveform each moved once.
    Elementwise work (sines, activations) is not counted."""
    import torch
    from torch import nn

    from rvc_tpu_torch.models.generators_extra import RefineGANGenerator

    flop = [0]

    def hook(m, inputs, out):
        x = inputs[0]
        if isinstance(m, nn.ConvTranspose1d):
            flop[0] += 2 * x.shape[0] * x.shape[1] * m.in_channels * m.out_channels * m.kernel_size[0]
        elif isinstance(m, nn.Conv1d):
            flop[0] += 2 * out.numel() * (m.in_channels // m.groups) * m.kernel_size[0]
        else:
            flop[0] += 2 * out.numel() * m.in_features

    handles = [m.register_forward_hook(hook) for m in dec.modules()
               if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear))]
    try:
        with torch.inference_mode():
            y = dec(z, f0, g=g)
    finally:
        for h in handles:
            h.remove()
    if isinstance(dec, RefineGANGenerator):
        T = z.shape[0] * z.shape[1] * dec.upp
        for i, block in enumerate(dec.downsample_blocks):
            factor = dec.rates[-i - 1]
            T = -(-T // factor)
            flop[0] += 2 * block.in_channels * T * (2 * 64 * factor + 1)
    params = sum(p.numel() for p in dec.parameters())
    return flop[0], 4 * (params + z.numel() + f0.numel() + g.numel() + y.numel())


def decoder_parts(dec, z, f0, g) -> dict:
    """Median CUDA-event ms of each part of the decoder alone, on the
    inputs the part sees in a call (noise off)."""
    import torch

    from rvc_tpu_torch.models.generators_extra import (RefineGANGenerator, audio_rate_sines,
                                                       kaiser_sinc_decimate, linear_resize)
    from rvc_tpu_torch.models.layers import leaky_relu

    parts = {}
    with torch.inference_mode():
        if not isinstance(dec, RefineGANGenerator):
            f0_up = f0[:, :, None].repeat_interleave(dec.upp, dim=1)
            parts["source: sines (9 harmonics) + linear"] = cuda_ms(lambda: dec.m_source(f0_up))
            har = dec.m_source(f0_up)
            parts["conv_pre + cond"] = cuda_ms(lambda: dec.conv_pre(z) + dec.cond(g))
            x = dec.conv_pre(z) + dec.cond(g)
            for i, (up, nc, blocks) in enumerate(zip(dec.upsamples, dec.noise_convs, dec.mrfs)):
                parts[f"stage {i}: upsample x{up.stride[0]} + noise conv"] = cuda_ms(
                    lambda up=up, nc=nc, x=x: (up(leaky_relu(x)), nc(har)))
                y, n = up(leaky_relu(x)), nc(har)
                m = min(y.shape[1], n.shape[1])
                y = y[:, :m] + n[:, :m]
                parts[f"stage {i}: 3 MRF blocks, C={y.shape[-1]}, T={m}"] = cuda_ms(
                    lambda y=y, blocks=blocks: sum(b(y) for b in blocks) / len(blocks))
                x = sum(b(y) for b in blocks) / len(blocks)
            parts["conv_post"] = cuda_ms(lambda: dec.conv_post(leaky_relu(x, 0.01)))
            return parts
        T = z.shape[1]

        def source():
            sines = audio_rate_sines(linear_resize(f0[:, :, None], T * dec.upp), dec.sample_rate)
            return dec.pre_conv(torch.tanh(dec.m_source.merge(sines)))

        parts["source: resize + sines + merge + pre_conv"] = cuda_ms(source)
        x, downs = source(), []
        for i, block in enumerate(dec.downsample_blocks):
            factor = dec.rates[-i - 1]
            xl = leaky_relu(x, dec.slope)
            parts[f"down {i}: decimate /{factor}, {xl.shape[-1]} ch, {2 * 64 * factor + 1} "
                  f"taps, T={xl.shape[1]}"] = cuda_ms(lambda xl=xl, f=factor: kaiser_sinc_decimate(xl, f))
            d = kaiser_sinc_decimate(xl, factor)
            parts[f"down {i}: conv {block.in_channels}->{block.out_channels}"] = cuda_ms(
                lambda d=d, b=block: b(d))
            downs.append(xl)
            x = block(d)
        parts["mel_conv + cond"] = cuda_ms(lambda: dec.mel_conv(z) + dec.cond(g))
        x = torch.cat([dec.mel_conv(z) + dec.cond(g), x], dim=-1)
        for i, (rate, block, d) in enumerate(zip(dec.rates, dec.upsample_conv_blocks,
                                                 reversed(downs))):
            parts[f"up {i}: resize x{rate}"] = cuda_ms(
                lambda x=x, r=rate: linear_resize(leaky_relu(x, dec.slope), x.shape[1] * r))
            y = linear_resize(leaky_relu(x, dec.slope), x.shape[1] * rate)
            n = min(d.shape[1], y.shape[1])
            y = torch.cat([y[:, :n], d[:, :n]], dim=-1)
            parts[f"up {i}: ParallelResBlock {y.shape[-1]}->{block.input_conv.out_channels}, "
                  f"T={n}"] = cuda_ms(lambda y=y, b=block: b(y))
            x = block(y)
        parts["conv_post"] = cuda_ms(lambda: dec.conv_post(leaky_relu(x, dec.slope)))
    return parts


def sine_drift(rvc, clip) -> dict:
    """The decoder's audio-rate sine bank (float32, as the reference) on
    the clip's f0 (13.5 s at the model's rate) against the same formula in
    float64 on the card: max |difference| and the rel_l2 of the sines."""
    import numpy as np
    import torch
    from torch.nn import functional as F

    from rvc_tpu_torch.models.generators_extra import (RefineGANGenerator, audio_rate_sines,
                                                       linear_resize)
    from rvc_tpu_torch.utils import audio as audio_utils

    p, dec = rvc.pipeline, rvc.pipeline.synthesizer.dec
    refine = isinstance(dec, RefineGANGenerator)
    harmonics = 0 if refine else dec.m_source.harmonic_num
    sr = rvc.cfg.data.sample_rate
    chunk = np.pad(audio_utils.highpass_filter(clip, 16000, 48.0, 5), (p.t_pad, p.t_pad),
                   mode="reflect")
    with torch.inference_mode():
        f0 = p.f0(p._upload(chunk), 0.0, 0.0)[:, :int(round(CLIP_S * 100))]
        frames = f0.shape[1]
        f0_up = (linear_resize(f0[:, :, None], frames * dec.upp) if refine
                 else f0[:, :, None].repeat_interleave(dec.upp, dim=1))
        s32 = audio_rate_sines(f0_up, sr, harmonics).double()
        f = f0_up.double()
        mult = torch.arange(1, harmonics + 2, dtype=torch.float64, device=f.device)
        rad = torch.fmod(f * mult / sr, 1.0)
        tmp = torch.fmod(torch.cumsum(rad, dim=1), 1.0)
        shift = F.pad(torch.where(tmp[:, 1:] - tmp[:, :-1] < 0, -1.0, 0.0).double(),
                      (0, 0, 1, 0))
        s64 = torch.sin(2.0 * torch.pi * torch.cumsum(rad + shift, dim=1)) * 0.1 * (f > 0)
    diff = (s32 - s64).abs()
    return {"samples": f0_up.shape[1], "harmonics": harmonics + 1, "max_abs": float(diff.max()),
            "rel_l2": rel_l2(s32, s64), "max_abs_last_second": float(diff[:, -sr:].max()),
            "sine_amp": 0.1}


def phase_vocoders(work: str) -> dict:
    """Each vocoder's 48 kHz model at full width (seed 0), written as a
    native .safetensors with its .json sidecar and loaded through
    RVC(model_path=...): wall, decoder ms and parts, FLOP and bound,
    launches, GPU-vs-CPU corr, sine drift. Returns {key: launches}."""
    import torch

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import config_to_dict, get_config
    from rvc_tpu_torch.models.generators_extra import HiFiGANMRFGenerator, RefineGANGenerator
    from rvc_tpu_torch.models.synthesizer import SOURCE_NOISE_SEED, build_synthesizer
    from rvc_tpu_torch.utils.weights import save_params, synthesizer_to_jax

    classes = {"mrf": HiFiGANMRFGenerator, "refinegan": RefineGANGenerator}
    by_path = {}
    for key, vocoder in VOCODERS.items():
        cfg = get_config(48000, model_vocoder=vocoder)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            synth = build_synthesizer(cfg)
        path = os.path.join(work, f"{key}48k.safetensors")
        save_params(synthesizer_to_jax(synth.state_dict()), path, config=config_to_dict(cfg))
        del synth
        rvc = RVC(model_path=path, seed=SEED, device="cuda")
        dec = rvc.pipeline.synthesizer.dec
        if rvc.cfg.model.vocoder != vocoder or not isinstance(dec, classes[key]):
            raise AssertionError(f"{path} loaded as {rvc.cfg.model.vocoder} / {type(dec)}")
        clip = test_clip(CLIP_S, SEED)
        _, wall_ms, launches = timed_conversion(rvc, clip)
        if launches != VOCODER_LAUNCHES:
            raise AssertionError(f"{vocoder} launched {launches}, want {VOCODER_LAUNCHES}")
        z, f0, g = decoder_inputs(rvc, clip)

        def decode():
            gen = torch.Generator(device=z.device)
            gen.manual_seed(SOURCE_NOISE_SEED)
            return dec(z, f0, g=g, generator=gen)

        with torch.inference_mode():
            dec_ms = cuda_ms(decode)
        flop, nbytes = decoder_work(dec, z, f0, g)
        bound_ms, bound_by = bound(flop, nbytes, PEAK_F32)
        emit({"phase": "vocoders", "vocoder": vocoder,
              "config": f"get_config(48000, model_vocoder={vocoder!r})",
              "decoder_params_m": sum(p.numel() for p in dec.parameters()) / 1e6,
              "clip_s": CLIP_S, "wall_ms": wall_ms, "realtime_x": CLIP_S * 1e3 / wall_ms,
              "launches": launches, "decoder_frames": z.shape[1], "decoder_ms": dec_ms,
              "decoder_tflop": flop / 1e12, "decoder_tflop_per_s": flop / dec_ms / 1e9,
              "bound_ms": bound_ms, "bound_by": bound_by, "bound": bound_text(PEAK_F32),
              "parts_ms": decoder_parts(dec, z, f0, g), "sine_drift": sine_drift(rvc, clip),
              "parity": gpu_cpu_corr(rvc, path, None)})
        by_path[key] = launches
        del rvc, dec, z, f0, g
        torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------------------
# longform: BatchConverter.convert_long_batch, 64 x 60 s
# ---------------------------------------------------------------------------

LONG_UTTS, LONG_S = 64, 60.0          # scripts/bench_longform.py's shape
CHUNK_S, PAD_S, LONG_BATCH = 10.0, 1.0, 8
AB_UTTS, AB_BATCHES = 16, (1, 8, 16)
LONG_LAUNCHES = {"resblock_group": 27, "resblock_chain": 9, "rel_attention": 6, "log_mel": 1,
                 "resblock_group_tp": 0, "resblock_chain_tp": 0}


def synth_utterances(n: int, seconds: float, sr: int = 16000):
    """Seeded voiced utterances, 3 harmonics of a slowly swept f0 (a copy of
    `scripts/bench_longform.py:synth_utterances`)."""
    import numpy as np

    utts = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        t = np.arange(int(seconds * sr)) / sr
        f0 = 120.0 + 60.0 * np.sin(2 * np.pi * (0.2 + 0.05 * (i % 7)) * t)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        sig = sum((0.5 / h) * np.sin(h * phase + rng.uniform(0, np.pi))
                  for h in (1, 2, 3))
        env = 0.6 + 0.4 * np.sin(2 * np.pi * 1.1 * t + i)
        utts.append((0.6 * sig * env / np.abs(sig).max()).astype(np.float32))
    return utts


def timed_long(bc, utts, batch_size: int) -> tuple:
    """(outputs, wall s, launches) of one convert_long_batch, the counts set
    to 0 just before and read just after; every output finite and exactly
    tgt_sr / 16 kHz times its input's length."""
    import numpy as np
    import torch

    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = bc.convert_long_batch(utts, chunk_seconds=CHUNK_S, pad_seconds=PAD_S,
                                 batch_size=batch_size)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    ratio = bc.rvc.cfg.data.sample_rate // 16000
    bad = [i for i, (u, o) in enumerate(zip(utts, outs))
           if len(o) != ratio * len(u) or not np.isfinite(o).all()]
    if bad or len(outs) != len(utts):
        raise AssertionError(f"long-form outputs {bad[:5]} are not finite or not "
                             f"{ratio} x their input's length")
    return outs, wall_s, launches


def phase_longform(rvc) -> dict:
    """The main path's model through BatchConverter: 64 x 60 s in 10 s
    windows with 1 s of context, 8 a dispatch (first call, wall,
    audio-seconds per second, peak memory, launches per dispatch); the
    first 16 at 1, 8 and 16 a dispatch; every kernel call of one B = 8
    dispatch against its plain version; one window at B = 8 against B = 1.
    Returns the timed run's launches."""
    import numpy as np
    import torch

    from rvc_tpu_torch.ops.kernels import record_calls
    from rvc_tpu_torch.parallel import BatchConverter

    p = rvc.pipeline
    p.source_noise = True
    bc = BatchConverter(rvc)
    t0 = time.perf_counter()
    utts = synth_utterances(LONG_UTTS, LONG_S)
    data_s = time.perf_counter() - t0
    windows = LONG_UTTS * math.ceil(LONG_S / CHUNK_S)
    dispatches = math.ceil(windows / LONG_BATCH)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bc.convert_long_batch(utts, chunk_seconds=CHUNK_S, pad_seconds=PAD_S,
                          batch_size=LONG_BATCH)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _, wall_s, launches = timed_long(bc, utts, LONG_BATCH)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_dispatch = {k: n / dispatches for k, n in launches.items()}
    if per_dispatch != LONG_LAUNCHES:
        raise AssertionError(f"{dispatches} dispatches launched {launches}: want "
                             f"{LONG_LAUNCHES} each")

    ab = {}
    for b in AB_BATCHES:
        bc.convert_long_batch(utts[:1], chunk_seconds=CHUNK_S, pad_seconds=PAD_S,
                              batch_size=b)                     # warm at this batch
        _, ab_s, _ = timed_long(bc, utts[:AB_UTTS], b)
        ab[b] = {"wall_s": ab_s, "audio_s_per_s": AB_UTTS * LONG_S / ab_s,
                 "dispatches": math.ceil(AB_UTTS * math.ceil(LONG_S / CHUNK_S) / b)}

    emit({"phase": "longform", "utterances": LONG_UTTS, "utterance_s": LONG_S,
          "chunk_s": CHUNK_S, "pad_s": PAD_S, "batch_size": LONG_BATCH,
          "cut": "none: 64 x 60 s as scripts/bench_longform.py",
          "windows": windows, "dispatches": dispatches, "data_s": data_s,
          "first_call_s": first_s, "wall_s": wall_s,
          "audio_s_per_s": LONG_UTTS * LONG_S / wall_s, "max_memory_gb": peak_gb,
          "launches": launches, "launches_per_dispatch": per_dispatch,
          "ab_first_16": ab})

    # one B = 8 dispatch: the first window of each of 8 utterances
    chunk, pad = int(CHUNK_S * 16000), int(PAD_S * 16000)
    batch = np.stack([np.pad(u, (pad, pad), mode="reflect")[:chunk + 2 * pad]
                      for u in utts[:LONG_BATCH]])
    stages = {}
    with torch.inference_mode():
        audio = torch.from_numpy(batch).to(rvc.device)
        stages["dispatch (convert_batch, deferred)"] = cuda_ms(
            lambda: bc.convert_batch(batch, defer=True))
        stages["f0 program"] = cuda_ms(lambda: p.f0(audio, 0.0, 0.0))
        stages["HuBERT"] = cuda_ms(lambda: p.hubert(audio, output_hidden_states=True))
    t0 = time.perf_counter()
    with record_calls() as calls:
        bc.convert_batch(batch)
    held = held_calls(calls)
    del calls
    check_s = time.perf_counter() - t0

    # rows do not mix: one window at B = 8 against the same window alone
    p.source_noise = False
    row = min(3, len(batch) - 1)
    together = bc.convert_batch(batch)[row]
    alone = bc.convert_batch(batch[row:row + 1])[0]
    p.source_noise = True
    rows = {"row": row, "max_abs": float(np.abs(together - alone).max()),
            "corr": float(np.corrcoef(together, alone)[0, 1])}
    if not rows["corr"] > 0.9999:
        raise AssertionError(f"a window at B = 8 against B = 1: {rows}")
    emit({"phase": "longform_b8", "batch_size": LONG_BATCH, "window_samples": batch.shape[1],
          "dispatch_ms": stages, "checked": held, "check_s": check_s, "b8_vs_b1": rows})
    return launches


# ---------------------------------------------------------------------------
# realtime: VoiceChanger block by block, the pool, the TCP server
# ---------------------------------------------------------------------------

RT_WARM, RT_BLOCKS = 3, 40            # 40 blocks of 512 ms: 20.5 s of the chirp
RT_INDEX_BLOCKS = 10
RT_BUDGET_MS = 512.0                  # one block of 192 x 128 samples at 48 kHz
RT_GATE_DB = -90                      # the reference's default of 0 dB gates RMS < 1
POOL_NS, POOL_STEPS = (1, 4, 16), 8
TCP_BLOCKS = 10
RT_LAUNCHES = {"resblock_group": 27, "resblock_chain": 9, "rel_attention": 6, "log_mel": 1,
               "resblock_group_tp": 0, "resblock_chain_tp": 0}


def rt_clip48(n_blocks: int, block: int, seed: int):
    """The test chirp (`test_clip`) at 48 kHz, n_blocks blocks long."""
    from rvc_tpu_torch.utils import audio as audio_utils

    seconds = n_blocks * block / 48000
    return audio_utils.resample(test_clip(seconds, seed), 16000, 48000)[: n_blocks * block]


def percentiles(ms: list) -> dict:
    import numpy as np

    return {"median": float(np.median(ms)), "p95": float(np.percentile(ms, 95)),
            "max": float(np.max(ms))}


def stream_blocks(vc, clip, n_warm: int, n: int, **kwargs) -> tuple:
    """(per-block on_request ms, outputs, launches per block) of n blocks
    after n_warm, the counts set to 0 just before the n and read just
    after; every output finite and block_frame long."""
    import numpy as np

    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    bf = vc.block_frame
    for i in range(n_warm):
        vc.on_request(clip[i * bf: (i + 1) * bf], **kwargs)
    reset_launches()
    ms, outs = [], []
    for i in range(n_warm, n_warm + n):
        out, _, timings = vc.on_request(clip[i * bf: (i + 1) * bf], **kwargs)
        if out.shape != (bf,) or not np.isfinite(out).all():
            raise AssertionError(f"block {i}: {out.shape}, finite={np.isfinite(out).all()}")
        ms.append(timings[1])
        outs.append(out)
    launches = {k: v / n for k, v in LAUNCHES.items()}
    return ms, outs, launches


def block_stages(vc) -> dict:
    """Ms (median CUDA events around one call, the host's launch work
    included) of the block program and of its stages on the session's
    buffer, each stage's trace (kernels, busy ms); host ms of the host's
    parts."""
    import numpy as np
    import torch

    from rvc_tpu_torch.pipelines.offline import coarse_f0_torch
    from rvc_tpu_torch.realtime.core import sola_offset_scipy
    from rvc_tpu_torch.utils import audio as audio_utils
    from rvc_tpu_torch.utils.device import to_device

    rt = vc.vc_model
    p = rt.rvc.pipeline
    fn = rt._get_block_program(False)
    L, F = len(rt.convert_buffer), rt.convert_feature_size
    buf = np.pad(rt.convert_buffer, (0, rt._block_pad), mode="reflect")
    st = {}
    with torch.inference_mode():
        audio = to_device(buf[None], p.device)
        state, sid = rt._pitchf_dev, rt._sid_dev
        tail = audio[:, rt.silence_front_frames * 160: L]
        st["block program"] = cuda_ms(lambda: fn(audio, state, sid, 0.5, 0.0, 0.0))
        st["  tail f0 (K4, RMVPE)"] = cuda_ms(lambda: p.f0(tail, 0.0, 0.0))
        st["  HuBERT"] = cuda_ms(lambda: p.hubert(audio, output_hidden_states=True))
        feats = p.hubert(audio, output_hidden_states=True)
        t_feat = feats.shape[1] * 2
        pf = torch.nn.functional.pad(state[:, :t_feat], (0, max(0, t_feat - F)))
        lengths = torch.full((1,), min(F, t_feat), device=p.device)
        st["  synthesizer (K3, K1, K2)"] = cuda_ms(
            lambda: p._synthesize(feats, feats, lengths, sid, 0.5, coarse_f0_torch(pf), pf))
        traces = {"tail f0": trace_one(lambda: p.f0(tail, 0.0, 0.0)),
                  "HuBERT": trace_one(lambda: p.hubert(audio, output_hidden_states=True)),
                  "synthesizer": trace_one(lambda: p._synthesize(
                      feats, feats, lengths, sid, 0.5, coarse_f0_torch(pf), pf))}
    block48 = np.zeros(vc.block_frame, np.float32)
    conv = np.random.default_rng(SEED).standard_normal(
        vc.crossfade_frame + vc.sola_search_frame).astype(np.float32)

    def host_ms(f, reps: int = 20) -> float:
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            f()
            ts.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(ts))

    def upload():
        to_device(buf[None], p.device)
        torch.cuda.synchronize()

    host = {"resample 48k -> 16k": host_ms(lambda: audio_utils.resample(block48, 48000, 16000)),
            "reflect pad": host_ms(lambda: np.pad(rt.convert_buffer, (0, rt._block_pad),
                                                  mode="reflect")),
            "upload (pinned, synchronised)": host_ms(upload),
            "SOLA (scipy)": host_ms(lambda: sola_offset_scipy(conv, vc.sola_buffer))}
    return {"device_ms": st, "traces": traces, "host_ms": host, "t_feat": t_feat}


def trace_one(fn, top: int = 0) -> dict:
    """torch.profiler over one fn() and a synchronize: the CUDA kernels and
    copies it ran, their busy ms, the span from the first to the last, and
    with top > 0 the top kernels by busy ms ({name: [count, ms]})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"note": "the trace holds no device events: not measured"}
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in dev if e not in copies]
    out = {"cuda_kernels": len(kernels), "copies": len(copies),
           "kernel_busy_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
           "device_span_ms": (max(e.time_range.end for e in dev)
                              - min(e.time_range.start for e in dev)) / 1e3,
           "copy_ms": sum(e.time_range.elapsed_us() for e in copies) / 1e3}
    if top:
        by_name = {}
        for e in kernels:
            key = e.name.replace("(anonymous namespace)::", "")
            name = re.match(r"(?:void\s+)?(?:[\w:]*::)?(\w+)", key).group(1)
            c = by_name.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us() / 1e3
        out["top_kernels"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top])
    return out


def tcp_round_trip(rvc, blocks) -> dict:
    """RealtimeSocketServer on 127.0.0.1 at a free port with a per-connection
    VoiceChanger: the blocks round trip over one connection (ms each, the
    client's clock); the replies against an in-process VoiceChanger fed the
    same blocks (max |d| <= 1e-4)."""
    import asyncio
    import socket
    import struct

    import numpy as np

    from rvc_tpu_torch.realtime.core import VoiceChanger
    from rvc_tpu_torch.realtime.server import RealtimeSocketServer

    def factory():
        return VoiceChanger(rvc, silent_threshold=RT_GATE_DB)

    srv = RealtimeSocketServer(vc_factory=factory, index_rate=0.0)

    def client(port):
        outs, ms = [], []
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            for b in blocks:
                data = np.asarray(b, "<f4").tobytes()
                t0 = time.perf_counter()
                s.sendall(struct.pack("<I", len(data)) + data)
                (n,) = struct.unpack("<I", s.recv(4, socket.MSG_WAITALL))
                buf = b""
                while len(buf) < n:
                    buf += s.recv(n - len(buf))
                ms.append(1e3 * (time.perf_counter() - t0))
                outs.append(np.frombuffer(buf, dtype="<f4"))
            s.sendall(struct.pack("<I", 0))
        return outs, ms

    async def run():
        server = await asyncio.start_server(srv._handle, "127.0.0.1", 0)
        try:
            port = server.sockets[0].getsockname()[1]
            return port, await asyncio.get_running_loop().run_in_executor(None, client, port)
        finally:
            server.close()
            await server.wait_closed()

    port, (outs, ms) = asyncio.run(asyncio.wait_for(run(), timeout=300))
    vc = factory()
    ref = [vc.on_request(b, index_rate=0.0)[0] for b in blocks]
    max_abs = max(float(np.abs(o - r).max()) for o, r in zip(outs, ref))
    if not max_abs <= 1e-4 or any(o.shape != r.shape for o, r in zip(outs, ref)):
        raise AssertionError(f"TCP replies against the in-process engine: max |d| {max_abs}")
    return {"port": port, "blocks": len(blocks), "ms": percentiles(ms[1:]),
            "first_block_ms": ms[0], "max_abs_vs_in_process": max_abs}


def phase_realtime(rvc, cpu_rvc, index_path: str) -> dict:
    """The realtime engine on the main path's model at the reference's
    session defaults (read_chunk_size 192, crossfade 0.1 s, extra 0.5 s,
    rmvpe, the fused block path; the gate at -90 dB). Returns {path:
    launches per block (per step for the pool at its largest N)}."""
    import numpy as np
    import torch

    from rvc_tpu_torch.ops.kernels import LAUNCHES, record_calls, reset_launches
    from rvc_tpu_torch.realtime.core import VoiceChanger
    from rvc_tpu_torch.realtime.pool import VoiceChangerPool
    from rvc_tpu_torch.retrieval import read_faiss_index

    p = rvc.pipeline
    p.source_noise = True
    vc = VoiceChanger(rvc, silent_threshold=RT_GATE_DB)
    rt, bf = vc.vc_model, vc.block_frame
    clip = rt_clip48(RT_WARM + RT_BLOCKS, bf, SEED)
    t0 = time.perf_counter()
    vc.on_request(clip[:bf], index_rate=0.0)
    first_ms = 1e3 * (time.perf_counter() - t0)
    ms, outs, launches = stream_blocks(vc, clip, RT_WARM, RT_BLOCKS, index_rate=0.0)
    if launches != RT_LAUNCHES:
        raise AssertionError(f"a block launched {launches}: want {RT_LAUNCHES}")
    if not np.median(ms) < RT_BUDGET_MS:
        raise AssertionError(f"median block {np.median(ms)} ms over the {RT_BUDGET_MS} budget")
    geometry = {"block_48k": bf, "convert_16k": len(rt.convert_buffer),
                "padded_16k": len(rt.convert_buffer) + rt._block_pad,
                "F": rt.convert_feature_size, "skip_head": rt.skip_head,
                "return_length": rt.return_length, "silence_front": rt.silence_front_frames}
    stages = block_stages(vc)
    prof = trace_one(lambda: vc.on_request(clip[:bf], index_rate=0.0), top=10)
    with record_calls() as calls:
        rt.inference(clip[bf: 2 * bf], index_rate=0.0)
    t0 = time.perf_counter()
    held = held_calls(calls, time_them=True)
    check_s = time.perf_counter() - t0
    del calls
    emit({"phase": "realtime", "session": "VoiceChanger(rvc, silent_threshold=-90): "
          "read_chunk_size 192, crossfade 0.1 s, extra 0.5 s, rmvpe, fused",
          "geometry": geometry, "first_block_ms": first_ms, "blocks": RT_BLOCKS,
          "on_request_ms": percentiles(ms), "budget_ms": RT_BUDGET_MS,
          "realtime_x": RT_BUDGET_MS / float(np.median(ms)),
          "launches_per_block": launches, "stages": stages, "profile_one_block": prof,
          "kernels_one_block": held, "check_s": check_s,
          "peak": float(max(np.abs(o).max() for o in outs))})

    # checks: staged against fused, silence, the card against the host
    p.source_noise = False
    checks = {}
    eng = {k: VoiceChanger(rvc, silent_threshold=RT_GATE_DB).vc_model for k in ("0", "1")}
    corr = []
    for i in range(4):
        b = clip[i * bf: (i + 1) * bf]
        got = {}
        for k, e in eng.items():
            os.environ["RVC_TPU_RT_FUSED"] = k
            got[k] = e.inference(b, index_rate=0.0)[0]
        os.environ["RVC_TPU_RT_FUSED"] = "1"
        corr.append(float(np.corrcoef(got["0"], got["1"])[0, 1]))
        max_abs = float(np.abs(got["0"] - got["1"]).max())
        if not (corr[-1] > 0.999 and max_abs <= 5e-3):
            raise AssertionError(f"block {i}: staged against fused corr {corr[-1]}, "
                                 f"max |d| {max_abs}")
    checks["staged_vs_fused"] = {"blocks": 4, "min_corr": min(corr), "max_abs_last": max_abs}

    sil = VoiceChanger(rvc, silent_threshold=RT_GATE_DB)
    zeros = np.zeros(bf, np.float32)
    sil.on_request(clip[:bf], index_rate=0.0)
    sil.on_request(zeros, index_rate=0.0)        # the volume window still holds speech
    before = dict(LAUNCHES)
    silent_ms = []
    for _ in range(3):            # the engine's blocks: SOLA fades the last sound out
        t0 = time.perf_counter()
        out, vol = sil.vc_model.inference(zeros, index_rate=0.0)
        silent_ms.append(1e3 * (time.perf_counter() - t0))
        if out.any() or vol != 0.0:
            raise AssertionError("a silent block gave sound")
    if dict(LAUNCHES) != before:
        raise AssertionError(f"silent blocks launched {dict(LAUNCHES)} after {before}")
    owed = sil.vc_model._pending_zero_frames
    resumed = sil.on_request(clip[bf: 2 * bf], index_rate=0.0)[0]
    if dict(LAUNCHES) == before or not np.isfinite(resumed).all():
        raise AssertionError("the speech block after the silence did not convert")
    checks["silence"] = {"silent_blocks": 3, "launches_during": 0, "owed_frames": owed,
                         "silent_ms": silent_ms, "resumed_finite": True}

    gpu, cpu = (VoiceChanger(r, silent_threshold=RT_GATE_DB).vc_model for r in (rvc, cpu_rvc))
    t0 = time.perf_counter()
    corr = []
    for i in range(4):
        b = clip[i * bf: (i + 1) * bf]
        g, c = gpu.inference(b, index_rate=0.0)[0], cpu.inference(b, index_rate=0.0)[0]
        corr.append(float(np.corrcoef(g, c)[0, 1]))
        if not corr[-1] > 0.99:
            raise AssertionError(f"block {i}: the card against the host, corr {corr[-1]}")
    checks["gpu_vs_cpu"] = {"blocks": 4, "min_corr": min(corr), "cpu_seconds":
                            time.perf_counter() - t0}
    p.source_noise = True

    # retrieval: the retrieval phase's 60,000-vector index at index_rate 0.75,
    # beside a fresh engine without it on the same blocks just before
    pms, _, _ = stream_blocks(VoiceChanger(rvc, silent_threshold=RT_GATE_DB), clip, RT_WARM,
                              RT_INDEX_BLOCKS, index_rate=0.0)
    rvc.index = read_faiss_index(index_path)
    vci = VoiceChanger(rvc, silent_threshold=RT_GATE_DB)
    ims, _, ilaunches = stream_blocks(vci, clip, RT_WARM, RT_INDEX_BLOCKS, index_rate=INDEX_RATE)
    rvc.index = None
    if ilaunches != RT_LAUNCHES:
        raise AssertionError(f"a retrieval block launched {ilaunches}")
    checks["retrieval"] = {"index_vectors": INDEX_N, "index_rate": INDEX_RATE,
                           "blocks": RT_INDEX_BLOCKS, "on_request_ms": percentiles(ims),
                           "plain_on_request_ms": percentiles(pms),
                           "added_median_ms": float(np.median(ims) - np.median(pms)),
                           "launches_per_block": ilaunches}

    # the pool: N streams, one batched block program a step
    pool_out = {}
    for n in POOL_NS:
        pool = VoiceChangerPool(rvc, n, sids=[s % 2 for s in range(n)],
                                silent_threshold=RT_GATE_DB)
        streams = np.stack([np.roll(clip, 4801 * s) * (0.6 + 0.05 * (s % 8))
                            for s in range(n)])
        for i in range(2):
            pool.process(streams[:, i * bf: (i + 1) * bf])
        torch.cuda.synchronize()
        reset_launches()
        step_ms = []
        for i in range(2, 2 + POOL_STEPS):
            t0 = time.perf_counter()
            out, _ = pool.process(streams[:, i * bf: (i + 1) * bf])
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if out.shape != (n, bf) or not np.isfinite(out).all():
                raise AssertionError(f"pool N = {n}: {out.shape}")
        per_step = {k: v / POOL_STEPS for k, v in LAUNCHES.items()}
        if per_step != RT_LAUNCHES:
            raise AssertionError(f"pool N = {n}: a step launched {per_step}")
        med = float(np.median(step_ms))
        pool_out[n] = {"step_ms": percentiles(step_ms), "launches_per_step": per_step,
                       "realtime_streams_per_card": n * RT_BUDGET_MS / med}
        if n == POOL_NS[-1]:      # every kernel call of one step at the largest batch
            with record_calls() as calls:
                pool.process(streams[:, 2 * bf: 3 * bf])
            pool_out[n]["kernels_one_step"] = held_calls(calls)
            del calls
        del pool
    checks["tcp"] = tcp_round_trip(rvc, [clip[i * bf: (i + 1) * bf] for i in range(TCP_BLOCKS)])
    emit({"phase": "realtime_checks", **checks, "pool": pool_out})
    return {"realtime": launches, "realtime_pool": pool_out[POOL_NS[-1]]["launches_per_step"]}


# ---------------------------------------------------------------------------
# train: preprocess -> extract -> RVCTrainer at full width, the step timed
# ---------------------------------------------------------------------------

TRAIN_SPEAKERS, TRAIN_UTTS, TRAIN_UTT_S = 2, 3, 10.0     # 2 x 3 utterances of 10 s
TRAIN_BATCH, TRAIN_EPOCHS = 8, 2
TRAIN_WARM, TRAIN_TIMED = 3, 20
TRAIN_DESCENT_STEPS = 30                                  # warmup mode, one fixed batch
TRAIN_VOCODER_STEPS = 2
TRAIN_PARITY_B = 2
TRAIN_LAUNCHES = {"resblock_group": 27, "resblock_chain": 9, "rel_attention": 6, "log_mel": 0,
                  "resblock_group_tp": 0, "resblock_chain_tp": 0}
TRAIN_GRAD_BAR = 1e-5          # each Function's gradients against the plain autograd's
TRAIN_DEVICE = "cuda"          # a CPU rehearsal sets "cpu" and shrinks TRAIN_CFG
TRAIN_CFG = {}                 # get_config(48000, ...) overrides; none: full width


def make_dataset(root: str) -> str:
    """TRAIN_SPEAKERS folders of TRAIN_UTTS seeded harmonic utterances at 48 kHz."""
    from rvc_tpu_torch.utils import audio as audio_utils

    utts = synth_utterances(TRAIN_SPEAKERS * TRAIN_UTTS, TRAIN_UTT_S, sr=48000)
    data = os.path.join(root, "dataset")
    for i, u in enumerate(utts):
        d = os.path.join(data, str(i // TRAIN_UTTS))
        os.makedirs(d, exist_ok=True)
        audio_utils.save_wav(os.path.join(d, f"take{i % TRAIN_UTTS}.wav"), u, 48000)
    return data


def train_split(step, batch, generator) -> dict:
    """One adversarial step split by CUDA events: G forward (the losses), G
    backward (the sanitized gradients), G's optimizer, D forward and
    backward, D's optimizer (ms each)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    ev[0].record()
    step.net_d.requires_grad_(False)
    total, _, y_hat, real = step.g_losses(batch, generator)
    ev[1].record()
    grads = step.g_grads(total)
    step.net_d.requires_grad_(True)
    ev[2].record()
    step.g_opt.step(grads)
    ev[3].record()
    loss = step.d_loss(real.detach(), y_hat.detach())
    d_grads = torch.autograd.grad(loss, step.d_opt.params)
    ev[4].record()
    step.d_opt.step(d_grads)
    ev[5].record()
    ev[5].synchronize()
    names = ("G forward", "G backward", "G optimizer", "D forward + backward", "D optimizer")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def timed_steps(step, batch, generator, warm: int, n: int) -> tuple:
    """(host ms of each of n steps after warm, every metric of them, the
    launches of one step, peak memory GB); each step ends in a synchronize."""
    import torch

    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    for _ in range(warm):
        step(batch, generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], []
    for i in range(n):
        if i == 0:
            reset_launches()
        t0 = time.perf_counter()
        m = step(batch, generator)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            launches = dict(LAUNCHES)
        metrics.append({k: float(v) for k, v in m.items()})
    return ms, metrics, launches, torch.cuda.max_memory_allocated() / 1e9


def check_finite(metrics: list, what: str) -> None:
    bad = [(i, k, v) for i, m in enumerate(metrics) for k, v in m.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: losses not finite {bad[:5]}")


def function_gradients(calls: list) -> dict:
    """Each recorded K1-K3 call of a training step through its autograd
    Function and through the plain version's autograd on the same upstream
    gradient (zero on K3's garbage rows): the worst rel_l2 per kernel over
    every input and weight gradient (raises past TRAIN_GRAD_BAR)."""
    import importlib

    import torch

    out = {}
    for fn, args, kwargs in calls:
        name = fn.__name__
        plain = getattr(importlib.import_module(
            f"rvc_tpu_torch.ops.kernels.{KERNELS[name]['module']}"), name + "_reference")
        a = inspect.signature(fn).bind(*args, **kwargs)
        a.apply_defaults()
        a = dict(a.arguments)
        keys = ["x", "weights"] if name == "resblock_group" else (
            ["x", "w1", "b1", "w2", "b2"] if name == "resblock_chain" else
            ["q", "k", "v", "emb_rel_k", "emb_rel_v"])

        def leaves():
            flat = []
            for k in keys:
                v = a[k]
                if isinstance(v, tuple):
                    flat += [t.detach().clone().requires_grad_() for t in v]
                else:
                    flat.append(v.detach().clone().requires_grad_())
            return flat

        def call(f, flat):
            kw = dict(a)
            if name == "resblock_group":
                kw["x"], kw["weights"] = flat[0], tuple(flat[1:])
            else:
                kw.update(zip(keys, flat))
            return f(**kw)

        got_leaves, ref_leaves = leaves(), leaves()
        y = call(fn, got_leaves)
        g = torch.randn(y.shape, device=y.device,
                        generator=torch.Generator(y.device).manual_seed(SEED))
        if name == "rel_attention":
            T = y.shape[2]
            g = g * (torch.arange(T, device=y.device)[None, :]
                     < a["key_lens"].to(y.device)[:, None])[:, None, :, None]
        got = torch.autograd.grad(y, got_leaves, g)
        ref = torch.autograd.grad(call(plain, ref_leaves), ref_leaves, g)
        worst = max(rel_l2(x, r) for x, r in zip(got, ref))
        h = out.setdefault(name, {"calls": 0, "grads": 0, "max_rel_l2": 0.0})
        h["calls"] += 1
        h["grads"] += len(got)
        h["max_rel_l2"] = max(h["max_rel_l2"], worst)
        if not worst < TRAIN_GRAD_BAR:
            raise AssertionError(f"{name}: a gradient is {worst} (rel_l2) off the plain "
                                 f"version's autograd (bar {TRAIN_GRAD_BAR})")
    return out


def step_grads(cfg, net_g, net_d, batch, draws) -> tuple:
    """One adversarial step's losses and gradients (per G module, and D)
    without the update: the port's TrainStep pieces."""
    import torch

    from rvc_tpu_torch.train.train_step import TrainStep, make_optimizers

    g_opt, d_opt = make_optimizers(cfg, net_g, net_d)
    step = TrainStep(cfg, net_g, net_d, g_opt, d_opt)
    total, losses, y_hat, real = step.g_losses(batch, **draws)
    by_module = {}
    names = [n for n, _ in net_g.named_parameters()]
    for n, gr in zip(names, step.g_grads(total)):
        by_module.setdefault(n.split(".")[0], []).append(gr.detach().flatten().cpu())
    d_loss = step.d_loss(real.detach(), y_hat.detach())
    by_module["D"] = [gr.flatten().cpu() for gr in torch.autograd.grad(d_loss, d_opt.params)]
    losses = {k: float(v.detach()) for k, v in losses.items()}
    losses.update(loss_d=float(d_loss.detach()), loss_g_total=float(total.detach()))
    return losses, {k: torch.cat(v).double() for k, v in by_module.items()}


@contextlib.contextmanager
def bf16_host():
    """The decoder's K1/K2 calls on host tensors take the card's arithmetic:
    their autograd Functions with the plain version's bf16 emulation as the
    forward (bf16 conv operands, float32 sums) and the float32 plain
    autograd as the backward."""
    from rvc_tpu_torch.models import generators, layers
    from rvc_tpu_torch.ops.kernels import resblock as KR

    def group(x, weights, kernel_sizes, dilations, slope=0.1):
        return KR.GroupFunction.apply(
            functools.partial(KR.resblock_group_reference, bf16_operands=True),
            tuple(kernel_sizes), tuple(map(tuple, dilations)), slope, x, *weights)

    def chain(x, w1, b1, w2, b2, kernel_size, dilations=(1, 3, 5), slope=0.1):
        return KR.ChainFunction.apply(
            functools.partial(KR.resblock_chain_reference, bf16_operands=True),
            kernel_size, tuple(dilations), slope, x, w1, b1, w2, b2)

    saved = generators.resblock_group, layers.resblock_chain
    generators.resblock_group, layers.resblock_chain = group, chain
    try:
        yield
    finally:
        generators.resblock_group, layers.resblock_chain = saved


def train_vs_host(cfg, seed: int) -> dict:
    """One full-width G+D step at batch TRAIN_PARITY_B on the card against
    the port's CPU step: the same parameters, batch and handed draws. Each
    loss within rel 2e-2 (K1/K2's bf16 forward) and gradient corr > 0.99
    for enc_p, enc_q, flow, dec and D against the CPU step run with the
    card's arithmetic (`bf16_host`); against the float32 CPU step the
    losses within rel 2e-2 and corr > 0.99 for every module but the
    decoder, whose corr is reported beside that of the CPU's own bf16 step
    against its float32 one (the bf16 forward's share)."""
    import copy

    import numpy as np
    import torch

    from rvc_tpu_torch.models.discriminators import build_discriminator
    from rvc_tpu_torch.models.synthesizer import build_synthesizer
    from rvc_tpu_torch.train.train_step import Batch

    torch.manual_seed(seed)
    nets = build_synthesizer(cfg, training=True), build_discriminator(cfg)
    rng = np.random.default_rng(seed)
    B, T, hop, seg = TRAIN_PARITY_B, 60, cfg.data.hop_length, cfg.segment_frames
    t = np.arange(T * hop) / cfg.data.sample_rate
    batch = Batch(torch.from_numpy(rng.standard_normal((B, T, 768)).astype(np.float32)),
                  torch.tensor([T, T - 10]), torch.from_numpy(rng.integers(1, 255, (B, T))),
                  torch.full((B, T), 180.0),
                  torch.from_numpy(np.abs(rng.standard_normal(
                      (B, T, cfg.data.spec_channels))).astype(np.float32)),
                  torch.tensor([T, T - 10]),
                  torch.from_numpy(np.stack([0.3 * np.sin(2 * np.pi * f * t) for f in
                                             (150, 220)]).astype(np.float32)),
                  torch.tensor([0, 1]))
    draws = dict(eps=torch.from_numpy(rng.standard_normal(
                     (B, T, cfg.model.inter_channels)).astype(np.float32)),
                 ids_slice=torch.tensor([10, 3]),
                 source_noise=torch.from_numpy(rng.standard_normal(
                     (B, seg * hop, 1)).astype(np.float32)))
    t0 = time.perf_counter()
    host = step_grads(cfg, *copy.deepcopy(nets), batch, draws)
    host_s = time.perf_counter() - t0
    with bf16_host():
        host_bf16 = step_grads(cfg, *copy.deepcopy(nets), batch, draws)
    card = step_grads(cfg, *(n.to(TRAIN_DEVICE) for n in nets), batch.to(TRAIN_DEVICE),
                      {k: v.to(TRAIN_DEVICE) for k, v in draws.items()})

    def corr(a, b):
        return {k: float(torch.corrcoef(torch.stack([a[1][k], b[1][k]]))[0, 1])
                for k in ("enc_p", "enc_q", "flow", "dec", "D")}

    def rel(a, b):
        return {k: abs(a[0][k] - v) / max(abs(v), 1e-12) for k, v in b[0].items()}

    out = {"losses_card": card[0], "losses_host_f32": host[0],
           "losses_host_bf16": host_bf16[0], "loss_rel_vs_bf16": rel(card, host_bf16),
           "loss_rel_vs_f32": rel(card, host), "grad_corr_vs_bf16": corr(card, host_bf16),
           "grad_corr_vs_f32": corr(card, host), "host_bf16_vs_f32": corr(host_bf16, host),
           "host_s": host_s}
    ok = (all(r < 2e-2 for r in out["loss_rel_vs_bf16"].values())
          and all(r < 2e-2 for r in out["loss_rel_vs_f32"].values())
          and all(c > 0.99 for c in out["grad_corr_vs_bf16"].values())
          and all(c > 0.99 for k, c in out["grad_corr_vs_f32"].items() if k != "dec"))
    if not ok:
        raise AssertionError(f"the card's train step against the host's: {out}")
    return out


def phase_train(work: str) -> dict:
    """Make a voice model the way users do, at the 48 kHz model's full width:
    the port's AudioPreprocessor, FeatureExtractor (K4 on the card) and
    DatasetBuilder on a seeded dataset, RVCTrainer for TRAIN_EPOCHS epochs,
    a save and a resume, the export converting a 2 s clip; then the step
    timed and split, traced, its launches, the MRF / RefineGAN steps, the
    descent check, the Functions' gradients and the card against the host.
    Returns {path: launches}: `extract` over the whole extraction,
    `train_step` per step."""
    import numpy as np
    import torch

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.ops.kernels import LAUNCHES, record_calls, reset_launches
    from rvc_tpu_torch.preprocess import AudioPreprocessor, DatasetBuilder, FeatureExtractor
    from rvc_tpu_torch.train.data import DataLoader, RVCDataset
    from rvc_tpu_torch.train.trainer import RVCTrainer

    cfg = get_config(48000, train_batch_size=TRAIN_BATCH, **TRAIN_CFG)
    exp = os.path.join(work, "logs", "voice")
    times = {}
    t0 = time.perf_counter()
    data = make_dataset(work)
    n_seg = AudioPreprocessor(exp, 48000).process_directory(data, "Automatic", chunk_len=3.0)
    times["preprocess_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe = FeatureExtractor(exp, cfg, device=TRAIN_DEVICE)
    times["extractor_init_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    n_feat = fe.process_all(batch_size=TRAIN_BATCH)
    builder = DatasetBuilder(exp)
    train_rows, val_rows = builder.build()
    train_rows += builder.add_mutes(cfg, 2, feature_extractor=fe)
    builder.write_filelist(os.path.join(exp, "filelist_train.txt"), train_rows)  # for `train`
    torch.cuda.synchronize()
    times["extract_s"] = time.perf_counter() - t0
    extract_launches = dict(LAUNCHES)
    if n_feat != n_seg or extract_launches["log_mel"] < 1:
        raise AssertionError(f"extract: {n_feat} of {n_seg} segments, launches "
                             f"{extract_launches}")
    del fe
    loader = DataLoader(RVCDataset(train_rows, cfg.data.hop_length), TRAIN_BATCH)
    ckpt = os.path.join(exp, "ckpt")
    t0 = time.perf_counter()
    trainer = RVCTrainer(cfg, loader, checkpoint_dir=ckpt, seed=SEED, device=TRAIN_DEVICE,
                         model_name="voice")
    times["trainer_init_s"] = time.perf_counter() - t0
    batch = next(iter(loader)).to(TRAIN_DEVICE)
    trainer.eval_batch = type(batch)(*(x[:1] for x in batch))
    t0 = time.perf_counter()
    result = trainer.train(TRAIN_EPOCHS, save_every=TRAIN_EPOCHS)
    times["train_s"] = time.perf_counter() - t0
    history = result["history"]
    check_finite([{k: v for k, v in h.items() if k.startswith(("loss", "grad"))}
                  for h in history], "the trainer's epochs")

    resumed = RVCTrainer(cfg, loader, checkpoint_dir=ckpt, seed=SEED + 1, device=TRAIN_DEVICE,
                         model_name="voice")
    resumed.resume("last")
    same = all(torch.equal(a, b) for net in ("net_g", "net_d") for a, b in zip(
        getattr(trainer, net).state_dict().values(), getattr(resumed, net).state_dict().values()))
    same_opt = all(torch.equal(a, b) for a, b in zip(trainer.g_opt.mu + trainer.d_opt.nu,
                                                      resumed.g_opt.mu + resumed.d_opt.nu))
    if not (same and same_opt and resumed.epoch == trainer.epoch
            and resumed.step == trainer.step):
        raise AssertionError(f"resume: params {same}, moments {same_opt}, epoch "
                             f"{resumed.epoch}/{trainer.epoch}, step {resumed.step}/{trainer.step}")
    del resumed
    pth = trainer.export_inference_model(os.path.join(exp, "voice.pth"))
    rvc = RVC(model_path=pth, device=TRAIN_DEVICE, seed=SEED)
    clip = test_clip(PARITY_S, SEED + 2)
    out = rvc.infer(clip)
    if len(out) != int(PARITY_S * 48000) or not np.isfinite(out).all():
        raise AssertionError(f"the exported model converted {len(out)} samples "
                             f"(want {int(PARITY_S * 48000)}), finite={np.isfinite(out).all()}")
    del rvc
    emit({"phase": "train", "config": f"get_config(48000, train_batch_size={TRAIN_BATCH}, "
                                      f"**{TRAIN_CFG}), random init from seed {SEED}",
          "dataset": {"speakers": TRAIN_SPEAKERS, "utterances": TRAIN_SPEAKERS * TRAIN_UTTS,
                      "seconds_each": TRAIN_UTT_S, "segments": n_seg,
                      "rows_train": len(train_rows), "rows_val": len(val_rows),
                      "batches_per_epoch": history[0]["batches"]},
          "times": times, "extract_launches": extract_launches,
          "epochs": [{k: h[k] for k in ("epoch", "batches", "loss_g_total", "loss_mel",
                                         "loss_d", "seconds")} for h in history],
          "resume": "params, moments, epoch and step equal",
          "export": {"path": os.path.basename(pth), "converted_samples": len(out),
                     "peak": float(np.abs(out).max())}})

    # the step on one batch: timed, split, traced, launches, memory
    step = trainer.step_fn(True)
    gen = trainer.generator
    ms, metrics, launches, peak_gb = timed_steps(step, batch, gen, TRAIN_WARM, TRAIN_TIMED)
    check_finite(metrics, "the timed steps")
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"a train step launched {launches}: want {TRAIN_LAUNCHES}")
    split = {k: float(np.median([s[k] for s in [train_split(step, batch, gen)
                                                 for _ in range(3)]]))
             for k in ("G forward", "G backward", "G optimizer", "D forward + backward",
                       "D optimizer")}
    trainer.net_g.checkpointing = True
    reset_launches()
    step(batch, gen)
    torch.cuda.synchronize()
    ckpt_launches = dict(LAUNCHES)
    trainer.net_g.checkpointing = False
    want = {k: (2 * n if k in ("resblock_group", "resblock_chain") else n)
            for k, n in TRAIN_LAUNCHES.items()}
    if ckpt_launches != want:
        raise AssertionError(f"a checkpointing step launched {ckpt_launches}: want {want}")
    prof = trace_one(lambda: step(batch, gen), top=10)
    if "kernel_busy_ms" in prof:
        prof["idle_share_of_span"] = 1 - prof["kernel_busy_ms"] / prof["device_span_ms"]
    seg_s = TRAIN_BATCH * cfg.train.segment_size / cfg.data.sample_rate
    med = float(np.median(ms))
    emit({"phase": "train_step", "batch": TRAIN_BATCH, "frames": batch.spec.shape[1],
          "segment_samples": cfg.train.segment_size, "warm": TRAIN_WARM, "steps": TRAIN_TIMED,
          "step_ms": percentiles(ms), "steps_per_s": 1e3 / med,
          "segment_audio_s_per_s": seg_s * 1e3 / med, "split_ms": split,
          "launches": launches, "launches_checkpointing": ckpt_launches,
          "max_memory_gb": peak_gb, "trace": prof,
          "busy_share_of_median_step": prof.get("kernel_busy_ms", math.nan) / med,
          "last_metrics": metrics[-1]})

    # warmup mode on one fixed batch (the segment starts fixed too): the mel loss falls
    descent = trainer.step_fn(False)
    ids = torch.zeros(TRAIN_BATCH, dtype=torch.long, device=TRAIN_DEVICE)
    mel = [float(descent(batch, gen, ids_slice=ids)["loss_mel"])
           for _ in range(TRAIN_DESCENT_STEPS)]
    first, last = float(np.mean(mel[:5])), float(np.mean(mel[-5:]))
    if not (all(map(math.isfinite, mel)) and last < first):
        raise AssertionError(f"warmup-mode mel loss did not fall: {mel}")

    with record_calls() as calls:
        step(batch, gen)
    held = held_calls(calls)
    grads = function_gradients(calls)
    del calls
    parity = train_vs_host(get_config(48000, train_batch_size=TRAIN_PARITY_B, **TRAIN_CFG), SEED)
    emit({"phase": "train_checks", "descent": {"steps": TRAIN_DESCENT_STEPS,
                                               "mean_first_5": first, "mean_last_5": last,
                                               "loss_mel": mel},
          "forwards_held": held, "function_gradients": grads,
          "function_gradient_bar": f"rel_l2 < {TRAIN_GRAD_BAR}", "card_vs_host": parity})
    del trainer, step, descent

    for name, vocoder in VOCODERS.items():
        vcfg = get_config(48000, train_batch_size=TRAIN_BATCH, model_vocoder=vocoder,
                          **TRAIN_CFG)
        vt = RVCTrainer(vcfg, loader, checkpoint_dir=os.path.join(exp, name), seed=SEED,
                        device=TRAIN_DEVICE, model_name=name)
        vstep = vt.step_fn(True)
        vms, vmetrics, vlaunches, vpeak = timed_steps(vstep, batch, vt.generator, 1,
                                                      TRAIN_VOCODER_STEPS)
        check_finite(vmetrics, f"the {vocoder} steps")
        if vlaunches != {**TRAIN_LAUNCHES, "resblock_group": 0, "resblock_chain": 0}:
            raise AssertionError(f"a {vocoder} step launched {vlaunches}")
        emit({"phase": "train_vocoder", "vocoder": vocoder,
              "discriminator": "v3 (5 periods + 3 resolutions)" if vocoder == "RefineGAN"
              else "v2 (S + 8 periods)", "steps": TRAIN_VOCODER_STEPS, "step_ms": vms,
              "split_ms": train_split(vstep, batch, vt.generator), "launches": vlaunches,
              "max_memory_gb": vpeak, "trace": trace_one(lambda: vstep(batch, vt.generator)),
              "last_metrics": vmetrics[-1]})
        del vt, vstep
    return {"extract": extract_launches, "train_step": launches}


# ---------------------------------------------------------------------------
# multi-card: data-parallel training, the BatchConverter mesh, the tools
# ---------------------------------------------------------------------------

DDP_RANKS, DDP_BATCH, DDP_FRAMES, DDP_STEPS = 2, 8, 400, 3   # global batch 8 at bucket 400
DDP_LOSS_BAR, DDP_PARAM_BAR = 1e-4, 1e-3                      # step-1 losses rel, params rel_l2
DDP_LOSSES = ("loss_g_total", "loss_d", "loss_mel", "loss_kl", "loss_adv", "loss_fm")
MESH_UTTS = 16                                                # the long-form phase's first 16


def ddp_batch(cfg, seed: int):
    """A global batch of DDP_BATCH rows at DDP_FRAMES frames (lengths 400
    down to 330), harmonic waves of 120-260 Hz, random features."""
    import numpy as np
    import torch

    from rvc_tpu_torch.train.train_step import Batch

    rng = np.random.default_rng(seed)
    B, T, hop = DDP_BATCH, DDP_FRAMES, cfg.data.hop_length
    lengths = torch.tensor([T - 10 * i for i in range(B)])
    f0 = 120.0 + 20.0 * np.arange(B)
    t = np.arange(T * hop) / cfg.data.sample_rate
    wave = 0.3 * np.sin(2 * np.pi * f0[:, None] * t[None, :])
    return Batch(torch.from_numpy(rng.standard_normal((B, T, 768)).astype(np.float32)), lengths,
                 torch.from_numpy(rng.integers(1, 255, (B, T))),
                 torch.from_numpy(np.repeat(f0[:, None], T, 1).astype(np.float32)),
                 torch.from_numpy(np.abs(rng.standard_normal(
                     (B, T, cfg.data.spec_channels))).astype(np.float32)),
                 lengths.clone(), torch.from_numpy(wave.astype(np.float32)),
                 torch.arange(B) % 2)


def flat_rel_l2(got: dict, ref: dict) -> float:
    """rel_l2 over every tensor of two state dicts, concatenated."""
    import torch

    g = torch.cat([got[k].double().flatten().cpu() for k in ref])
    r = torch.cat([v.double().flatten().cpu() for v in ref.values()])
    return float((g - r).norm() / r.norm())


def phase_ddp_gloo(work: str) -> dict:
    """Two data-parallel ranks (`parallel.train.spawn` of `trainer_job`,
    gloo, both on the first card) at full width, DDP_STEPS steps on a global
    batch of DDP_BATCH, against the single-card trainer's step on the same
    batch and draws (one generator seeded alike). Returns each rank's
    launches over its steps and the single card's run (metrics, G, D,
    bytes, step ms), which `tp_gloo` holds its ranks against."""
    import numpy as np
    import torch

    from rvc_tpu_torch.configs import config_to_dict, get_config
    from rvc_tpu_torch.monitoring import NullTracker
    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from rvc_tpu_torch.parallel.train import spawn, state_bytes_per_device, trainer_job
    from rvc_tpu_torch.train.data import DataLoader, RVCDataset
    from rvc_tpu_torch.train.trainer import RVCTrainer

    cfg = get_config(48000, train_batch_size=DDP_BATCH, **TRAIN_CFG)
    batch = ddp_batch(cfg, SEED)
    job = os.path.join(work, "ddp_job.pt")
    torch.save({"config": config_to_dict(cfg), "seed": SEED, "device": TRAIN_DEVICE,
                "batch": tuple(batch), "steps": DDP_STEPS, "draws": None}, job)
    t0 = time.perf_counter()
    spawn(trainer_job, DDP_RANKS, (job,), backend="gloo", device=TRAIN_DEVICE)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(f"{job}.rank{r}", weights_only=False) for r in range(DDP_RANKS)]

    trainer = RVCTrainer(cfg, DataLoader(RVCDataset([], cfg.data.hop_length), 1),
                         checkpoint_dir=work, seed=SEED, tracker=NullTracker(),
                         device=TRAIN_DEVICE)
    step, b = trainer.step_fn(True), batch.to(TRAIN_DEVICE)
    ref, ms = [], []
    torch.cuda.synchronize()
    reset_launches()
    for _ in range(DDP_STEPS):
        t0 = time.perf_counter()
        m = step(b, trainer.generator)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        ref.append({k: float(v) for k, v in m.items()})
    single_launches = dict(LAUNCHES)
    single_bytes = state_bytes_per_device(trainer.net_g, trainer.net_d, trainer.g_opt,
                                          trainer.d_opt, 1)
    g_ref = {k: v.detach() for k, v in trainer.net_g.state_dict().items()}
    d_ref = {k: v.detach() for k, v in trainer.net_d.state_dict().items()}

    loss_rel = [{k: abs(r["metrics"][0][k] - ref[0][k]) / max(abs(ref[0][k]), 1e-12)
                 for k in DDP_LOSSES} for r in ranks]
    params = [{"G": flat_rel_l2(r["g"], g_ref), "D": flat_rel_l2(r["d"], d_ref)} for r in ranks]
    identical = all(torch.equal(ranks[0][n][k], r[n][k]) for r in ranks[1:]
                    for n in ("g", "d") for k in ranks[0][n])
    want = {k: n * DDP_STEPS for k, n in TRAIN_LAUNCHES.items()}
    out = {"phase": "ddp_gloo", "ranks": DDP_RANKS, "backend": "gloo",
           "devices": [TRAIN_DEVICE] * DDP_RANKS,
           "config": f"get_config(48000, **{TRAIN_CFG}), random init from seed {SEED}",
           "global_batch": DDP_BATCH, "frames": DDP_FRAMES, "steps": DDP_STEPS,
           "spawn_s": spawn_s, "step_ms_per_rank": [r["step_ms"] for r in ranks],
           "single_card_step_ms": ms,
           "all_reduce_bytes_per_step": ranks[0]["all_reduced_bytes"] / DDP_STEPS,
           "all_gather_bytes_per_step": ranks[0]["all_gathered_bytes"] / DDP_STEPS,
           "comm_ms_per_rank": [r["comm_ms"] for r in ranks],
           "zero1_bytes": {"per_rank": ranks[0]["state_bytes"], "single_card": single_bytes},
           "step1_loss_rel": loss_rel, "params_rel_l2_after_steps": params,
           "ranks_bit_identical": identical,
           "launches_per_rank": [r["launches"] for r in ranks],
           "single_card_launches": single_launches,
           "metrics_rank0": ranks[0]["metrics"], "metrics_single_card": ref}
    emit(out)
    ok = (identical and all(r < DDP_LOSS_BAR for x in loss_rel for r in x.values())
          and all(v < DDP_PARAM_BAR for p in params for v in p.values())
          and all(r["launches"] == want for r in ranks) and single_launches == want)
    if not ok:
        raise AssertionError(f"two gloo ranks against the single card: losses {loss_rel}, "
                             f"params {params}, identical {identical}, launches "
                             f"{[r['launches'] for r in ranks]} (want {want})")
    del trainer, step
    single = {"metrics": ref, "g": g_ref, "d": d_ref, "bytes": single_bytes, "step_ms": ms}
    return {f"ddp_gloo_rank{i}": r["launches"] for i, r in enumerate(ranks)}, single


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

TP_RANKS, TP_STEPS = 2, 3          # mesh (1, 2): one model group, both ranks on the card
# a rank's launches a step at full width, n_model 2: the C = 256 stage's chains
# and the C = 128 stage's k = 7 / 11 on the partial-sum launch, K1 elsewhere
TP_LAUNCHES = {"resblock_group": 21, "resblock_chain": 0, "rel_attention": 6, "log_mel": 0,
               "resblock_group_tp": 6, "resblock_chain_tp": 9}
TP_KERNELS = {
    "resblock_group_tp": dict(
        name="K1 resblock_group_tp", entry="rvc_resblock_step_partial",
        source="rvc_tpu_torch/csrc/resblock.cu", plain="resblock_group_partial_reference",
        replaces="rvc_tpu/ops/pallas/resblock.py:287 fused_resblock_group (partial-sum launch "
                 "on a tensor-parallel rank)", peak=PEAK_BF16, **BF16_BAR),
    "resblock_chain_tp": dict(
        name="K2 resblock_chain_tp", entry="rvc_resblock_step_partial",
        source="rvc_tpu_torch/csrc/resblock.cu", plain="resblock_chain_partial_reference",
        replaces="rvc_tpu/ops/pallas/resblock.py:141 fused_resblock (partial-sum launch on a "
                 "tensor-parallel rank)", peak=PEAK_BF16, **BF16_BAR),
}


def tp_work(name: str, a: dict) -> tuple:
    """(FLOP, bytes) of one `_tp` call's kernels on this rank: each chain's
    two convs a step over its C_M mid channels (C for a whole chain of a
    K1 stage); each input read once, the output written once (the
    all-reduces' bytes not counted)."""
    B, T, C = a["x"].shape
    if name == "resblock_chain_tp":
        weights, kernel_sizes, dilations = (a["w1"], a["b1"], a["w2"], a["b2"]), \
            (a["kernel_size"],), (a["dilations"],)
    else:
        weights, kernel_sizes, dilations = a["weights"], a["kernel_sizes"], a["dilations"]
    flop = sum(2 * B * T * C * weights[4 * i].shape[-1] * 2 * len(d) * k
               for i, (k, d) in enumerate(zip(kernel_sizes, dilations)))
    nbytes = 4 * (a["x"].numel() + sum(w.numel() for w in weights) + B * T * C)
    return flop, nbytes


def tp_call(fn, args, kwargs) -> dict:
    """One recorded `_tp` call on this rank, replayed in step with the other
    ranks (each call runs the model group's all-reduces): the kernel
    against its plain partial version in float32 and against its bf16
    emulation in float64, the ms of both (CUDA events, one call with its
    all-reduces), the kernel's device ms, the bound of its kernels. No hold
    here: the parent holds every rank's numbers (a rank that raised would
    leave the other waiting in a collective)."""
    import torch

    from rvc_tpu_torch.ops.kernels import resblock as KR

    name = fn.__name__
    spec = TP_KERNELS[name]
    plain = getattr(KR, spec["plain"])
    bound_args = inspect.signature(fn).bind(*args, **kwargs)
    a = bound_args.arguments
    got, ref = fn(*args, **kwargs), plain(*args, **kwargs)
    diff = (got - ref).abs()
    out = {"name": name, "inputs": {"x": list(a["x"].shape), "c_m": sorted(
        {int(w.shape[-1]) for w in (a["weights"][::4] if "weights" in a else (a["w1"],))})},
        "max_abs": float(diff.max()), "rel_l2": rel_l2(got, ref),
        "within": bool((diff <= spec["atol"] + spec["rtol"] * ref.abs()).all()),
        "corr": float(torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]).double())[0, 1])}
    out.update(emulation(got, plain, args, kwargs, a["x"]))
    del got, ref, diff
    out["ms"] = cuda_ms(lambda: fn(*args, **kwargs))
    out["plain_ms"] = cuda_ms(lambda: plain(*args, **kwargs))
    out["device_ms"] = device_kernel_ms(lambda: fn(*args, **kwargs), calls=3)
    flop, nbytes = tp_work(name, a)
    out["bound_ms"], out["bound_by"] = bound(flop, nbytes, spec["peak"])
    out["flop"], out["bytes"] = flop, nbytes
    return out


def tp_rank(path: str) -> None:
    """One rank of the `tp_gloo` job (`parallel.train.run_job`: TP_STEPS
    steps on mesh (1, TP_RANKS)), then one more step with its `_tp` calls
    recorded and replayed (`tp_call`); writes `path`.rank{r}."""
    import torch
    import torch.distributed as dist

    from rvc_tpu_torch.ops.kernels import record_calls
    from rvc_tpu_torch.parallel.train import run_job

    job = torch.load(path, weights_only=False)
    trainer, step, batch, _, out = run_job(dict(job, dir=os.path.dirname(path)))
    with record_calls() as calls:
        step(batch, trainer.generator)
    calls = [c for c in calls if c[0].__name__ in TP_KERNELS]
    with torch.inference_mode():
        out["tp_calls"] = [tp_call(fn, args, kwargs) for fn, args, kwargs in calls]
    torch.save(out, f"{path}.rank{dist.get_rank()}")


def rule_bytes(cfg, n_data: int, n_model: int, min_size: int) -> dict:
    """Per-rank bytes of G and D (training) by the port's rules alone: a
    parameter split over "model" holds 1 / n_model, a moment split over
    "data" (`zero1_dim`) 1 / n_data of that; float32 parameters and second
    moments, first moments in the config's type, two int32 counts."""
    import torch

    from rvc_tpu_torch.models.discriminators import build_discriminator
    from rvc_tpu_torch.models.synthesizer import build_synthesizer
    from rvc_tpu_torch.parallel import tp
    from rvc_tpu_torch.parallel.mesh import zero1_dim

    with torch.device("meta"):
        nets = (build_synthesizer(cfg, training=True), "synthesizer"), \
            (build_discriminator(cfg), "discriminator")
    mu = 2 if cfg.train.use_bf16 else 4
    params = opt = 0
    for net, family in nets:
        dims = tp.plan(net, family, n_model, min_size)
        for k, p in net.named_parameters():
            n = p.numel() // (n_model if dims[k] is not None else 1)
            params += 4 * n
            z = zero1_dim(tuple(p.shape), n_data, dims[k], min_size)
            opt += (n // (n_data if z is not None else 1)) * (mu + 4)
    return {"param_bytes_per_device": params, "opt_bytes_per_device": opt + 2 * 4}


def phase_tp_gloo(work: str, single: dict) -> tuple:
    """Two tensor-parallel ranks (mesh (1, TP_RANKS), gloo, both on the
    first card; `tp_rank`) at the train phase's full width and ddp_gloo's
    batch, at the default min_size, TP_STEPS steps from the single card's
    init and draws: step-1 losses and the gathered G / D after the steps
    against `ddp_gloo`'s single-card run at its bars, each rank's bytes
    against `rule_bytes` and the single card, the launches, the model
    axis's collectives, and every `_tp` call of one more step against its
    plain partial version. Returns ({path: launches} per rank, the `_tp`
    kernels' summary)."""
    import torch

    import chip_smoke as spawnable       # the ranks import tp_rank by its module's name
    from rvc_tpu_torch.configs import config_to_dict, get_config
    from rvc_tpu_torch.parallel.mesh import MIN_SIZE
    from rvc_tpu_torch.parallel.train import spawn

    cfg = get_config(48000, train_batch_size=DDP_BATCH, **TRAIN_CFG)
    batch = ddp_batch(cfg, SEED)
    job = os.path.join(work, "tp_job.pt")
    torch.save({"config": config_to_dict(cfg), "seed": SEED, "device": TRAIN_DEVICE,
                "batch": tuple(batch), "steps": TP_STEPS, "draws": None,
                "mesh_model": TP_RANKS}, job)
    t0 = time.perf_counter()
    spawn(spawnable.tp_rank, TP_RANKS, (job,), backend="gloo", device=TRAIN_DEVICE)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(f"{job}.rank{r}", weights_only=False) for r in range(TP_RANKS)]

    ref = single["metrics"]
    loss_rel = [{k: abs(r["metrics"][0][k] - ref[0][k]) / max(abs(ref[0][k]), 1e-12)
                 for k in DDP_LOSSES} for r in ranks]
    params = [{"G": flat_rel_l2(r["g"], single["g"]), "D": flat_rel_l2(r["d"], single["d"])}
              for r in ranks]
    gathered_equal = all(torch.equal(ranks[0][n][k], r[n][k]) for r in ranks[1:]
                         for n in ("g", "d") for k in ranks[0][n])
    rules = rule_bytes(cfg, 1, TP_RANKS, MIN_SIZE)
    want = {k: n * TP_STEPS for k, n in TP_LAUNCHES.items()}
    calls = [c for r in ranks for c in r["tp_calls"]]
    held = [c for c in calls if c["within"] and c["corr"] > c_bar(c, "min_corr")
            and emulation_holds(c, c_bar(c, "emu_rel_l2"))]
    card = card_line()
    per_step = [{k: v / TP_STEPS for k, v in r["model_comm"].items()} for r in ranks]
    out = {"phase": "tp_gloo", "card": card, "mesh": ranks[0]["mesh"], "backend": "gloo",
           "devices": [TRAIN_DEVICE] * TP_RANKS, "min_size": MIN_SIZE,
           "config": f"get_config(48000, **{TRAIN_CFG}), random init from seed {SEED}",
           "global_batch": DDP_BATCH, "frames": DDP_FRAMES, "steps": TP_STEPS,
           "spawn_s": spawn_s, "step_ms_per_rank": [r["step_ms"] for r in ranks],
           "single_card_step_ms": single["step_ms"],
           "model_axis_per_step": per_step,
           "data_axis_all_reduce_bytes_per_step": ranks[0]["all_reduced_bytes"] / TP_STEPS,
           "comm_ms_per_rank": [r["comm_ms"] for r in ranks],
           "bytes": {"per_rank": [r["state_bytes"] for r in ranks], "rules": rules,
                     "single_card": single["bytes"]},
           "step1_loss_rel": loss_rel, "params_rel_l2_after_steps": params,
           "gathered_equal_on_ranks": gathered_equal,
           "launches_per_rank": [r["launches"] for r in ranks],
           "sharded_parameters": ranks[0]["tp_kinds"],
           "tp_calls": calls, "tp_calls_held": len(held)}
    emit(out)
    bytes_ok = all(r["state_bytes"][k] == rules[k]
                   and r["state_bytes"][k] < single["bytes"][k]
                   for r in ranks for k in rules)
    ok = (gathered_equal and bytes_ok and len(held) == len(calls) > 0
          and all(v < DDP_LOSS_BAR for x in loss_rel for v in x.values())
          and all(v < DDP_PARAM_BAR for p in params for v in p.values())
          and all(r["launches"] == want for r in ranks)
          and all(p["all_reduce"] > 0 for p in per_step))
    if not ok:
        raise AssertionError(
            f"tp_gloo against the single card: losses {loss_rel}, params {params}, gathered "
            f"equal {gathered_equal}, bytes {[r['state_bytes'] for r in ranks]} (rules {rules}), "
            f"launches {[r['launches'] for r in ranks]} (want {want}), held {len(held)} of "
            f"{len(calls)} `_tp` calls")
    summary = []
    for name, spec in TP_KERNELS.items():
        mine = [c for c in ranks[0]["tp_calls"] if c["name"] == name]
        flop, nbytes = sum(c["flop"] for c in mine), sum(c["bytes"] for c in mine)
        bound_ms, bound_by = bound(flop, nbytes, spec["peak"])
        device = {}
        for c in mine:
            for k, v in c["device_ms"].items():
                device[k] = device.get(k, 0.0) + v
        summary.append(dict(
            name=spec["name"], route="cuda", source=spec["source"], entry=spec["entry"],
            replaces=spec["replaces"], launches=ranks[0]["launches"][name], calls=len(mine),
            max_abs_err=max(c["max_abs"] for c in calls if c["name"] == name),
            ms=sum(c["ms"] for c in mine), plain_ms=sum(c["plain_ms"] for c in mine),
            device_ms=device, bound_ms=bound_ms, bound_by=bound_by, bound=bound_text(spec["peak"]),
            library_ms=None, ms_note="one call with its gloo all-reduces, rank 0, one step's "
                                     "calls summed; device_ms: the kernels alone",
            emu_rel_l2=max(c["emu_rel_l2"] for c in calls if c["name"] == name),
            launches_by_path={f"tp_gloo_rank{i}": r["launches"][name]
                              for i, r in enumerate(ranks)}))
    return {f"tp_gloo_rank{i}": r["launches"] for i, r in enumerate(ranks)}, summary


def c_bar(call: dict, key: str) -> float:
    """A `_tp` call's bar `key` from its kernel's spec."""
    return TP_KERNELS[call["name"]][key]


def phase_tp_nccl(work: str) -> None:
    """`train --mesh_model 2` through its own bootstrap on the train
    phase's dataset, one epoch, one rank a card over NCCL, where the
    machine has two cards or more; else what stopped it."""
    import torch

    n = torch.cuda.device_count()
    if n < 2 or n % 2 or TRAIN_DEVICE != "cuda":
        emit({"phase": "tp_nccl", "skipped": f"{n} card(s): --mesh_model 2 with one rank a "
                                              f"card needs an even count of two or more"})
        return
    logs = os.path.join(work, "logs")
    argv = ["train", "--model_name", "voice", "--logs_dir", logs, "--sample_rate", "48000",
            "--total_epoch", "1", "--save_every_epoch", "10", "--cleanup", "--mesh_model", "2",
            "--batch_size", str(max(1, TRAIN_BATCH // (n // 2)))]
    if TRAIN_CFG:
        argv += ["--config_overrides", json.dumps(TRAIN_CFG)]
    _, wall_s, _ = _cli_train(argv)          # the ranks print from their own processes
    with open(os.path.join(logs, "voice", "ckpt", "train_log.jsonl")) as f:
        epoch = json.loads(f.read().splitlines()[-1])
    model = os.path.join(logs, "voice", "voice.safetensors")
    emit({"phase": "tp_nccl", "cards": n, "mesh": {"data": n // 2, "model": 2},
          "wall_s": wall_s, "epoch": epoch, "steps_per_s": epoch["batches"] / epoch["seconds"],
          "exported": os.path.exists(model), "card": card_line()})
    if not os.path.exists(model) or not math.isfinite(epoch["loss_g_total"]):
        raise AssertionError(f"train --mesh_model 2 over NCCL: {epoch}, export {model}")


def _cli_train(argv: list) -> tuple:
    """(stdout, wall s, launches) of `cli.main(argv)` in this process, the
    counts set to 0 just before and read just after."""
    import io

    import torch

    from rvc_tpu_torch import cli
    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0, dict(LAUNCHES)


def phase_ddp_nccl(work: str) -> dict:
    """`train` through its own bootstrap on the train phase's dataset, one
    epoch: rank 0 of 1 joined by NCCL at a localhost coordinator (the
    data-parallel step at world size 1); with two cards or more, also one
    rank a card started by `train` itself at the same global batch, with
    steps/s per card count. Returns the world-size-1 run's launches."""
    import torch

    from rvc_tpu_torch.parallel.train import free_port

    logs = os.path.join(work, "logs")
    base = ["train", "--model_name", "voice", "--logs_dir", logs, "--sample_rate", "48000",
            "--total_epoch", "1", "--save_every_epoch", "10", "--cleanup"]
    if TRAIN_CFG:
        base += ["--config_overrides", json.dumps(TRAIN_CFG)]
    if TRAIN_DEVICE == "cpu":
        base += ["--device", "cpu"]
    log = os.path.join(logs, "voice", "ckpt", "train_log.jsonl")

    def epoch():
        with open(log) as f:
            e = json.loads(f.read().splitlines()[-1])
        return {"batches": e["batches"], "seconds": e["seconds"],
                "steps_per_s": e["batches"] / e["seconds"], "loss_g_total": e["loss_g_total"]}

    text, wall_s, launches = _cli_train(base + [
        "--batch_size", str(TRAIN_BATCH), "--coordinator", f"localhost:{free_port()}",
        "--num_hosts", "1", "--host_id", "0"])
    result = json.loads(text.strip().splitlines()[-1])
    backend = re.search(r"'backend': '(\w+)'", text)
    one = {"world_size": 1, "backend": backend.group(1) if backend else None, "wall_s": wall_s,
           "epoch": epoch(), "result": result, "launches": launches}
    want = "gloo" if TRAIN_DEVICE == "cpu" else "nccl"
    if (one["backend"] != want or result["host"] != 0 or not result["model"]
            or not all(launches[k] > 0 for k in ("resblock_group", "resblock_chain",
                                                  "rel_attention"))):
        raise AssertionError(f"train at world size 1 through its bootstrap: {one}")
    n = torch.cuda.device_count()
    if n >= 2 and TRAIN_DEVICE == "cuda":
        text, wall_s, _ = _cli_train(base + ["--batch_size", str(max(1, TRAIN_BATCH // n))])
        multi = {"cards": n, "wall_s": wall_s, "epoch": epoch(),
                 "steps_per_s_per_card_count": {1: one["epoch"]["steps_per_s"],
                                                n: epoch()["steps_per_s"]}}
    else:
        multi = {"skipped": f"{n} card"}
    emit({"phase": "ddp_nccl", "world_size_1": one, "one_rank_a_card": multi})
    return {"ddp_nccl": launches}


def phase_longform_mesh(rvc) -> dict:
    """BatchConverter on a mesh naming the first card twice (two shards of
    each B = LONG_BATCH dispatch from two host threads) against one replica,
    on the long-form phase's first MESH_UTTS utterances with the source
    noise on; on a mesh over every card too where there are two or more.
    Each utterance within the long-form phase's bar (corr > 0.9999).
    Returns the twice-named mesh's launches."""
    import numpy as np
    import torch

    from rvc_tpu_torch.parallel import BatchConverter
    from rvc_tpu_torch.parallel.mesh import make_mesh

    utts = synth_utterances(MESH_UTTS, LONG_S)
    dispatches = math.ceil(MESH_UTTS * math.ceil(LONG_S / CHUNK_S) / LONG_BATCH)
    meshes = {"one_replica": None, "card_twice": make_mesh(devices=[rvc.device] * 2)}
    if torch.cuda.device_count() >= 2:
        meshes["every_card"] = make_mesh(devices=[f"cuda:{i}"
                                                  for i in range(torch.cuda.device_count())])
    runs, ref = {}, None
    for name, mesh in meshes.items():
        bc = BatchConverter(rvc, mesh)
        bc.convert_long_batch(utts[:1], chunk_seconds=CHUNK_S, pad_seconds=PAD_S,
                              batch_size=LONG_BATCH)               # warm
        outs, wall_s, launches = timed_long(bc, utts, LONG_BATCH)
        run = {"devices": [str(d) for d in bc.devices], "wall_s": wall_s,
               "audio_s_per_s": MESH_UTTS * LONG_S / wall_s, "launches": launches,
               "launches_per_dispatch": {k: v / dispatches for k, v in launches.items()}}
        if ref is None:
            ref = outs
        else:
            run["vs_one_replica"] = {
                "min_corr": min(float(np.corrcoef(o, r)[0, 1]) for o, r in zip(outs, ref)),
                "max_abs": max(float(np.abs(o - r).max()) for o, r in zip(outs, ref))}
        runs[name] = run
        del bc
    emit({"phase": "longform_mesh", "utterances": MESH_UTTS, "utterance_s": LONG_S,
          "batch_size": LONG_BATCH, "dispatches": dispatches, "runs": runs})
    twice = runs["card_twice"]
    want = {k: 2 * n * dispatches for k, n in LONG_LAUNCHES.items()}
    bad = [k for k, r in runs.items() if "vs_one_replica" in r
           and not r["vs_one_replica"]["min_corr"] > 0.9999]
    if bad or twice["launches"] != want:
        raise AssertionError(f"the mesh against one replica: {bad}, launches "
                             f"{twice['launches']} (want {want})")
    return {"longform_mesh": twice["launches"]}


def phase_tools(work: str) -> None:
    """model_information, convert, model_blender and audio_analyzer on the
    train phase's `.pth` export (a blend of the model with its own
    conversion at 0.5 is the conversion, bit for bit)."""
    import numpy as np

    from rvc_tpu_torch.tools import model_tools
    from rvc_tpu_torch.utils import weights as W
    from rvc_tpu_torch.utils.audio import save_wav

    pth = os.path.join(work, "logs", "voice", "voice.pth")
    times = {}
    t0 = time.perf_counter()
    info = model_tools.model_information(pth)
    times["model_information_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    conv = model_tools.convert_model(pth, os.path.join(work, "voice_conv.safetensors"))
    times["convert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blend = model_tools.blend_models(pth, conv, 0.5, os.path.join(work, "blend.safetensors"))
    times["model_blender_s"] = time.perf_counter() - t0
    a, b = W.load_params(conv), W.load_params(blend)
    same = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    wav = os.path.join(work, "clip.wav")
    save_wav(wav, test_clip(PARITY_S, SEED + 3), 16000)
    t0 = time.perf_counter()
    analysis = model_tools.analyze_audio(wav, os.path.join(work, "analysis.png"))
    times["audio_analyzer_s"] = time.perf_counter() - t0
    emit({"phase": "tools", "model_information": {k: info.get(k) for k in (
              "n_params", "n_tensors", "sr", "f0", "version")},
          "converted_tensors": len(a), "blend_equals_conversion": same,
          "audio_analyzer": {k: v for k, v in analysis.items() if k != "path"}, "times": times})
    if not (same and info.get("sr") == 48000 and analysis["samples"] == int(PARITY_S * 16000)
            and os.path.exists(analysis.get("plot_path") or "")):
        raise AssertionError(f"tools: blend {same}, info {info.get('sr')}, {analysis}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.ops.kernels import LAUNCHES, build, record_calls, reset_launches

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    emit({"phase": "build", "seconds": build.build_all(verbose=True)})

    t0 = time.perf_counter()
    rvc = RVC(config=get_config(48000), seed=SEED, device="cuda")
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "params_m": {n: sum(p.numel() for p in m.parameters()) / 1e6 for n, m in
                       (("synthesizer", rvc.pipeline.synthesizer),
                        ("hubert", rvc.pipeline.hubert), ("rmvpe", rvc.pipeline.rmvpe))}})

    clip = test_clip(CLIP_S, SEED)
    t0 = time.perf_counter()
    rvc.infer(clip)                      # warm: cuDNN plans, allocator, kernel loads
    warm_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = rvc.infer(clip)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    want = int(CLIP_S * rvc.cfg.data.sample_rate)
    emit({"phase": "pipeline", "clip_s": CLIP_S, "first_call_ms": warm_ms,
          "wall_ms": wall_ms, "realtime_x": CLIP_S * 1e3 / wall_ms,
          "out_samples": len(out), "peak": float(np.abs(out).max()),
          "launches": launches,
          "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    if len(out) != want or not np.isfinite(out).all():
        raise AssertionError(f"pipeline output: {len(out)} samples (want {want}), "
                             f"finite={bool(np.isfinite(out).all())}")
    missing = [k for k in KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")

    phase_stages(rvc)

    with record_calls() as calls:
        rvc.infer(clip)
    summary = phase_kernels(calls, launches)
    del calls

    clip = test_clip(PARITY_S, SEED + 1)
    rvc.pipeline.source_noise = False
    gpu = rvc.infer(clip)
    cpu_rvc = RVC(config=get_config(48000), seed=SEED, device="cpu", source_noise=False)
    t0 = time.perf_counter()
    cpu = cpu_rvc.infer(clip)
    if len(gpu) != len(cpu):
        raise AssertionError(f"GPU gave {len(gpu)} samples, CPU {len(cpu)}")
    corr = float(np.corrcoef(gpu, cpu)[0, 1])
    emit({"phase": "parity", "clip_s": PARITY_S, "samples": len(gpu),
          "waveform_corr": corr, "max_abs": float(np.abs(gpu - cpu).max()),
          "cpu_seconds": time.perf_counter() - t0})
    if not corr > 0.99:
        raise AssertionError(f"GPU vs CPU waveform corr {corr}")

    # the model's files (.pth, .index) live in the git-ignored build directory
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        index_path, retrieval_launches = phase_retrieval(rvc, work)
        f0less_launches = phase_f0less(index_path, work)
        pitch_launches = phase_pitch(rvc, work)
        postfx_launches = phase_postfx(rvc, work)
        vocoder_launches = phase_vocoders(work)
        realtime_launches = phase_realtime(rvc, cpu_rvc, index_path)
    del cpu_rvc
    longform_launches = phase_longform(rvc)
    mesh_launches = phase_longform_mesh(rvc)
    del rvc
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        train_launches = phase_train(work)
        ddp_launches, single = phase_ddp_gloo(work)
        tp_launches, tp_summary = phase_tp_gloo(work, single)
        del single
        nccl_launches = phase_ddp_nccl(work)
        phase_tp_nccl(work)
        phase_tools(work)
    for entry, name in zip(summary, KERNELS):
        entry["launches_by_path"] = {"pipeline": launches[name],
                                     "retrieval": retrieval_launches[name],
                                     "f0less": f0less_launches[name],
                                     **{k: v[name] for k, v in pitch_launches.items()},
                                     "postfx": postfx_launches[name],
                                     **{k: v[name] for k, v in vocoder_launches.items()},
                                     "longform": longform_launches[name],
                                     **{k: v[name] for k, v in realtime_launches.items()},
                                     **{k: v[name] for k, v in train_launches.items()},
                                     **{k: v[name] for k, v in mesh_launches.items()},
                                     **{k: v[name] for k, v in ddp_launches.items()},
                                     **{k: v[name] for k, v in tp_launches.items()},
                                     **{k: v[name] for k, v in nccl_launches.items()}}
    summary += tp_summary

    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
