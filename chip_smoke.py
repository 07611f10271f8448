#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`rvc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (a `kernel` line per kernel call):
  device    the card's name and power limit (nvidia-smi)
  build     nvcc builds every kernel of `rvc_tpu_torch/csrc/` (seconds)
  wgmma     static evidence that K1/K2 run on wgmma: HGMMA instructions per
            kernel function of the built resblock library (cuobjdump -sass;
            where it is missing, wgmma.mma_async in its PTX); fails if K2's
            kernel has none
  pipeline  the full-width 48 kHz model (random weights from seed 0)
            converts a 13.5 s clip through `RVC.infer`; wall ms after a warm
            call, the realtime factor, and each kernel's launches in that
            run; under the compute policy unset, bf16 on the card
            (RVC_TPU_BF16; every phase below runs under it unless it says)
  stages    device ms of each stage of one 13.5 s chunk (f0 program, HuBERT,
            enc_p, flow, decoder) under that policy and the host's
            preparation time
  kernel    every kernel-wrapper call of one more conversion of the clip,
            recorded with its inputs (`ops.kernels.record_calls`) and
            replayed: the kernel against its plain PyTorch version on the
            same inputs (TF32 off; K3 and K4 against the plain version run
            in float64, and where the float32 plain version misses the bar
            there, within twice its distance), max_abs / rel_l2 / tolerance, ms for
            both (CUDA events around one call, the host's launch work
            included; the median of 5 runs after warmup; K3's calls take
            bf16 rows under the policy and are held against their plain
            version at rel_l2 <= 4e-3 and corr > 0.9999), `ms_queued` and
            `plain_ms_queued` for both (10 calls queued back to back, over
            10, as in a conversion), and the bound at the kernel's own
            peak. K1/K2 (bf16 operands, float32 sums, as the
            TPU kernel) are also held to the plain version's bf16 emulation
            (`bf16_operands=True`) run in float64, beside the same emulation
            run in float32 by cuDNN (`emu_rel_l2`, `cudnn_emu_rel_l2`), and
            carry `cudnn_bf16_ms`: the plain chain on
            bf16 copies of the inputs (cuDNN bf16 convs, bf16 residual), a
            yardstick, not the same function. Every line carries its launch
            `grid` (K1/K2: `launch_plan`'s mode, blocks, tile, halo, shared
            bytes, stages, launches; K3 / K4: blocks, blocks an SM, waves on
            the card's SMs); K3 also
            `sdpa_ms`: PyTorch's scaled_dot_product_attention in float32 on
            the same q, k, v with the band logits and the length folded into
            a dense additive mask built outside the timed region, a
            yardstick without the band weights' rel-v term (and
            `sdpa_ms_queued`); every line carries `device_ms`, each CUDA
            kernel's device time per call from torch.profiler. The replay
            must launch each kernel as often as the timed run did.
  parity    a 2 s clip on the card (bf16) and through the port's CPU path
            (the plain versions, float32: the CPU's default), same weights,
            source noise off, each side's policy printed: waveform corr
  bf16      the compute policy on the main path: RVC_TPU_BF16=1 against 0 on
            the card (wall ms, launches, waveform corr > 0.999 and
            spectrogram corr > 0.99, the reference's bars), the card's bf16
            against the CPU's bf16 on the 2 s clip (corr > 0.99), each
            stage's device ms under both, the bf16 copies' memory,
            RVC_TPU_BF16_F0's f0 program (ms, voicing agreement and cents
            p95 against float32), one BatchConverter batch (8 x 12 s) and
            one realtime block under each policy (ms, launches; corr >
            0.99); then the K3 calls of a float32 conversion (the entry the
            staged path and training launch) as `kernel` lines and the
            summary's float32 K3 line
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
            memory, launches per dispatch: K1 3, K2 9, K3 6, K4 1); the
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
            (K1 3, K2 9, K3 6, K4 1), ms of the block program and its stages
            (CUDA events around one call) with each stage's trace (kernels,
            busy ms) and host ms of the host's parts, torch.profiler over one
            block (CUDA kernels, copies, busy ms, the top kernels), and every kernel
            call of one block held against its plain version (with grid) and
            timed beside its bound
  realtime_checks  the staged block against the fused one, both float32
            (corr > 0.999, atol 5e-3); three silent blocks (zeros, no launch); 4 blocks on
            the card against the port's CPU path, noise off (corr > 0.99);
            index_rate 0.75 on the retrieval phase's index (ms per block, beside
            a fresh engine without it on the same blocks);
            `VoiceChangerPool` at N = 1, 4, 16 (step ms, launches per step,
            real-time streams per card = N x 512 / step ms; every kernel
            call of one N = 16 step held, with grid); 10 blocks over
            `RealtimeSocketServer` on 127.0.0.1 (ms per round trip; replies
            within 1e-4 of an in-process engine)
  adamw     the training step's AdamW kernel (`ops.kernels.adamw`) on the
            48 kHz model's G and D at full width, bf16 and float32 first
            moments: gradients with NaN, +-inf and values past 1e3 (the norm
            over 1) or small ones (under 1), gate None or False, two steps
            across a steps_per_epoch boundary, each from the same state as
            the plain versions on the card: the norm within rel_l2 1e-6 of
            theirs and of float64; the parameters' change and both moments
            within 1e-6 per tensor of the plain loop given the kernel's norm,
            and within 1e-5 (a bf16 first moment 1e-4) of `adamw_reference`
            with its own norm; the count; a False gate changes nothing. Then
            a `kernel` line per network and moment type: ms, held_stream_ms
            (its device time: CUDA events around the call on a stream held
            while the host queues it), plain_ms and the bytes bound. The
            same checks on ZeRO-1's layouts of G and D (`ShardedAdamW`'s
            slices for each data index of 4, dim-0 and strided dim-1 ones;
            gate None or False, both moment types; one case with the norm
            given) and a `kernel` line of data index 0's bf16 call (bound: 4
            B a parameter for the norm, 24 B an updated element)
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
            per step (K1 3, K2 9, K3 6; K1/K2 twice with checkpointing)
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
            per rank (K1 3, K2 9, K3 6 a step)
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
            single card, launches per rank (K1 3 + K1_tp 6, K2_tp 9, K3 6 a
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
  frontends (after tools, a line per part, each with the card's name and
            power limit) download: a zip of the train phase's `voice.pth`
            and the retrieval phase's index served by `http.server` on
            127.0.0.1 and fetched by `tools.download.download_model` (the
            extracted files' sha256 equal the originals'), a 2 s clip
            converted on the card from the downloaded pair (seconds; corr
            > 0.9999 against the original files); tts: `cli tts` in a
            subprocess with `edge_tts` unimportable exits 2, then
            `tools.tts.tts_and_convert` through a stub `edge_tts` (a seeded
            chirp WAV) converts on the card ("edge_tts": "stub"); trace: the
            main path's `RVC.infer` of the 13.5 s clip with RVC_TPU_TRACE=1
            (the spans: count, mean ms) and two under `xprof_trace` (the
            CUDA kernels it recorded; K1-K4's symbols must be among them);
            packed: `resblock_group_packed` at the main path's C = 128, 64,
            32 stage shapes, one run's launches, each call against its
            plain version on its valid steps at K1's bars and timed as a
            `kernel` line (ms, ms_queued, plain_ms, device_ms, bound)
Then the `kernels` summary line (per kernel: the sums over its calls; the
launches of each path's run beside the main path's, `staged_crepe`,
`staged_rmvpe`, `postfx`, `mrf`, `refinegan` and `longform` among them;
`realtime` per block and `realtime_pool` per step at N = 16, `extract`
over the train phase's extraction and `train_step` per step;
`longform_mesh` over its run, `ddp_gloo_rank0` / `ddp_gloo_rank1` over
their 3 steps, `tp_gloo_rank0` / `tp_gloo_rank1` over theirs and
`ddp_nccl` over its epoch, `frontends_download` / `frontends_tts` /
`frontends_trace` over one conversion each, `bf16_main` / `f32_main` /
`bf16_batch` / `bf16_block` from the bf16 phase; AdamW's line sums G's and
D's bf16 calls, one training step; K3's line names its rows,
bf16 on the main path, and a second K3 line holds the float32 entry from
the bf16 phase; the `_tp` variants' lines from
`tp_gloo`, their calls on rank 0 in one step; K1-packed's from the
`frontends` phase's packed part),
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
import shutil
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
        name="K1 resblock_group", module="resblock", entry="rvc_resblock_chains",
        source="rvc_tpu_torch/csrc/resblock.cu",
        replaces="rvc_tpu/ops/pallas/resblock.py:287 fused_resblock_group",
        peak=PEAK_BF16, **BF16_BAR),
    "resblock_chain": dict(
        name="K2 resblock_chain", module="resblock", entry="rvc_resblock_chains",
        source="rvc_tpu_torch/csrc/resblock.cu",
        replaces="rvc_tpu/ops/pallas/resblock.py:141 fused_resblock",
        peak=PEAK_BF16, **BF16_BAR),
    "rel_attention": dict(
        name="K3 rel_attention", module="attention", entry="rvc_rel_attention",
        source="rvc_tpu_torch/csrc/rel_attention.cu",
        replaces="rvc_tpu/ops/pallas/attention.py:87 fused_rel_attention",
        peak=PEAK_F32, atol=1e-4, rtol=1e-4,
        # bf16 rows (the bf16 compute policy): against the plain version, which
        # computes in float32 and rounds the output to bf16 as the kernel does
        bf16_rel_l2=4e-3, bf16_min_corr=0.9999),
    "log_mel": dict(
        name="K4 log_mel", module="melspec", entry="rvc_log_mel",
        source="rvc_tpu_torch/csrc/melspec.cu",
        replaces="rvc_tpu/ops/pallas/melspec.py:61 pallas_log_mel",
        peak=PEAK_F32, atol=2e-3, rtol=1e-3),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def policy(device) -> str:
    """The compute dtype a conversion on `device` runs under now
    (RVC_TPU_BF16; `utils.device.compute_dtype`)."""
    import torch

    from rvc_tpu_torch.utils.device import compute_dtype

    return str(compute_dtype(torch.device(device))).replace("torch.", "")


@contextlib.contextmanager
def env(name: str, value: str):
    """`name` set to `value` inside, restored (or unset) after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


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


def compare_bf16(got, ref, max_rel_l2: float, min_corr: float, what: str) -> dict:
    """A kernel on bf16 rows against its plain version on the same rows
    (float32 arithmetic, the output rounded to bf16): rel_l2 and corr in
    float64. Raises on a miss."""
    import torch

    got, ref = got.double(), ref.double()
    out = {"max_abs": float((got - ref).abs().max()), "rel_l2": rel_l2(got, ref),
           "corr": float(torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]))[0, 1]),
           "tol": f"rel_l2 <= {max_rel_l2} (the output's bf16 rounding), corr > {min_corr}"}
    if not (math.isfinite(out["max_abs"]) and out["rel_l2"] <= max_rel_l2
            and out["corr"] > min_corr):
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
    each input once and write each output once (at their element sizes:
    K3's bf16 rows two bytes); the FLOP count the keys this run's lengths
    leave valid."""
    nbytes = sum(t.numel() * t.element_size() for v in a.values()
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
        return flop, nbytes + a["q"].numel() * a["q"].element_size()
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
    """The launch grid of this call: K1/K2's plan (mode, blocks, tile, halo,
    window, shared bytes, stages, launches), K3's split kernel's, K4's DFT
    kernel's."""
    import torch

    if name in ("resblock_group", "resblock_chain"):
        from rvc_tpu_torch.ops.kernels.resblock import launch_plan

        B, T, C = a["x"].shape
        if name == "resblock_group":
            ks, ds = a["kernel_sizes"], a["dilations"]
        else:
            ks, ds = (a["kernel_size"],), (a["dilations"],)
        return launch_plan(C, T, ks, ds, B)
    if name == "rel_attention":
        from rvc_tpu_torch.ops.kernels.attention import launch_plan

        B, H, T, D = a["q"].shape
        return launch_plan(B * H, T, D, a["window_size"], a["q"].dtype == torch.bfloat16)
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
        if name == "rel_attention" and a["q"].dtype == torch.bfloat16:
            T = a["q"].shape[2]      # rows past the length differ by design
            valid = (torch.arange(T, device=got.device)[None, :]
                     < a["key_lens"].to(got.device)[:, None])[:, None, :, None]
            cmp = compare_bf16(got * valid, ref * valid, spec["bf16_rel_l2"],
                               spec["bf16_min_corr"], what)
        elif name in ("rel_attention", "log_mel"):
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
            if "corr" in cmp:
                h["min_corr"] = min(h.get("min_corr", 1.0), cmp["corr"])
            if name in ("rel_attention", "log_mel"):
                h["grid"] = kernel_grid(name, a)
            if name == "rel_attention":
                h["rows"] = str(a["q"].dtype).replace("torch.", "")
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


def phase_kernels(calls: list, launches: dict, only=tuple(KERNELS)) -> list:
    """Replay each recorded wrapper call of the kernels `only` names: check
    the kernel against its plain version, then time both. Returns the
    per-kernel summary (K3's line names the dtype of its rows)."""
    import torch

    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    results = {}
    calls = [c for c in calls if c[0].__name__ in only]
    launches = {k: launches[k] for k in only}
    with torch.inference_mode():
        reset_launches()
        checked = check_calls(calls)
        torch.cuda.synchronize()
        replayed = {k: LAUNCHES[k] for k in only}
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
            rows = f" ({a['q'].dtype} rows)".replace("torch.", "") if name == "rel_attention" else ""
            emit({"phase": "kernel", "name": spec["name"] + rows, "inputs": desc, **cmp,
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
            if name in ("resblock_group", "resblock_chain"):
                r.setdefault("grids", []).append({k: extra["grid"][k] for k in (
                    "mode", "C", "T", "blocks", "tile", "halo", "smem_bytes", "stages",
                    "launches")})
            elif "grid" in extra:
                r["grid"] = extra["grid"]
            if name == "rel_attention":
                r["rows"] = str(a["q"].dtype).replace("torch.", "")
            if "corr" in cmp:
                r["min_corr"] = min(r.get("min_corr", 1.0), cmp["corr"])
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
    for name in only:
        spec, r = KERNELS[name], results.get(name)
        if r is None:
            raise AssertionError(f"the main path made no call of {name}")
        bound_ms, bound_by = bound(r["flop"], r["bytes"], spec["peak"])
        rows = r.get("rows")
        summary.append(dict(
            name=spec["name"] + (f" ({rows} rows)" if rows else ""), rows=rows,
            min_corr=r.get("min_corr"), route="cuda", source=spec["source"],
            entry=spec["entry"] + ("_bf16" if rows == "bfloat16" else ""),
            replaces=spec["replaces"], launches=launches[name], calls=r["calls"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], ms_queued=r["ms_queued"],
            device_ms=r.get("device_ms"), plain_ms=r["plain_ms"],
            plain_ms_queued=r["plain_ms_queued"],
            bound_ms=bound_ms, bound_by=bound_by, bound=bound_text(spec["peak"]),
            library_ms=None, cudnn_bf16_ms=r.get("cudnn_bf16_ms"), sdpa_ms=r.get("sdpa_ms"),
            sdpa_ms_queued=r.get("sdpa_ms_queued"),
            grid=r.get("grid", r.get("grids")),
            emu_rel_l2=r.get("emu_rel_l2"), emu_update_rel_l2=r.get("emu_update_rel_l2"),
            cudnn_emu_rel_l2=r.get("cudnn_emu_rel_l2")))
    return summary


def wgmma_count() -> dict:
    """Static evidence that K1/K2 issue wgmma: HGMMA instructions per kernel
    function of the built resblock library (`cuobjdump -sass`), or where
    cuobjdump is missing, wgmma.mma_async per entry of its PTX (`nvcc -ptx`)."""
    from rvc_tpu_torch.ops.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(tool):
        text = subprocess.run([tool, "-sass", str(build._target("resblock"))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        marker, inst, source = "Function : ", "HGMMA", "cuobjdump -sass: HGMMA"
    else:
        ptx = str(build.BUILD_DIR / "resblock.ptx")
        subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-ptx", "-o", ptx, str(build.CSRC_DIR / "resblock.cu")],
                       check=True, timeout=600)
        with open(ptx) as f:
            text = f.read()
        marker, inst, source = ".entry ", "wgmma.mma_async", "nvcc -ptx: wgmma.mma_async"
    counts, name = {}, None
    for line in text.splitlines():
        if marker in line:
            m = re.search(r"chains_kernelILi(\d+)ELb([01])E", line) or re.search(
                r"resblock_step_kernelILi(\d+)ELi(\d+)E", line)
            name = None if m is None else (
                f"chains_kernel<{m.group(1)},{'true' if m.group(2) == '1' else 'false'}>"
                if "chains" in m.group(0) else f"resblock_step_kernel<{m.group(1)},{m.group(2)}>")
        elif name is not None and inst in line:
            counts[name] = counts.get(name, 0) + 1
    return {"source": source, "counts": counts}


def stage_ms(rvc, dtype) -> tuple:
    """(device ms of each stage of one 13.5 s chunk under compute dtype
    `dtype`, median CUDA events; the host's preparation ms). Under bf16 the
    pipeline's bf16 copies run on the chunk rounded to bf16, the decoder on
    float32 activations (`Pipeline.models`); the f0 program is float32."""
    import numpy as np
    import torch
    from torch.nn import functional as F

    from rvc_tpu_torch.ops.kernels.melspec import log_mel
    from rvc_tpu_torch.pipelines.offline import coarse_f0_torch, upsample_protect
    from rvc_tpu_torch.utils import audio as audio_utils

    p = rvc.pipeline
    hubert, synth = p.models(dtype)
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
        audio_c = audio.to(dtype)
        st["HuBERT"] = cuda_ms(lambda: hubert(audio_c))
        f0 = p.f0(audio, 0.0, 0.0)
        feats = hubert(audio_c)
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
        z = (synth.flow(m_p * x_mask, x_mask, g=g) * x_mask).float()
        gd = g.float()
        st["  decoder (K1, K2)"] = cuda_ms(lambda: synth.dec(z, f0, g=gd))
    return st, host_ms


def phase_stages(rvc) -> None:
    """Device time of each stage of one 13.5 s chunk (median CUDA-event ms)
    under the policy the main path ran under, beside the host's share of a
    conversion."""
    from rvc_tpu_torch.utils.device import compute_dtype

    st, host_ms = stage_ms(rvc, compute_dtype(rvc.device))
    emit({"phase": "stages", "clip_s": CLIP_S, "policy": policy(rvc.device),
          "host_prep_ms": host_ms, "device_ms": st})


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


def gpu_cpu_corr(rvc, model_path: str, index_path: str, staged: bool = False) -> dict:
    """A 2 s clip through `rvc` on the card and through the same files on
    the port's CPU path, source noise off: waveform corr > 0.99. The card
    runs the compute policy (bf16 by default) unless the model takes the
    staged path (`staged`), which is float32."""
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
            "card_policy": "float32 (staged path)" if staged else policy(rvc.device),
            "cpu_policy": policy("cpu"), "max_abs": float(np.abs(gpu - cpu).max()),
            "cpu_seconds": time.perf_counter() - t0}


# tests/unit/test_fused_pipeline.py:109-128; the spectrogram corr with an 80 dB
# floor, as `monitoring.voice_metrics.spectrogram_correlation` says to compare
# reduced-precision paths (without one, bins far below the peak dominate)
BF16_WAVE_CORR, BF16_SPEC_CORR = 0.999, 0.99


def _rounded_decoder(synth):
    """A copy of the float32 synthesizer whose decoder parameters are
    rounded through bf16 (as in the bf16 copy), everything else float32."""
    import copy

    from rvc_tpu_torch.models.generators import round_params_bf16_

    out = copy.deepcopy(synth).requires_grad_(False)
    round_params_bf16_(out.dec)
    return out


def encoder_traces(rvc, dtype) -> dict:
    """torch.profiler over one enc_p and one reverse flow of the main path's
    chunk under compute dtype `dtype`: kernels and busy ms of each."""
    import numpy as np
    import torch

    p = rvc.pipeline
    synth = p.models(dtype)[1]
    clip = test_clip(CLIP_S, SEED)
    with torch.inference_mode():
        audio = p._upload(np.pad(clip, (p.t_pad, p.t_pad), mode="reflect"))
        n = audio.shape[1] // 160
        feats, _ = p._features(audio, n, None, 0.0, dtype)
        phone = feats.repeat_interleave(2, dim=1)
        lengths = torch.tensor([n], device=rvc.device)
        pitch = torch.full(phone.shape[:2], 100, device=rvc.device)
        g = synth.emb_g(torch.tensor([0], device=rvc.device))[:, None, :]
        m_p, _, x_mask = synth.enc_p(phone, pitch, lengths)
        return {"enc_p": trace_one(lambda: synth.enc_p(phone, pitch, lengths), top=5),
                "flow": trace_one(lambda: synth.flow(m_p * x_mask, x_mask, g=g), top=5)}


def bf16_copies_memory(rvc) -> dict:
    """The bf16 copies of HuBERT and the synthesizer made anew on the card
    (`Pipeline.models`): the bytes they keep and the peak above the memory
    before them."""
    import torch

    p = rvc.pipeline
    p._bf16 = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hubert, synth = p.models(torch.bfloat16)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "kept_mb": (torch.cuda.memory_allocated() - base) / 1e6,
            "peak_mb": (torch.cuda.max_memory_allocated() - base) / 1e6,
            "params_m": {"hubert": sum(t.numel() for t in hubert.parameters()) / 1e6,
                         "synthesizer": sum(t.numel() for t in synth.parameters()) / 1e6}}


def phase_bf16(rvc, cpu_rvc) -> dict:
    """The bf16 compute policy on the main path (RVC_TPU_BF16=1 against 0 on
    the same model and 13.5 s clip, source noise off): wall ms and launches
    under each, waveform corr > 0.999 and spectrogram corr > 0.99 (the
    reference's bars); the card's bf16 against the port's CPU bf16 on the
    2 s clip (corr > 0.99); each stage's device ms under both policies; the
    bf16 copies' memory; RVC_TPU_BF16_F0's f0 program (ms, voicing
    agreement and cents p95 against float32); one BatchConverter batch and
    one realtime block under each policy (ms; bf16 against float32 corr >
    0.99); then K3's float32 line: the calls of a float32 conversion
    checked and timed. Returns (K3's float32 summary entry, {path:
    launches})."""
    import numpy as np
    import torch

    from rvc_tpu_torch.monitoring.voice_metrics import spectrogram_correlation
    from rvc_tpu_torch.ops.kernels import LAUNCHES, record_calls, reset_launches
    from rvc_tpu_torch.parallel import BatchConverter
    from rvc_tpu_torch.realtime.core import VoiceChanger

    p = rvc.pipeline
    p.source_noise = False
    clip = test_clip(CLIP_S, SEED)
    dtypes = {"1": torch.bfloat16, "0": torch.float32}
    out, walls, launches, stages, traces = {}, {}, {}, {}, {}
    for v, dtype in dtypes.items():       # in turns: bf16, float32, float32, bf16
        with env("RVC_TPU_BF16", v):
            out[v], walls[v], launches[v] = timed_conversion(rvc, clip)
    for v, dtype in reversed(dtypes.items()):
        with env("RVC_TPU_BF16", v):
            walls[v] = [walls[v], timed_conversion(rvc, clip)[1]]
    for dtype in dtypes.values():
        name = str(dtype).replace("torch.", "")
        stages[name] = stage_ms(rvc, dtype)[0]
        traces[name] = encoder_traces(rvc, dtype)
    if launches["1"] != launches["0"] or launches["1"]["rel_attention"] != 6:
        raise AssertionError(f"launches bf16 {launches['1']}, float32 {launches['0']}")

    def agreement(a, b) -> dict:
        return {"waveform_corr": float(np.corrcoef(a, b)[0, 1]),
                "spec_corr": spectrogram_correlation(b, a, top_db=80),
                "spec_corr_no_floor": spectrogram_correlation(b, a),
                "max_abs": float(np.abs(a - b).max())}

    # the decoder's bf16-rounded parameters alone, the rest float32: how much
    # of the difference the reference's parameter cast makes by itself
    f32_synth = p.synthesizer
    p.synthesizer = _rounded_decoder(f32_synth)
    with env("RVC_TPU_BF16", "0"), torch.inference_mode():
        dec_only = rvc.infer(clip)
    p.synthesizer = f32_synth
    main = {"wall_ms": {"bfloat16": walls["1"], "float32": walls["0"]},
            "launches": launches["1"], **agreement(out["1"], out["0"]),
            "decoder_rounding_only": agreement(dec_only, out["0"]),
            "bars": f"waveform corr > {BF16_WAVE_CORR}, spec corr (80 dB floor) > "
                    f"{BF16_SPEC_CORR}"}
    if not (main["waveform_corr"] > BF16_WAVE_CORR and main["spec_corr"] > BF16_SPEC_CORR):
        raise AssertionError(f"bf16 against float32 on the card: {main}")

    short = test_clip(PARITY_S, SEED + 1)
    with env("RVC_TPU_BF16", "1"):
        gpu = rvc.infer(short)
        t0 = time.perf_counter()
        cpu = cpu_rvc.infer(short)
        host = {"card_policy": policy(rvc.device), "cpu_policy": policy("cpu"),
                "cpu_seconds": time.perf_counter() - t0}
    host["waveform_corr"] = float(np.corrcoef(gpu, cpu)[0, 1]) if len(gpu) == len(cpu) else None
    if not (host["waveform_corr"] or 0) > 0.99:
        raise AssertionError(f"the card's bf16 against the CPU's bf16: {host}")
    cpu_rvc.pipeline._bf16 = None

    memory = bf16_copies_memory(rvc)

    # RVC_TPU_BF16_F0: the f0 program on the main path's padded chunk
    chunk = np.pad(clip, (p.t_pad, p.t_pad), mode="reflect")
    chunk = np.pad(chunk, (0, p._bucket_samples(len(chunk)) - len(chunk)), mode="reflect")
    with torch.inference_mode():
        audio = torch.from_numpy(chunk)[None].to(rvc.device)
        f0 = {str(d).replace("torch.", ""): p.f0(audio, 0.0, 0.0, d).cpu().numpy()
              for d in dtypes.values()}
        f0_ms = {str(d).replace("torch.", ""): cuda_ms(lambda d=d: p.f0(audio, 0.0, 0.0, d))
                 for d in dtypes.values()}
    a, b = f0["bfloat16"], f0["float32"]
    both = (a > 0) & (b > 0)
    cents = 1200 * np.abs(np.log2(a[both] / b[both])) if both.any() else np.zeros(1)
    f0_line = {"ms": f0_ms, "frames": int(a.size), "voiced_f32": float((b > 0).mean()),
               "voicing_agreement": float(((a > 0) == (b > 0)).mean()),
               "cents_p95": float(np.percentile(cents, 95)), "cents_max": float(cents.max())}
    if not np.isfinite(a).all():
        raise AssertionError(f"RVC_TPU_BF16_F0: f0 not finite ({f0_line})")

    # one BatchConverter batch (B = 8 windows of the long-form shape) and one
    # realtime block at the reference's session, under each policy
    bc = BatchConverter(rvc)
    window = int((CHUNK_S + 2 * PAD_S) * 16000)
    batch = np.stack([test_clip(CHUNK_S + 2 * PAD_S, SEED + 10 + i)[:window]
                      for i in range(LONG_BATCH)])
    block = rt_clip48(2, 192 * 128, SEED)
    paths, outs = {}, {}
    for v, dtype in dtypes.items():
        name = str(dtype).replace("torch.", "")
        with env("RVC_TPU_BF16", v):
            bc.convert_batch(batch)                                # warm
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            got = bc.convert_batch(batch)
            batch_ms = 1e3 * (time.perf_counter() - t0)
            batch_launches = dict(LAUNCHES)
            vc = VoiceChanger(rvc, silent_threshold=RT_GATE_DB)
            vc.on_request(block[: vc.block_frame], index_rate=0.0)  # warm
            reset_launches()
            t0 = time.perf_counter()
            blk = vc.on_request(block[vc.block_frame:], index_rate=0.0)[0]
            block_ms = 1e3 * (time.perf_counter() - t0)
            block_launches = dict(LAUNCHES)
        if not (np.isfinite(got).all() and np.isfinite(blk).all()):
            raise AssertionError(f"{name}: a batch or block not finite")
        outs[name] = (got, blk)
        paths[name] = {"batch_ms": batch_ms, "batch_launches": batch_launches,
                       "block_ms": block_ms, "block_launches": block_launches}
    (g16, b16), (g32, b32) = outs["bfloat16"], outs["float32"]
    paths["batch_min_corr"] = min(float(np.corrcoef(x, y)[0, 1]) for x, y in zip(g16, g32))
    paths["block_corr"] = float(np.corrcoef(b16, b32)[0, 1])
    if not (paths["batch_min_corr"] > 0.99 and paths["block_corr"] > 0.99):
        raise AssertionError(f"bf16 against float32, batch / block: {paths}")

    emit({"phase": "bf16", "clip_s": CLIP_S, "main": main, "card_vs_cpu_bf16": host,
          "stages_device_ms": stages, "encoder_traces": traces, "copies": memory,
          "bf16_f0": f0_line,
          "batch_and_block": paths, "batch": list(batch.shape),
          "block_48k": 192 * 128})

    # K3's float32 entry (the staged path and training launch it): the calls
    # of one float32 conversion, against the plain version and timed
    with env("RVC_TPU_BF16", "0"), record_calls() as calls:
        rvc.infer(clip)
    k3_f32 = phase_kernels(calls, launches["0"], only=("rel_attention",))[0]
    p.source_noise = True
    return k3_f32, {"bf16_main": launches["1"], "f32_main": launches["0"],
                    "bf16_batch": paths["bfloat16"]["batch_launches"],
                    "bf16_block": paths["bfloat16"]["block_launches"]}


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
          "parity": gpu_cpu_corr(rvc, model_path, index_path, staged=True)})
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
    parity = {"clip_s": PARITY_S, "waveform_corr": corr, "policy": "float32 (staged path)",
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
                    "resblock_group_tp": 0, "resblock_chain_tp": 0,
                    "resblock_group_packed": 0, "adamw": 0}


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
LONG_LAUNCHES = {"resblock_group": 3, "resblock_chain": 9, "rel_attention": 6, "log_mel": 1,
                 "resblock_group_tp": 0, "resblock_chain_tp": 0,
                 "resblock_group_packed": 0, "adamw": 0}


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
    from rvc_tpu_torch.utils.device import compute_dtype

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
        hubert = p.models(compute_dtype(rvc.device))[0]
        audio_c = audio.to(compute_dtype(rvc.device))
        stages["HuBERT"] = cuda_ms(lambda: hubert(audio_c, output_hidden_states=True))
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
RT_LAUNCHES = {"resblock_group": 3, "resblock_chain": 9, "rel_attention": 6, "log_mel": 1,
               "resblock_group_tp": 0, "resblock_chain_tp": 0,
               "resblock_group_packed": 0, "adamw": 0}


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

    from rvc_tpu_torch.utils.device import compute_dtype

    rt = vc.vc_model
    p = rt.rvc.pipeline
    dtype = compute_dtype(p.device)
    hubert = p.models(dtype)[0]
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
        audio_c = audio.to(dtype)
        st["  HuBERT"] = cuda_ms(lambda: hubert(audio_c, output_hidden_states=True))
        feats = hubert(audio_c, output_hidden_states=True)
        t_feat = feats.shape[1] * 2
        pf = torch.nn.functional.pad(state[:, :t_feat], (0, max(0, t_feat - F)))
        lengths = torch.full((1,), min(F, t_feat), device=p.device)
        st["  synthesizer (K3, K1, K2)"] = cuda_ms(
            lambda: p._synthesize(feats, feats, lengths, sid, 0.5, coarse_f0_torch(pf), pf))
        traces = {"tail f0": trace_one(lambda: p.f0(tail, 0.0, 0.0)),
                  "HuBERT": trace_one(lambda: hubert(audio_c, output_hidden_states=True)),
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
    return {"policy": policy(p.device), "device_ms": st, "traces": traces, "host_ms": host,
            "t_feat": t_feat}


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
    eng = {k: VoiceChanger(rvc, silent_threshold=RT_GATE_DB).vc_model
           for k in ("staged", "fused")}
    eng["staged"]._fused_block_ok = lambda: False      # the other f0 methods' route
    corr = []
    for i in range(4):
        b = clip[i * bf: (i + 1) * bf]
        got = {}
        # the routes compared on one policy: the staged path runs float32
        # (as the reference's), so the fused block does too here
        with env("RVC_TPU_BF16", "0"):
            for k, e in eng.items():
                got[k] = e.inference(b, index_rate=0.0)[0]
        corr.append(float(np.corrcoef(got["staged"], got["fused"])[0, 1]))
        max_abs = float(np.abs(got["staged"] - got["fused"]).max())
        if not (corr[-1] > 0.999 and max_abs <= 5e-3):
            raise AssertionError(f"block {i}: staged against fused corr {corr[-1]}, "
                                 f"max |d| {max_abs}")
    checks["staged_vs_fused"] = {"blocks": 4, "policy": "float32", "min_corr": min(corr),
                                 "max_abs_last": max_abs}

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
    checks["gpu_vs_cpu"] = {"blocks": 4, "card_policy": policy(rvc.device),
                            "cpu_policy": policy("cpu"), "min_corr": min(corr),
                            "cpu_seconds": time.perf_counter() - t0}
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
TRAIN_LAUNCHES = {"resblock_group": 3, "resblock_chain": 9, "rel_attention": 6, "log_mel": 0,
                  "resblock_group_tp": 0, "resblock_chain_tp": 0,
                  "resblock_group_packed": 0, "adamw": 2}   # G's AdamW and D's
TRAIN_GRAD_BAR = 1e-5          # each Function's gradients against the plain autograd's
TRAIN_DEVICE = "cuda"          # a CPU rehearsal sets "cpu" and shrinks TRAIN_CFG
TRAIN_CFG = {}                 # get_config(48000, ...) overrides; none: full width


ADAMW = dict(name="AdamW adamw", entry="rvc_adamw", source="rvc_tpu_torch/csrc/adamw.cu",
             replaces="none: the optax chain XLA fuses in rvc_tpu/train/train_step.py",
             peak=PEAK_F32)
ADAMW_BAR = 1e-6      # rel_l2 per tensor: the norm, the parameters' change, both moments
# against `adamw_reference` with its own norm, whose last bit moves a parameter's
# rounding (about 1e-6 of a tensor's change) and flips bf16 roundings of the first moment
ADAMW_REF_BAR = {"p_change": 1e-5, "nu": 1e-5, "mu": 1e-5, "mu_bf16": 1e-4}
ADAMW_SLEEP_CYCLES = 50_000_000     # ~25 ms of a held stream: the host queues a whole call
ADAMW_FLOP = 20       # per parameter and step: the squares, the clip, the moments, the update
ADAMW_SPE = 5         # steps_per_epoch: the second of a case's two steps decays the rate
ADAMW_CASES = ((None, True), (None, False), (False, True))   # (gate, norm over 1)
ADAMW_ZERO_RANKS = 4  # ZeRO-1's slices of each data index of a four-card data axis
ADAMW_ZERO_CASES = ((None, True), (False, True))


def adamw_grads(shapes, seed: int, over: bool) -> list:
    """N(0, 1) gradients with a NaN first and +inf, -inf and 3e3 after it
    in every tenth tensor (the norm over 1); else N(0, 1e-5) with the NaN
    alone (under 1)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads = [torch.randn(s, device="cuda", generator=gen) * (1.0 if over else 1e-5)
             for s in shapes]
    for i, g in enumerate(grads):
        g = g.view(-1)
        g[:1] = float("nan")
        if over and i % 10 == 0 and g.numel() >= 4:
            g[1:4] = torch.tensor([float("inf"), -float("inf"), 3e3], device="cuda")
    return grads


def worst_rel_l2(got, ref) -> float:
    """The largest per-tensor rel_l2 of `got` against `ref` (0 where a pair
    is equal, inf where only the reference is all zero)."""
    import torch

    worst = 0.0
    for a, b in zip(got, ref):
        d = float(torch.linalg.vector_norm(a.double() - b.double()))
        if d:
            n = float(torch.linalg.vector_norm(b.double()))
            worst = max(worst, d / n if n else math.inf)
    return worst


def adamw_case(opt, mu_dtype, gate, over: bool, seed: int, given: bool = False) -> tuple:
    """Two steps of `ops.kernels.adamw` from copies of `opt`'s parameters,
    moments (of the views `opt._local` cuts: ZeRO-1's slices for a
    `ShardedAdamW`) of a run under way and the count one step before an
    epoch ends, each step from the same state as the plain version run on
    the card: `adamw_reference` on a layout of copies (its own sanitizing
    and norm, ADAMW_REF_BAR) and the plain loop `adamw_update` over the
    views given the kernel's norm (ADAMW_BAR); the parameters compared
    whole, so an element outside a view that moves shows too. With `given`
    the kernel and `adamw_reference` take the plain global norm of the
    sanitized gradients (tensor parallelism's path), which the kernel
    returns bit for bit. Returns the worst distances and their bars, then
    the kernel's layout, the last step's gradients, the count and the
    constants."""
    import torch

    from rvc_tpu_torch.ops.kernels import LAUNCHES
    from rvc_tpu_torch.ops.kernels import adamw as K

    def views(ts):
        return [opt._local(i, t) for i, t in enumerate(ts)]

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = [p.detach().clone() for p in opt.params]
    mu = [(1e-3 * torch.randn(v.shape, device="cuda", generator=gen)).to(mu_dtype)
          for v in views(params)]
    nu = [(1e-3 * torch.randn(v.shape, device="cuda", generator=gen)) ** 2
          for v in views(params)]
    count = torch.tensor(ADAMW_SPE - 1, dtype=torch.int32, device="cuda")
    h = opt.hyper._replace(b1_mu=torch.tensor(opt.hyper.b1, dtype=mu_dtype).item())
    layout, n = K.Layout(params, mu, nu, views(params)), len(params)
    flag = None if gate is None else torch.tensor(gate, device="cuda")
    out = dict(norm_vs_reference=0.0, norm_vs_float64=0.0, launches=0)
    shapes = [tuple(p.shape) for p in params]

    def state():
        return [t.clone() for t in params + mu + nu] + [count.clone()]

    for k in range(2):
        grads = adamw_grads(shapes, seed + 1 + k, over)
        before, ref, plain = state(), state(), state()
        clean = K.sanitize_grads(grads)
        exact = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in clean))
        norm_in = K.global_norm(clean) if given else None
        launches = LAUNCHES["adamw"]
        norm = K.adamw(layout, grads, count, h, flag, norm_in)
        ref_norm = K.adamw_reference(
            K.Layout(ref[:n], ref[n:2 * n], ref[2 * n:3 * n], views(ref[:n])), grads, ref[-1], h,
            flag, norm_in)
        K.adamw_update(views(plain[:n]), views(clean), plain[n:2 * n], plain[2 * n:3 * n],
                       plain[-1], h, norm, flag)
        del clean
        out["launches"] += LAUNCHES["adamw"] - launches      # the plain versions launch none
        got = params + mu + nu + [count]
        out["norm"] = float(norm)
        if given:
            out["norm_given"] = out.get("norm_given", True) and torch.equal(norm, norm_in)
        out["norm_vs_reference"] = max(out["norm_vs_reference"],
                                       worst_rel_l2([norm], [ref_norm]))
        out["norm_vs_float64"] = max(out["norm_vs_float64"], worst_rel_l2([norm], [exact]))
        out["count"] = [int(count), int(ref[-1]), int(plain[-1])]
        if gate is False:
            out["unchanged"] = all(torch.equal(a, b) for a, b in zip(got, before))
            out["reference_unchanged"] = all(torch.equal(a, b) for a, b in zip(ref, before))
            continue
        for side, other in (("plain", plain), ("reference", ref)):
            for name, lo, hi in (("mu", n, 2 * n), ("nu", 2 * n, 3 * n)):
                key = f"{name}_vs_{side}"
                out[key] = max(out.get(key, 0.0), worst_rel_l2(got[lo:hi], other[lo:hi]))
            key = f"p_change_vs_{side}"
            out[key] = max(out.get(key, 0.0), worst_rel_l2(
                [a - b for a, b in zip(params, before[:n])],
                [a - b for a, b in zip(other[:n], before[:n])]))
        del before, ref, plain
    want = ADAMW_SPE - 1 if gate is False else ADAMW_SPE + 1
    bars = {k: ADAMW_BAR for k in out
            if k.endswith(("_vs_plain", "_vs_float64")) or k == "norm_vs_reference"}
    for k in out:
        if k.endswith("_vs_reference") and k != "norm_vs_reference":
            name = k[:-len("_vs_reference")]
            bf16 = name == "mu" and mu_dtype == torch.bfloat16
            bars[k] = ADAMW_REF_BAR[name + ("_bf16" if bf16 else "")]
    out["ok"] = (all(out[k] <= b for k, b in bars.items()) and out["count"] == [want] * 3
                 and out["launches"] == 2 and out.get("unchanged", True)
                 and out.get("reference_unchanged", True) and out.get("norm_given", True)
                 and (out["norm"] > 1.0) == over)
    out["bars"] = bars
    return out, layout, grads, count, h


def held_stream_ms(fn, reps: int = 5) -> float:
    """Device ms of one fn() alone: CUDA events around it on a stream held
    by a sleeping kernel while the host queues the call (the median of
    reps), so the host's work before the launches is not timed."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(ADAMW_SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def adamw_line(net: str, opt, mu_dtype, cases: dict, timed: tuple) -> dict:
    """The `kernel` line of one optimizer's call (`timed`: a case's layout,
    gradients, count and constants): ms (CUDA events around one call, the
    host's work included), `held_stream_ms` (the call's device time by CUDA
    events; torch.profiler read these kernels at under half their bytes
    bound this late in the smoke), plain ms (`adamw_reference` on the
    card), the bytes bound: 4 B a parameter for the norm, then 20 B and
    two first moments an updated element (28 B with bf16, 32 with float32
    where every element is updated)."""
    import torch

    from rvc_tpu_torch.ops.kernels import adamw as K

    layout, grads, count, h = timed
    params, mu, nu = [[t.clone() for t in ts] for ts in (layout.params, layout.mu, layout.nu)]
    ref = K.Layout(params, mu, nu, [opt._local(i, t) for i, t in enumerate(params)])
    ref_count = count.clone()
    nparam = sum(p.numel() for p in layout.params)
    updated = sum(v.numel() for v in layout.local)
    nbytes = 4 * nparam + (20 + 2 * layout.mu[0].element_size()) * updated
    sharded = getattr(opt, "data", None)
    where = "" if sharded is None else f", ZeRO-1 data index {sharded.index} of {sharded.size}"
    line = {"phase": "kernel", "name": f"{ADAMW['name']} ({net}, "
            f"{str(mu_dtype).replace('torch.', '')} first moment{where})",
            "inputs": {"tensors": len(layout), "params": nparam, "updated": updated,
                       "strided": sum(r.rows > 1 for r in layout.rows),
                       "chunks": layout.n_chunks, "update_chunks": layout.n_update_chunks,
                       "chunk": K.CHUNK},
            "cases": cases,
            "ms": cuda_ms(lambda: K.adamw(layout, grads, count, h)),
            "held_stream_ms": held_stream_ms(lambda: K.adamw(layout, grads, count, h)),
            "plain_ms": cuda_ms(lambda: K.adamw_reference(ref, grads, ref_count, h))}
    line["bound_ms"], line["bound_by"] = bound(ADAMW_FLOP * nparam, nbytes, ADAMW["peak"])
    emit({**line, "bound": bound_text(ADAMW["peak"])})
    line["flop"], line["bytes"] = ADAMW_FLOP * nparam, nbytes
    return line


def phase_adamw() -> dict:
    """`ops.kernels.adamw` on the 48 kHz model's G and D at full width
    (random init from seed 0, their optimizers' constants from
    `make_optimizers` at ADAMW_SPE steps an epoch): for each and for bf16
    and float32 first moments, the ADAMW_CASES (gate None or False, the
    norm over or under 1) held by `adamw_case` at ADAMW_BAR (a False gate:
    nothing changes, bit for bit; the count advances only where the gate
    allows; one launch counted a call), and a `kernel` line (`adamw_line`).
    Then ZeRO-1's layouts of the same tensors (`parallel.train.ShardedAdamW`
    for each data index of ADAMW_ZERO_RANKS: slices along dim 0 and strided
    ones along dim 1, moments of the slices' size, the norm over the whole
    gradients), the ADAMW_ZERO_CASES for both moment types, one more case
    with the norm given, and a `kernel` line of data index 0's bf16 call.
    Returns the kernels line's entry: G's and D's one-card bf16 calls, one
    training step."""
    import torch

    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.discriminators import build_discriminator
    from rvc_tpu_torch.models.synthesizer import build_synthesizer
    from rvc_tpu_torch.parallel.mesh import Axis
    from rvc_tpu_torch.parallel.train import ShardedAdamW
    from rvc_tpu_torch.train.train_step import make_optimizers

    cfg = get_config(48000)
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        net_g, net_d = build_synthesizer(cfg, training=True), build_discriminator(cfg)
    opts = {("one card", net): opt for net, opt in
            zip("GD", make_optimizers(cfg, net_g, net_d, steps_per_epoch=ADAMW_SPE))}
    for k in range(ADAMW_ZERO_RANKS):
        zero = functools.partial(ShardedAdamW, data=Axis(ADAMW_ZERO_RANKS, k), model=Axis())
        opts.update({(f"data index {k}", net): opt for net, opt in
                     zip("GD", make_optimizers(cfg, net_g, net_d, steps_per_epoch=ADAMW_SPE,
                                               optimizer=zero))})
    del net_g, net_d
    total = dict(calls=0, flop=0, bytes=0, ms=0.0, plain_ms=0.0, held_stream_ms=0.0)
    failed = []
    for (where, net), opt in opts.items():
        one_card = where == "one card"
        for mu_dtype in (torch.bfloat16, torch.float32):
            cases = {}
            runs = [(gate, over, False) for gate, over in
                    (ADAMW_CASES if one_card else ADAMW_ZERO_CASES)]
            if where == "data index 1" and mu_dtype == torch.bfloat16:
                runs.append((None, True, True))
            for i, (gate, over, given) in enumerate(runs):
                res, layout, grads, count, h = adamw_case(opt, mu_dtype, gate, over,
                                                           SEED + 10 * i, given)
                cases[f"gate={gate} norm_{'over' if over else 'under'}_1"
                      + (" given" if given else "")] = res
                if not res["ok"]:
                    failed.append((where, net, str(mu_dtype), gate, over, given))
                if gate is None and over and not given:
                    timed = (layout, grads, count, h)
                del layout, grads, count
            if not one_card and (where != "data index 0" or mu_dtype != torch.bfloat16):
                emit({"phase": "adamw", "net": net, "where": where,
                      "first_moment": str(mu_dtype).replace("torch.", ""), "cases": cases})
                del timed
                continue
            line = adamw_line(net, opt, mu_dtype, cases, timed)
            if one_card and mu_dtype == torch.bfloat16:
                total["calls"] += 1
                for k in ("flop", "bytes", "ms", "plain_ms", "held_stream_ms"):
                    total[k] += line[k]
            del timed
    if failed:
        raise AssertionError(f"adamw: the kernel missed its plain version in {failed}")
    bound_ms, bound_by = bound(total["flop"], total["bytes"], ADAMW["peak"])
    return dict(name=ADAMW["name"] + " (bf16 first moment)", route="cuda",
                source=ADAMW["source"], entry=ADAMW["entry"], replaces=ADAMW["replaces"],
                launches=total["calls"], calls=total["calls"], ms=total["ms"],
                device_ms=None, held_stream_ms=total["held_stream_ms"],
                plain_ms=total["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, bound=bound_text(ADAMW["peak"]), library_ms=None)


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
    backward (the gradients), G's optimizer (which sanitizes them), D
    forward and backward, D's optimizer (ms each)."""
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
    `KernelFunction` with the plain version's bf16 emulation as the forward
    (bf16 conv operands, float32 sums) and the float32 plain autograd as
    the backward."""
    from rvc_tpu_torch.models import generators, layers
    from rvc_tpu_torch.ops.kernels import KernelFunction
    from rvc_tpu_torch.ops.kernels import resblock as KR

    def group(x, weights, kernel_sizes, dilations, slope=0.1):
        ks, ds = tuple(kernel_sizes), tuple(map(tuple, dilations))
        return KernelFunction.apply(
            lambda x, *w: KR.resblock_group_reference(x, w, ks, ds, slope, bf16_operands=True),
            lambda x, *w: KR.resblock_group_reference(x, w, ks, ds, slope), x, *weights)

    def chain(x, w1, b1, w2, b2, kernel_size, dilations=(1, 3, 5), slope=0.1):
        ds = tuple(dilations)
        return KernelFunction.apply(
            lambda *t: KR.resblock_chain_reference(*t, kernel_size, ds, slope,
                                                   bf16_operands=True),
            lambda *t: KR.resblock_chain_reference(*t, kernel_size, ds, slope),
            x, w1, b1, w2, b2)

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
TP_LAUNCHES = {"resblock_group": 3, "resblock_chain": 0, "rel_attention": 6, "log_mel": 0,
               "resblock_group_tp": 6, "resblock_chain_tp": 9,
               "resblock_group_packed": 0, "adamw": 2}   # G's AdamW and D's, as on one card
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


# ---------------------------------------------------------------------------
# the front ends: download, tts, the span tracer, K1's packed-lane entry
# ---------------------------------------------------------------------------

TTS_TEXT = "The quick brown fox jumps over the lazy dog."
TTS_VOICE = "en-US-AriaNeural"
# the kernel symbols a traced main-path conversion must show (demangled, spaces dropped)
TRACE_SYMBOLS = {"K1": ("wg::chains_kernel<128,true>", "wg::chains_kernel<64,true>",
                        "wg::chains_kernel<32,true>"),
                 "K2": ("wg::chains_kernel<256,false>",),
                 "K3": ("rel_attn_split_kernel",),
                 "K4": ("dft_mag_kernel", "mel_log_kernel")}
PACKED = dict(name="K1 resblock_group_packed", module="resblock", entry="rvc_resblock_chains",
              source="rvc_tpu_torch/csrc/resblock.cu",
              replaces="rvc_tpu/ops/pallas/resblock.py:451 resblock_group_packed",
              peak=PEAK_BF16, **BF16_BAR)


def sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


@contextlib.contextmanager
def served(root: str):
    """A `http.server` for `root` on 127.0.0.1 in a thread; yields its port."""
    import http.server
    import threading

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                             functools.partial(Quiet, directory=root))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def counted(fn) -> tuple:
    """fn()'s result and the kernel launches it made (counts zeroed before)."""
    import torch

    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def frontends_download(work: str, index_path: str, card: str) -> tuple:
    """A zip of the train phase's `voice.pth` and the retrieval phase's index,
    served on 127.0.0.1 and fetched by `download_model`: the extracted files'
    sha256 against the originals', then a 2 s clip converted on the card from
    the downloaded pair against the same conversion from the originals."""
    import zipfile

    import numpy as np

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.tools.download import download_model

    pth = os.path.join(work, "logs", "voice", "voice.pth")
    site, out_dir = os.path.join(work, "site"), os.path.join(work, "downloaded")
    os.makedirs(site)
    times = {}
    t0 = time.perf_counter()
    with zipfile.ZipFile(os.path.join(site, "voice.zip"), "w", zipfile.ZIP_STORED) as z:
        z.write(pth, "voice.pth")
        z.write(index_path, "voice.index")
    times["zip_s"] = time.perf_counter() - t0
    with served(site) as port:
        t0 = time.perf_counter()
        got = download_model(f"http://127.0.0.1:{port}/voice.zip", out_dir)
        times["download_s"] = time.perf_counter() - t0
    files = {"voice.pth": pth, "voice.index": index_path}
    sums = {name: {"original": sha256(orig), "downloaded": sha256(os.path.join(out_dir, name))}
            for name, orig in files.items()}
    if got != os.path.join(out_dir, "voice.zip") or any(
            v["original"] != v["downloaded"] for v in sums.values()):
        raise AssertionError(f"download: returned {got}, sha256 {sums}")
    t0 = time.perf_counter()
    rvc = RVC(model_path=os.path.join(out_dir, "voice.pth"),
              index_path=os.path.join(out_dir, "voice.index"), seed=SEED, device="cuda")
    times["load_s"] = time.perf_counter() - t0
    clip = test_clip(PARITY_S, SEED + 4)
    rvc.infer(clip)                                              # warm
    t0 = time.perf_counter()
    out, launches = counted(lambda: rvc.infer(clip))
    times["convert_s"] = time.perf_counter() - t0
    ref = RVC(model_path=pth, index_path=index_path, seed=SEED, device="cuda").infer(clip)
    corr = float(np.corrcoef(out, ref)[0, 1])
    emit({"phase": "frontends", "part": "download", "card": card,
          "zip_mb": os.path.getsize(os.path.join(site, "voice.zip")) / 1e6,
          "files": {k: os.path.getsize(v) for k, v in files.items()}, "sha256_equal": True,
          "times": times, "clip_s": PARITY_S, "samples": len(out),
          "corr_vs_original_files": corr, "launches": launches})
    if not (corr > 0.9999 and len(out) == len(ref) and np.isfinite(out).all()):
        raise AssertionError(f"download: the downloaded pair converts at corr {corr}")
    return rvc, launches


def stub_edge_tts(seed: int):
    """An `edge_tts` module whose `Communicate.save` writes a seeded 16 kHz
    chirp WAV (the real package needs a network); `said` keeps its calls."""
    import types

    from rvc_tpu_torch.utils.audio import save_wav

    mod = types.ModuleType("edge_tts")
    mod.said = []

    class Communicate:
        def __init__(self, text, voice, rate="+0%"):
            self.args = (text, voice, rate)

        async def save(self, path):
            mod.said.append(self.args)
            save_wav(path, test_clip(PARITY_S, seed), 16000)

    mod.Communicate = Communicate
    return mod


def frontends_tts(work: str, rvc, card: str) -> dict:
    """`cli tts` in a subprocess with `edge_tts` unimportable exits 2; then
    `tts_and_convert` through a stub `edge_tts` converts on the card."""
    import numpy as np

    from rvc_tpu_torch.tools.tts import tts_and_convert
    from rvc_tpu_torch.utils.audio import load_audio

    root = os.path.dirname(os.path.abspath(__file__))
    # `python -m rvc_tpu_torch.cli`, with edge_tts blocked whether or not it is installed
    cmd = [sys.executable, "-c", "import runpy, sys; sys.modules['edge_tts'] = None; "
           "runpy.run_module('rvc_tpu_torch.cli', run_name='__main__', alter_sys=True)",
           "tts", "--tts_text", TTS_TEXT, "--model_path", os.path.join(work, "voice.pth"),
           "--output_path", os.path.join(work, "never.wav")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
    refusal = {"returncode": res.returncode, "stderr": res.stderr.strip()[-300:],
               "seconds": time.perf_counter() - t0}
    if res.returncode != 2 or "edge-tts is not installed" not in res.stderr:
        raise AssertionError(f"tts without edge_tts: {refusal}")
    stub = stub_edge_tts(SEED + 5)
    saved = sys.modules.get("edge_tts")
    sys.modules["edge_tts"] = stub
    out_path, tts_wav = os.path.join(work, "tts_out.wav"), os.path.join(work, "tts_in.wav")
    t0 = time.perf_counter()
    got, launches = counted(lambda: tts_and_convert(rvc, TTS_TEXT, TTS_VOICE, out_path,
                                                    rate=10, tts_wav=tts_wav))
    seconds = time.perf_counter() - t0
    if saved is None:
        del sys.modules["edge_tts"]
    else:
        sys.modules["edge_tts"] = saved
    audio = load_audio(out_path, rvc.cfg.data.sample_rate)
    want = int(PARITY_S * rvc.cfg.data.sample_rate)
    emit({"phase": "frontends", "part": "tts", "card": card, "edge_tts": "stub",
          "refusal": refusal, "said": stub.said, "seconds": seconds, "samples": len(audio),
          "peak": float(np.abs(audio).max()), "launches": launches})
    if not (got == out_path and stub.said == [(TTS_TEXT, TTS_VOICE, "+10%")]
            and abs(len(audio) - want) <= 1 and np.isfinite(audio).all()
            and 0 < np.abs(audio).max() and all(launches[k] > 0 for k in KERNELS)):
        raise AssertionError(f"tts: wrote {got}, said {stub.said}, {len(audio)} samples "
                             f"(want {want}), launches {launches}")
    return launches


def trace_kernel_names(log_dir: str) -> list:
    """The CUDA kernel names in the Chrome trace `xprof_trace` wrote (spaces dropped)."""
    (name,) = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    names = set()
    for e in events:
        if str(e.get("cat", "")).lower() == "kernel":
            key = re.sub(r"^void\s+", "", e["name"].replace("(anonymous namespace)::", ""))
            names.add(re.match(r"[^(]*", key).group(0).replace(" ", ""))
    return sorted(names)


def frontends_trace(work: str, card: str) -> tuple:
    """The main path (the 48 kHz model at full width, seed 0) on the 13.5 s
    clip: one `RVC.infer` with RVC_TPU_TRACE=1 (the span summary), two under
    `xprof_trace` (the CUDA kernels it recorded: K1-K4's symbols must be
    there). Returns the launches of the traced run and the K1 calls of the
    warm run (for the packed part)."""
    import torch

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.ops.kernels import record_calls
    from rvc_tpu_torch.utils.profiling import global_tracer, xprof_trace

    rvc = RVC(config=get_config(48000), seed=SEED, device="cuda")
    clip = test_clip(CLIP_S, SEED)
    with record_calls() as calls:
        rvc.infer(clip)                                          # warm
    tracer = global_tracer()
    tracer.totals.clear()
    tracer.counts.clear()
    os.environ["RVC_TPU_TRACE"] = "1"
    t0 = time.perf_counter()
    _, launches = counted(lambda: rvc.infer(clip))
    wall_ms = 1e3 * (time.perf_counter() - t0)
    del os.environ["RVC_TPU_TRACE"]
    spans = tracer.summary()
    t0 = time.perf_counter()
    with xprof_trace(os.path.join(work, "xprof")) as log_dir:
        # two conversions: after earlier profiler sessions in the process the
        # trace can miss the first kernels after its start (K4's, in PR 11's run 1)
        for _ in range(2):
            rvc.infer(clip)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    names = trace_kernel_names(log_dir)
    found = {k: [s for s in syms if any(n.startswith(s) for n in names)]
             for k, syms in TRACE_SYMBOLS.items()}
    emit({"phase": "frontends", "part": "trace", "card": card, "clip_s": CLIP_S,
          "wall_ms": wall_ms, "spans": {k: {"count": v["count"], "mean_ms": v["mean_ms"]}
                                        for k, v in spans.items()},
          "launches": launches, "xprof_s": traced_s, "cuda_kernels": names,
          "k1_k4_symbols": found})
    want = {"host/highpass", "dispatch/fused_convert", "host/pad+upload", "dispatch/f0_program",
            "dispatch/conv_program", "fetch/materialize", "host/post", "rmvpe/bigru"}
    missing = {k: sorted(set(TRACE_SYMBOLS[k]) - set(v)) for k, v in found.items()
               if set(v) != set(TRACE_SYMBOLS[k])}
    if set(spans) != want or missing:
        raise AssertionError(f"trace: spans {sorted(spans)} (want {sorted(want)}), kernel "
                             f"symbols missing {missing}")
    k1 = [c for c in calls if c[0].__name__ == "resblock_group"]
    del rvc, calls
    return launches, k1


def packed_args(call) -> tuple:
    """A recorded K1 call's x (B, T, C) laid out as the packed (B, R, P * C),
    with its weights: `resblock_group_packed`'s positional arguments."""
    import torch

    _, args, kwargs = call
    a = inspect.signature(call[0]).bind(*args, **kwargs)
    a.apply_defaults()
    x = a.arguments["x"]
    B, T, C = x.shape
    P = 128 // C
    rows = -(-T // P)
    xp = torch.nn.functional.pad(x, (0, 0, 0, rows * P - T)).reshape(B, rows, P * C)
    return (xp.contiguous(), a.arguments["weights"], a.arguments["kernel_sizes"],
            a.arguments["dilations"], C, T, a.arguments["slope"])


def frontends_packed(k1_calls: list, card: str) -> dict:
    """`resblock_group_packed` at the main path's C = 128, 64, 32 stage
    shapes: one run of the three calls (its launches), then each call held
    against its plain version on its T valid steps at K1's bars, and timed
    as the `kernel` lines are. Returns the kernels line's entry."""
    import torch

    from rvc_tpu_torch.ops.kernels.resblock import (resblock_group_packed,
                                                    resblock_group_packed_reference)

    calls = [packed_args(c) for c in k1_calls]
    _, launches = counted(lambda: [resblock_group_packed(*a) for a in calls])
    if launches["resblock_group_packed"] != len(calls) or launches["resblock_group"]:
        raise AssertionError(f"packed: {len(calls)} calls launched {launches}")
    fn, plain, spec = resblock_group_packed, resblock_group_packed_reference, PACKED
    lines, total = [], dict(flop=0, bytes=0, ms=0.0, ms_queued=0.0, plain_ms=0.0,
                            plain_ms_queued=0.0, max_abs_err=0.0, emu_rel_l2=0.0)
    device = {}
    with torch.inference_mode():
        for args in calls:
            xp, weights, ks, ds, C, T, _ = args

            def valid(t, C=C, T=T):
                return t.reshape(t.shape[0], -1, C)[:, :T]

            def plain_valid(*a, **k):
                return valid(plain(*a, **k))

            got, ref = fn(*args), plain(*args)
            what = f"resblock_group_packed C={C} {list(xp.shape)}"
            if valid(got).shape != (xp.shape[0], T, C) or got.shape != xp.shape \
                    or bool(got.reshape(xp.shape[0], -1, C)[:, T:].any()):
                raise AssertionError(f"{what}: output {tuple(got.shape)} not the input's layout")
            cmp = compare(valid(got), valid(ref), spec["atol"], spec["rtol"], what,
                          spec["min_corr"])
            cmp.update(check_emulation(valid(got), plain_valid, args, {}, valid(xp),
                                       spec["emu_rel_l2"], what))
            del got, ref
            flop, _ = work("resblock_group", {"x": valid(xp), "weights": weights,
                                              "kernel_sizes": ks, "dilations": ds})
            nbytes = 4 * (2 * xp.numel() + sum(w.numel() for w in weights))
            line = {"inputs": {"x": list(xp.shape), "channels": C, "t_valid": T}, **cmp,
                    "ms": cuda_ms(lambda: fn(*args)),
                    "ms_queued": cuda_ms(lambda: fn(*args), calls=KERNEL_CALLS),
                    "plain_ms": cuda_ms(lambda: plain(*args)),
                    "plain_ms_queued": cuda_ms(lambda: plain(*args), calls=KERNEL_CALLS),
                    "device_ms": device_kernel_ms(lambda: fn(*args))}
            line["bound_ms"], line["bound_by"] = bound(flop, nbytes, spec["peak"])
            lines.append(line)
            total["flop"] += flop
            total["bytes"] += nbytes
            for k in ("ms", "ms_queued", "plain_ms", "plain_ms_queued"):
                total[k] += line[k]
            total["max_abs_err"] = max(total["max_abs_err"], cmp["max_abs"])
            total["emu_rel_l2"] = max(total["emu_rel_l2"], cmp["emu_rel_l2"])
            for k, t in line["device_ms"].items():
                device[k] = device.get(k, 0.0) + t
    emit({"phase": "frontends", "part": "packed", "card": card, "calls": lines,
          "launches": launches, "bound": bound_text(spec["peak"])})
    bound_ms, bound_by = bound(total.pop("flop"), total.pop("bytes"), spec["peak"])
    return dict(name=spec["name"], route="cuda", source=spec["source"], entry=spec["entry"],
                replaces=spec["replaces"], launches=launches["resblock_group_packed"],
                calls=len(calls), max_abs_err=total["max_abs_err"], ms=total["ms"],
                ms_queued=total["ms_queued"], device_ms=device, plain_ms=total["plain_ms"],
                plain_ms_queued=total["plain_ms_queued"], bound_ms=bound_ms,
                bound_by=bound_by, bound=bound_text(spec["peak"]), library_ms=None,
                emu_rel_l2=total["emu_rel_l2"],
                launches_by_path={"frontends_packed": launches["resblock_group_packed"]})


def phase_frontends(work: str, index_path: str) -> tuple:
    """download, tts, trace and packed (each raises on a failure). Returns
    the launches of their conversions by path and K1-packed's kernels entry."""
    card = card_line()
    t0 = time.perf_counter()
    rvc, download_launches = frontends_download(work, index_path, card)
    tts_launches = frontends_tts(work, rvc, card)
    del rvc
    trace_launches, k1_calls = frontends_trace(work, card)
    packed = frontends_packed(k1_calls, card)
    emit({"phase": "frontends", "part": "done", "card": card,
          "seconds": time.perf_counter() - t0})
    return {"frontends_download": download_launches, "frontends_tts": tts_launches,
            "frontends_trace": trace_launches}, packed


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
    wgmma = wgmma_count()
    emit({"phase": "wgmma", **wgmma})
    if not wgmma["counts"].get("chains_kernel<256,false>"):
        raise AssertionError(f"K2's kernel issues no wgmma: {wgmma}")

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
          "policy": policy(rvc.device), "launches": launches,
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
          "card_policy": policy(rvc.device), "cpu_policy": policy("cpu"),
          "waveform_corr": corr, "max_abs": float(np.abs(gpu - cpu).max()),
          "cpu_seconds": time.perf_counter() - t0})
    if not corr > 0.99:
        raise AssertionError(f"GPU vs CPU waveform corr {corr}")
    k3_f32, bf16_launches = phase_bf16(rvc, cpu_rvc)

    # the model's files (.pth, .index) live in the git-ignored build directory;
    # the retrieval phase's index is kept for the frontends phase
    kept = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        index_path, retrieval_launches = phase_retrieval(rvc, work)
        f0less_launches = phase_f0less(index_path, work)
        pitch_launches = phase_pitch(rvc, work)
        postfx_launches = phase_postfx(rvc, work)
        vocoder_launches = phase_vocoders(work)
        realtime_launches = phase_realtime(rvc, cpu_rvc, index_path)
        index_path = shutil.move(index_path, kept.name)
    del cpu_rvc
    longform_launches = phase_longform(rvc)
    mesh_launches = phase_longform_mesh(rvc)
    del rvc
    adamw_summary = phase_adamw()
    with kept, tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        train_launches = phase_train(work)
        ddp_launches, single = phase_ddp_gloo(work)
        tp_launches, tp_summary = phase_tp_gloo(work, single)
        del single
        nccl_launches = phase_ddp_nccl(work)
        phase_tp_nccl(work)
        phase_tools(work)
        frontend_launches, packed_summary = phase_frontends(work, index_path)
    by_path = {"pipeline": launches, "retrieval": retrieval_launches,
               "f0less": f0less_launches, **pitch_launches, "postfx": postfx_launches,
               **vocoder_launches, "longform": longform_launches, **realtime_launches,
               **train_launches, **mesh_launches, **ddp_launches, **tp_launches,
               **nccl_launches, **frontend_launches, **bf16_launches}
    for entry, name in [*zip(summary, KERNELS), (adamw_summary, "adamw")]:
        if name in ("resblock_group", "resblock_chain"):
            entry["wgmma"] = {"source": wgmma["source"], "counts": {
                k: v for k, v in wgmma["counts"].items() if k.startswith("chains_kernel")}}
        entry["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
    # one counter for both entries: the float32 line's own run is the float32 one
    k3_f32["launches_by_path"] = {"f32_main": bf16_launches["f32_main"]["rel_attention"]}
    summary += [k3_f32] + tp_summary + [packed_summary, adamw_summary]

    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
