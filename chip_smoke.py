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
            same inputs (TF32 off), max_abs / rel_l2 / tolerance, ms for
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
Then the `kernels` summary line (per kernel: the sums over its calls; the
launches of each path's run beside the main path's), the card line, and
last {"ok": true, "device": {...}}. Any failed check raises: the exit code
is non-zero and the last line is not printed. Without a CUDA device, or
run outside the repository, it fails before printing any result.
"""

from __future__ import annotations

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


def check_emulation(got, plain, args, kwargs, x, bar: float, what: str) -> dict:
    """K1/K2 against the plain version's bf16 emulation run in float64 (exact
    sums), on the output and on its update (output - x), which the residual
    cannot dilute: rel_l2 <= max(bar, 2 x the float32 emulation's)."""
    import torch

    f64 = torch.float64
    exact = plain(*cast(args, f64), **cast(kwargs, f64), bf16_operands=True)
    emu = plain(*args, **kwargs, bf16_operands=True).double()
    got, x = got.double(), x.double()
    out = {"emu_rel_l2": rel_l2(got, exact), "emu_update_rel_l2": rel_l2(got - x, exact - x),
           "cudnn_emu_rel_l2": rel_l2(emu, exact),
           "cudnn_emu_update_rel_l2": rel_l2(emu - x, exact - x)}
    if not (out["emu_rel_l2"] <= max(bar, 2 * out["cudnn_emu_rel_l2"]) and
            out["emu_update_rel_l2"] <= max(bar, 2 * out["cudnn_emu_update_rel_l2"])):
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
        if name == "rel_attention":  # rows past the length differ by design
            T = a["q"].shape[2]
            valid = torch.arange(T, device=got.device)[None, :] < a["key_lens"].to(got.device)[:, None]
            got, ref = got * valid[:, None, :, None], ref * valid[:, None, :, None]
        desc = describe(a)
        what = f"{name} {desc}"
        cmp = compare(got, ref, spec["atol"], spec["rtol"], what, spec.get("min_corr"))
        if "emu_rel_l2" in spec:
            cmp.update(check_emulation(got, plain, args, kwargs, a["x"],
                                       spec["emu_rel_l2"], what))
        checked.append((fn, args, kwargs, plain, a, desc, cmp))
        del got, ref
    return checked


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
    from rvc_tpu_torch.pipelines.offline import coarse_f0, upsample_protect
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
        pitch = coarse_f0(f0)
        st["synthesizer"] = cuda_ms(lambda: synth.infer(phone, lengths, pitch, f0, sid))
        m_p, _, x_mask = synth.enc_p(phone, pitch, lengths)
        g = synth.emb_g(sid)[:, None, :]
        st["  enc_p (K3)"] = cuda_ms(lambda: synth.enc_p(phone, pitch, lengths))
        st["  flow"] = cuda_ms(lambda: synth.flow(m_p * x_mask, x_mask, g=g))
        z = synth.flow(m_p * x_mask, x_mask, g=g) * x_mask
        st["  decoder (K1, K2)"] = cuda_ms(lambda: synth.dec(z, f0, g=g))
    emit({"phase": "stages", "clip_s": CLIP_S, "host_prep_ms": host_ms, "device_ms": st})


def timed_conversion(rvc, clip, **kwargs) -> tuple:
    """(output, wall ms, launches) of one conversion after a warm call, the
    launch counts set to 0 just before it and read just after."""
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
    want = int(CLIP_S * rvc.cfg.data.sample_rate)
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
    missing = [k for k, n in launches.items() if n <= 0]
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
    wrong = {k: n for k, n in launches.items() if (n > 0) != (k != "log_mel")}
    if wrong:
        raise AssertionError(f"the f0-less path launched {launches}: K1-K3 > 0, K4 = 0 expected")
    with record_calls() as calls:
        rvc.infer(clip, index_rate=INDEX_RATE)
    with torch.inference_mode():
        checked = check_calls(calls)
    held = {}
    for fn, _, _, _, _, _, cmp in checked:
        h = held.setdefault(fn.__name__, {"calls": 0, "max_abs": 0.0, "rel_l2": 0.0})
        h["calls"] += 1
        for k in ("max_abs", "rel_l2", "emu_rel_l2", "emu_update_rel_l2"):
            if k in cmp:
                h[k] = max(h.get(k, 0.0), cmp[k])
    del calls, checked
    emit({"phase": "f0less", "config": "get_config(40000, model_use_f0=False)",
          "decoder_channels": [m.out_channels for m in rvc.pipeline.synthesizer.dec.ups],
          "clip_s": CLIP_S, "index_rate": INDEX_RATE, "wall_ms": wall_ms,
          "realtime_x": CLIP_S * 1e3 / wall_ms, "launches": launches, "checked": held,
          "parity": gpu_cpu_corr(rvc, model_path, index_path)})
    return launches


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
    missing = [k for k, n in launches.items() if n <= 0]
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
    del cpu_rvc

    # the model's files (.pth, .index) live in the git-ignored build directory
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        index_path, retrieval_launches = phase_retrieval(rvc, work)
        f0less_launches = phase_f0less(index_path, work)
    for entry, name in zip(summary, KERNELS):
        entry["launches_by_path"] = {"pipeline": launches[name],
                                     "retrieval": retrieval_launches[name],
                                     "f0less": f0less_launches[name]}

    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
