"""Model blending, inspection, analysis and conversion (a host numpy copy
of `rvc_tpu/tools/model_tools.py`; upstream
`rvc/train/process/model_blender.py:17`, `model_information.py:15`,
`rvc*/lib/tools/analyzer.py:53`).

Models are read and written in the reference's native format: an upstream
`.pth` goes to `rvc_tpu`'s flat parameter paths through the port's own
converters (`synthesizer_from_pth`, then `synthesizer_to_jax`), so a blend
or a conversion writes the `.safetensors` the JAX package writes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from rvc_tpu_torch.utils import weights as W


def _native(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An upstream Synthesizer state dict -> `rvc_tpu`'s flat parameter
    paths and layouts (weight norm fused, enc_q kept where it is)."""
    return W.synthesizer_to_jax(W.synthesizer_from_pth(sd, enc_q=True))


def blend_models(path_a: str, path_b: str, ratio: float = 0.5,
                 out_path: str = "blended.safetensors") -> str:
    """Linear interpolation of two voice models: ratio*A + (1-ratio)*B.

    Accepts native safetensors or torch .pth; blends intersecting keys
    with matching shapes, keeps A's remaining keys.
    """
    def load(p):
        if p.endswith(".safetensors"):
            return W.load_params(p), None
        sd = W.load_torch_checkpoint(p)
        meta = sd.pop("__meta__", None)
        return _native(sd), meta

    a, meta_a = load(path_a)
    b, _ = load(path_b)
    out = {}
    for k, va in a.items():
        vb = b.get(k)
        if vb is not None and vb.shape == va.shape:
            out[k] = ratio * va + (1.0 - ratio) * vb
        else:
            out[k] = va
    cfg = None
    side = os.path.splitext(path_a)[0] + ".json"
    if os.path.exists(side):
        with open(side) as f:
            cfg = json.load(f)
    W.save_params(out, out_path, config=cfg)
    return out_path


def model_information(path: str) -> Dict:
    """Read model metadata: param count/shapes, config sidecar, upstream
    .pth metadata (epoch/step/sr/f0/version) when present."""
    info: Dict = {"path": path}
    if path.endswith(".safetensors"):
        flat = W.load_params(path)
        info["n_params"] = int(sum(v.size for v in flat.values()))
        info["n_tensors"] = len(flat)
        side = os.path.splitext(path)[0] + ".json"
        if os.path.exists(side):
            with open(side) as f:
                info["config"] = json.load(f)
        info["has_enc_q"] = any(k.startswith("enc_q") for k in flat)
        emb = flat.get("emb_g/weight")
        if emb is not None:
            info["speakers"] = int(emb.shape[0])
    elif path.endswith(".pth"):
        sd = W.load_torch_checkpoint(path)
        meta = sd.pop("__meta__", {})
        info["n_params"] = int(sum(np.asarray(v).size for v in sd.values()))
        info["n_tensors"] = len(sd)
        for k in ("sr", "f0", "version", "epoch", "step", "info"):
            if k in meta:
                v = meta[k]
                info[k] = v.tolist() if hasattr(v, "tolist") else v
        if "config" in meta:
            info["config_list"] = list(meta["config"])
    return info


def convert_model(pth_path: str, out_path: Optional[str] = None) -> str:
    """Upstream torch .pth inference checkpoint -> native safetensors with
    config sidecar (the `tools/convert_rvc_model.py` capability)."""
    from rvc_tpu_torch.api import config_from_pth_list
    from rvc_tpu_torch.configs import config_to_dict

    sd = W.load_torch_checkpoint(pth_path)
    meta = sd.pop("__meta__", {})
    params = _native(sd)
    cfg = None
    if "config" in meta:
        cfg = config_to_dict(config_from_pth_list(
            list(meta["config"]), use_f0=bool(meta.get("f0", 1))))
    out_path = out_path or os.path.splitext(pth_path)[0] + ".safetensors"
    W.save_params(params, out_path, config=cfg)
    return out_path


def _spectral_features(y: np.ndarray, sr: int, n_fft: int = 2048,
                       hop: int = 512):
    """Per-frame magnitude spectrogram + centroid/bandwidth/rolloff
    (the reference's librosa feature set, `analyzer.py:12-24`)."""
    n = 1 + max(len(y) - n_fft, 0) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    frames = np.pad(y, (0, max(idx.max() + 1 - len(y), 0)))[idx]
    mag = np.abs(np.fft.rfft(frames * np.hanning(n_fft)[None, :], axis=1))
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)
    msum = np.maximum(mag.sum(axis=1), 1e-12)
    cent = (mag * freqs[None, :]).sum(axis=1) / msum
    bw = np.sqrt((mag * (freqs[None, :] - cent[:, None]) ** 2).sum(axis=1) / msum)
    cum = np.cumsum(mag, axis=1)
    roll_idx = np.argmax(cum >= 0.85 * cum[:, -1:], axis=1)
    rolloff = freqs[roll_idx]
    return mag, cent, bw, rolloff


def save_analysis_plot(y: np.ndarray, sr: int, path: str,
                       plot_path: str) -> Optional[str]:
    """Reference 3-panel analysis figure (spectrogram / waveform /
    spectral features, `rvc/lib/tools/analyzer.py:53-80`). Uses
    matplotlib when importable; otherwise falls back to the tracker's
    dependency-free PNG writer with the spectrogram panel."""
    mag, cent, bw, rolloff = _spectral_features(y, sr)
    times = np.arange(len(cent)) * 512 / sr
    os.makedirs(os.path.dirname(plot_path) or ".", exist_ok=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(3, 1, figsize=(12, 10))
        fig.suptitle(f"Audio Analysis - {os.path.basename(path)}")
        db = 20 * np.log10(np.maximum(mag.T, 1e-8))
        axes[0].imshow(db, origin="lower", aspect="auto",
                       extent=[0, len(y) / sr, 0, sr / 2], cmap="viridis")
        axes[0].set_ylabel("Hz")
        axes[0].set_title("Spectrogram")
        t = np.arange(len(y)) / sr
        axes[1].plot(t, y, linewidth=0.4)
        axes[1].set_xlim(0, len(y) / sr)
        axes[1].set_title("Waveform")
        axes[2].plot(times, cent, label="centroid")
        axes[2].plot(times, bw, label="bandwidth")
        axes[2].plot(times, rolloff, label="rolloff")
        axes[2].set_xlim(0, len(y) / sr)
        axes[2].set_ylabel("Hz")
        axes[2].set_title("Spectral features")
        axes[2].legend(loc="upper right")
        fig.tight_layout()
        fig.savefig(plot_path, dpi=120)
        plt.close(fig)
        return plot_path
    except ImportError:
        from rvc_tpu_torch.monitoring.tracker import _write_png, spectrogram_image

        img = spectrogram_image(20 * np.log10(np.maximum(mag, 1e-8)))
        _write_png(plot_path, img.transpose(1, 2, 0).copy())
        return plot_path
    except Exception:
        return None


def analyze_audio(path: str, plot_path: Optional[str] = None) -> Dict:
    """Audio analyzer (reference `analyzer.py`): duration, RMS/peak dB,
    dominant frequency, spectral stats; optional 3-panel PNG. Loads any
    format `load_audio` can decode (soundfile/ffmpeg fallback), native
    sample rate for WAV."""
    from rvc_tpu_torch.utils import audio as au

    if path.lower().endswith(".wav"):
        y, sr = au.load_wav(path)
    else:
        sr = 44100
        y = au.load_audio(path, sr)
    y = au.to_mono(y)
    rms = float(np.sqrt(np.mean(y ** 2)))
    peak = float(np.abs(y).max())
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    freqs = np.fft.rfftfreq(len(y), 1 / sr)
    dom = float(freqs[int(np.argmax(spec[1:])) + 1]) if len(spec) > 1 else 0.0
    centroid = float((freqs * spec).sum() / max(spec.sum(), 1e-12))
    info = {
        "path": path, "sample_rate": int(sr), "samples": int(len(y)),
        "duration_s": round(len(y) / sr, 3),
        "rms_db": round(20 * np.log10(max(rms, 1e-12)), 2),
        "peak_db": round(20 * np.log10(max(peak, 1e-12)), 2),
        "dominant_freq_hz": round(dom, 1),
        "spectral_centroid_hz": round(centroid, 1),
    }
    if plot_path:
        info["plot_path"] = save_analysis_plot(y, sr, path, plot_path)
    return info
