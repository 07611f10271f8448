"""Experiment tracking (a copy of `rvc_tpu/monitoring/tracker.py`, host
Python; the port imports nothing of `rvc_tpu`).

Capability parity with the reference's observability stack:
`rvc_mlx/monitoring/aim_tracker.py:32-317` (Aim tracker with scalars,
audio, spectrogram images, hparams and a JSONL `SimpleTracker`
fallback) and the torch trainer's tensorboard logging
(`rvc/train/train.py:790-830,838-900`: rolling-window scalar averages,
mel-spectrogram images, eval audio).

Backends, richest first: Aim (when installed), TensorBoard (via
torch.utils.tensorboard, where it imports), JSONL (always).
All share one interface: log_params / log_metrics / log_audio /
log_image / log_spectrogram / close.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np


def spectrogram_image(mel: np.ndarray) -> np.ndarray:
    """(T, n_mels) or (n_mels, T) log-mel -> (3, H, W) uint8 viridis-ish
    image (low→dark blue, high→yellow), no matplotlib needed."""
    m = np.asarray(mel, dtype=np.float32)
    if m.ndim != 2:
        raise ValueError(f"expected 2-D mel, got {m.shape}")
    if m.shape[0] > m.shape[1]:  # (T, M) -> (M, T)
        m = m.T
    m = m[::-1]  # low frequencies at the bottom
    lo, hi = float(m.min()), float(m.max())
    x = (m - lo) / (hi - lo) if hi > lo else np.zeros_like(m)
    # 5-stop viridis approximation
    stops = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                      [94, 201, 98], [253, 231, 37]], dtype=np.float32)
    pos = x * (len(stops) - 1)
    i0 = np.clip(pos.astype(np.int32), 0, len(stops) - 2)
    frac = (pos - i0)[..., None]
    rgb = stops[i0] * (1 - frac) + stops[i0 + 1] * frac
    return rgb.astype(np.uint8).transpose(2, 0, 1)


class RollingMean:
    """Rolling-window scalar averages (the torch trainer logs the mean of
    the last 50 steps, `rvc/train/train.py:790-830`)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._buf: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def update(self, metrics: Dict[str, float]) -> Dict[str, float]:
        out = {}
        for k, v in metrics.items():
            v = float(v)
            if np.isfinite(v):
                self._buf[k].append(v)
            if self._buf[k]:
                out[k] = sum(self._buf[k]) / len(self._buf[k])
        return out


class SimpleTracker:
    """JSONL metrics logger (always available)."""

    def __init__(self, log_dir: str, run_name: str = "run"):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, f"{run_name}_metrics.jsonl")
        self.hparams_path = os.path.join(log_dir, f"{run_name}_hparams.json")
        self._t0 = time.time()

    def log_params(self, params: Dict) -> None:
        with open(self.hparams_path, "w") as f:
            json.dump(params, f, indent=2, default=str)

    def log_metrics(self, metrics: Dict, step: int, context: Optional[Dict] = None) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 2),
               **{k: float(v) for k, v in metrics.items()}}
        if context:
            rec["context"] = context
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_audio(self, name: str, audio, sr: int, step: int) -> None:
        from rvc_tpu_torch.utils.audio import save_wav

        d = os.path.join(self.log_dir, "audio")
        os.makedirs(d, exist_ok=True)
        name = name.replace("/", "_")
        save_wav(os.path.join(d, f"{name}_step{step}.wav"), audio, sr)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        """(3, H, W) uint8 -> PNG (stdlib zlib writer, no pillow)."""
        d = os.path.join(self.log_dir, "images")
        os.makedirs(d, exist_ok=True)
        name = name.replace("/", "_")
        _write_png(os.path.join(d, f"{name}_step{step}.png"),
                   np.asarray(image).transpose(1, 2, 0))

    def log_spectrogram(self, name: str, mel: np.ndarray, step: int) -> None:
        self.log_image(name, spectrogram_image(mel), step)

    def close(self) -> None:
        pass


def _write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal PNG encoder for (H, W, 3) uint8 (stdlib only)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


class TensorBoardTracker(SimpleTracker):
    """TensorBoard backend (scalars + mel images + eval audio, matching
    `rvc/train/train.py:838-900`). Also mirrors everything to JSONL so
    offline tooling keeps working."""

    def __init__(self, log_dir: str, run_name: str = "run"):
        super().__init__(log_dir, run_name)
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(os.path.join(log_dir, "tb", run_name))

    def log_params(self, params: Dict) -> None:
        super().log_params(params)
        self.writer.add_text("hparams", json.dumps(params, indent=2,
                                                   default=str))

    def log_metrics(self, metrics: Dict, step: int, context: Optional[Dict] = None) -> None:
        super().log_metrics(metrics, step, context)
        prefix = (context or {}).get("subset", "train")
        for k, v in metrics.items():
            self.writer.add_scalar(f"{prefix}/{k}", float(v), step)

    def log_audio(self, name: str, audio, sr: int, step: int) -> None:
        super().log_audio(name, audio, sr, step)
        a = np.asarray(audio, dtype=np.float32).reshape(1, -1)
        peak = np.abs(a).max()
        if peak > 1:
            a = a / peak
        self.writer.add_audio(name, a, step, sample_rate=sr)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        super().log_image(name, image, step)
        self.writer.add_image(name, np.asarray(image), step)

    def close(self) -> None:
        self.writer.close()


class AimTracker(SimpleTracker):
    """Aim backend (`rvc_mlx/monitoring/aim_tracker.py:32-269`)."""

    def __init__(self, log_dir: str, run_name: str = "run"):
        super().__init__(log_dir, run_name)
        import aim

        self._aim = aim
        self.run = aim.Run(repo=log_dir, experiment=run_name)

    def log_params(self, params: Dict) -> None:
        super().log_params(params)
        self.run["hparams"] = {k: str(v) for k, v in params.items()}

    def log_metrics(self, metrics: Dict, step: int, context: Optional[Dict] = None) -> None:
        super().log_metrics(metrics, step, context)
        for k, v in metrics.items():
            self.run.track(float(v), name=k, step=step, context=context or {})

    def log_audio(self, name: str, audio, sr: int, step: int) -> None:
        super().log_audio(name, audio, sr, step)
        self.run.track(self._aim.Audio(np.asarray(audio), rate=sr),
                       name=name, step=step)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        super().log_image(name, image, step)
        self.run.track(
            self._aim.Image(np.asarray(image).transpose(1, 2, 0)),
            name=name, step=step)

    def close(self) -> None:
        self.run.close()


class NullTracker:
    """No-op tracker for non-zero hosts (file writes are rank-0-only)."""

    def log_params(self, params):
        pass

    def log_metrics(self, metrics, step, context=None):
        pass

    def log_audio(self, name, audio, sr, step):
        pass

    def log_image(self, name, image, step):
        pass

    def log_spectrogram(self, name, mel, step):
        pass

    def close(self):
        pass


def create_tracker(log_dir: str, run_name: str = "run",
                   use_aim: bool = False, use_tensorboard: Optional[bool] = None):
    """Pick the richest available backend. `use_aim=True` requires aim to
    be installed and raises otherwise (a silent JSONL downgrade is how
    metrics get lost). `use_tensorboard=None` means auto-detect."""
    if use_aim:
        try:
            import aim  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "use_aim=True but the `aim` package is not installed; "
                "install aim or drop the flag (TensorBoard/JSONL backends "
                "remain available)") from e
        return AimTracker(log_dir, run_name)
    if use_tensorboard is None:
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: F401

            use_tensorboard = True
        except Exception:
            use_tensorboard = False
    if use_tensorboard:
        return TensorBoardTracker(log_dir, run_name)
    return SimpleTracker(log_dir, run_name)
