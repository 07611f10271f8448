"""Audio I/O and host-side DSP (a copy of `rvc_tpu/utils/audio.py`; the port
imports nothing of `rvc_tpu`).

Capability parity with `rvc_mlx/lib/utils.py` (`load_audio`,
`load_audio_16k`) and the pipeline's filter stage
(`rvc_mlx/infer/pipeline_mlx.py:284`): WAV read/write (our own
stdlib+scipy path — no soundfile/ffmpeg dependency; both are used
transparently when installed), polyphase resampling, butterworth
high-pass filtfilt, RMS envelope matching, peak normalization."""

from __future__ import annotations

import os
import wave
from typing import Tuple

import numpy as np
from scipy import signal


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono-or-multichannel (T,) or (T, C), sr).

    Handles PCM 8/16/24/32-bit and IEEE float via scipy, falling back to
    the stdlib wave module.
    """
    try:
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            audio = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            audio = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            audio = (data.astype(np.float32) - 128.0) / 128.0
        else:
            audio = data.astype(np.float32)
        return audio, sr
    except Exception:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            ch = w.getnchannels()
            raw = w.readframes(n)
        if width == 2:
            audio = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            audio = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
        elif width == 1:
            audio = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif width == 3:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals & 0x800000, vals - 0x1000000, vals)
            audio = vals.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported sample width {width}")
        if ch > 1:
            audio = audio.reshape(-1, ch)
        return audio, sr


def save_wav(path: str, audio: np.ndarray, sr: int, subtype: str = "PCM_16") -> None:
    from scipy.io import wavfile

    audio = np.asarray(audio)
    if subtype == "PCM_16":
        data = np.clip(audio, -1.0, 1.0)
        data = (data * 32767.0).astype(np.int16)
    elif subtype == "FLOAT":
        data = audio.astype(np.float32)
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    wavfile.write(path, sr, data)


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim == 2:
        return audio.mean(axis=1)
    return audio


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """High-quality polyphase resampling (soxr-class via scipy)."""
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    from math import gcd

    g = gcd(int(orig_sr), int(target_sr))
    out = signal.resample_poly(audio.astype(np.float64),
                               target_sr // g, orig_sr // g, axis=-1)
    return out.astype(np.float32)


def load_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """Load any supported audio file as float32 mono at `sample_rate`.

    WAV natively; other formats via soundfile when available.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        audio, sr = load_wav(path)
    else:
        try:
            import soundfile as sf

            audio, sr = sf.read(path, dtype="float32")
        except ImportError as e:
            raise ValueError(
                f"non-WAV input {ext!r} requires soundfile; convert to wav first"
            ) from e
    audio = to_mono(np.asarray(audio, dtype=np.float32))
    return resample(audio, sr, sample_rate)


def load_audio_16k(path: str) -> np.ndarray:
    return load_audio(path, 16000)


def highpass_filter(audio: np.ndarray, sr: int = 16000, cutoff: float = 48.0,
                    order: int = 5) -> np.ndarray:
    """Butterworth high-pass with zero-phase filtfilt (reference
    `pipeline_mlx.py:284`)."""
    bh, ah = signal.butter(order, cutoff, btype="high", fs=sr)
    return signal.filtfilt(bh, ah, audio).astype(np.float32)


def rms_envelope(audio: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame RMS, centered (librosa.feature.rms semantics)."""
    pad = frame_length // 2
    a = np.pad(np.asarray(audio, dtype=np.float32), (pad, pad))
    n = 1 + (len(a) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n)[:, None]
    frames = a[idx]
    return np.sqrt(np.mean(frames ** 2, axis=1))


def change_rms(source_audio: np.ndarray, source_rate: int,
               target_audio: np.ndarray, target_rate: int,
               rate: float) -> np.ndarray:
    """Volume-envelope transfer (`AudioProcessor.change_rms`,
    `rvc_mlx/infer/pipeline_mlx.py:17-56`): scale target by
    rms_src^(1-rate) * rms_tgt^(rate-1), interpolated per sample."""
    rms1 = rms_envelope(source_audio, source_rate // 2 * 2, source_rate // 2)
    rms2 = rms_envelope(target_audio, target_rate // 2 * 2, target_rate // 2)
    t_out = target_audio.shape[0]

    def interp(r):
        return np.interp(np.linspace(0, 1, t_out), np.linspace(0, 1, len(r)), r)

    r1 = interp(rms1)
    r2 = np.maximum(interp(rms2), 1e-6)
    factor = np.power(r1, 1 - rate) * np.power(r2, rate - 1)
    return (target_audio * factor).astype(np.float32)


def peak_normalize(audio: np.ndarray, peak: float = 0.99) -> np.ndarray:
    m = np.abs(audio).max() / peak
    if m > 1:
        return (audio / m).astype(np.float32)
    return audio.astype(np.float32)


def encode_audio(audio: np.ndarray, sr: int, base_path: str,
                 export_format: str) -> str:
    """Encode to a non-WAV container (MP3/FLAC/OGG/M4A).

    Tries soundfile, then the ffmpeg binary (the reference's converter,
    `rvc/infer/infer.py:320-338`). Raises RuntimeError when neither is
    available — the CLI must not claim one format and write another.
    """
    fmt = export_format.upper()
    path = base_path + "." + fmt.lower()
    sf_err = None
    try:
        import soundfile as sf

        sf.write(path, audio, sr, format=fmt)
        return path
    except ImportError:
        pass
    except Exception as e:
        # libsndfile cannot encode every allowed format (M4A/AAC never,
        # MP3 only in recent builds) — fall through to ffmpeg, the
        # reference's encoder, before giving up
        sf_err = e
    import shutil
    import subprocess
    import tempfile

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as t:
            tmp = t.name
        try:
            save_wav(tmp, audio, sr)
            subprocess.run([ffmpeg, "-y", "-loglevel", "error", "-i", tmp,
                            path], check=True)
            return path
        finally:
            os.unlink(tmp)
    detail = f" (soundfile: {sf_err})" if sf_err else ""
    raise RuntimeError(
        f"cannot export {fmt}: no working encoder — soundfile "
        f"{'failed' if sf_err else 'is not installed'} and no ffmpeg "
        f"binary is available{detail}. Install one of them, or use "
        f"--export_format WAV.")
