"""Training feature extraction (counterpart of `rvc_tpu/preprocess/features.py`).

Per sliced 16 kHz segment: f0 (RMVPE by default, any `PitchExtractor`
method), its coarse 1..255 bins, HuBERT's 768-wide hidden states, and the
linear spectrogram of the target-rate audio, written as `.npy` files under
the experiment directory. HuBERT, RMVPE (through K4's log-mel) and the
spectrogram run on `device` (the card unless "cpu"); segments of the same
length go through each network in one call (`process_batch`), with the
RMVPE output gated to 50-1,100 Hz as the single-file path gates it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from rvc_tpu_torch.configs import RVCConfig
from rvc_tpu_torch.models.hubert import HubertConfig, HubertModel
from rvc_tpu_torch.ops.stft import spectrogram
from rvc_tpu_torch.pipelines.offline import coarse_f0
from rvc_tpu_torch.pitch import PitchExtractor
from rvc_tpu_torch.utils import audio as audio_utils
from rvc_tpu_torch.utils.device import resolve_device, use_fp32_numerics


class FeatureExtractor:
    """hubert: a port `HubertModel` (used where it lives); None loads
    hubert_path, or builds a full-size random one from torch seed 0.
    pitch: a port `PitchExtractor` in place of one built for f0_method
    (RMVPE, CREPE and FCPE from torch seed 0) on `device`."""

    def __init__(self, exp_dir: str, cfg: RVCConfig, hubert: Optional[HubertModel] = None,
                 f0_method: str = "rmvpe", f0_hop_length: int = 160,
                 hubert_path: Optional[str] = None, *, pitch: Optional[PitchExtractor] = None,
                 device=None):
        self.exp_dir = exp_dir
        self.cfg = cfg
        self.device = resolve_device(device)
        use_fp32_numerics()
        self.dirs = {
            "f0": os.path.join(exp_dir, "f0"),
            "f0_voiced": os.path.join(exp_dir, "f0_voiced"),
            "features": os.path.join(exp_dir, "features"),
            "spec": os.path.join(exp_dir, "spec"),
        }
        for d in self.dirs.values():
            os.makedirs(d, exist_ok=True)
        self.pitch = pitch or PitchExtractor(f0_method, crepe_hop=f0_hop_length,
                                             device=self.device)
        if hubert is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                hubert = HubertModel(HubertConfig())
            if hubert_path:
                if not os.path.exists(hubert_path):
                    raise FileNotFoundError(f"HuBERT checkpoint not found: {hubert_path}")
                from rvc_tpu_torch.api import _load_hubert

                hubert.load_state_dict(_load_hubert(hubert_path), strict=True)
            hubert = hubert.eval().requires_grad_(False).to(self.device)
        self.hubert = hubert

    @torch.inference_mode()
    def _hubert(self, audio: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        return self.hubert(x, output_hidden_states=True).cpu().numpy()

    @torch.inference_mode()
    def _spec(self, audio: np.ndarray) -> np.ndarray:
        d = self.cfg.data
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        return spectrogram(x, d.filter_length, d.hop_length, d.win_length).cpu().numpy()

    def process_pair(self, name: str, wav16k_path: str, gt_wav_path: str) -> dict:
        """Extract every feature of one sliced segment; returns the paths."""
        a16 = audio_utils.load_audio(wav16k_path, 16000)
        f0 = self.pitch.extract(a16)
        feats = self._hubert(a16[None])[0]
        gt, _ = audio_utils.load_wav(gt_wav_path)
        spec = self._spec(audio_utils.to_mono(gt)[None])[0]             # (T, F)
        self._save(name, f0, feats, spec)
        return {k: os.path.join(d, name + ".npy") for k, d in self.dirs.items()}

    def _save(self, name: str, f0: np.ndarray, feats: np.ndarray, spec: np.ndarray) -> None:
        np.save(os.path.join(self.dirs["f0"], name + ".npy"), coarse_f0(f0))
        np.save(os.path.join(self.dirs["f0_voiced"], name + ".npy"), f0.astype(np.float32))
        np.save(os.path.join(self.dirs["features"], name + ".npy"), feats.astype(np.float32))
        np.save(os.path.join(self.dirs["spec"], name + ".npy"), spec.astype(np.float32))

    def process_batch(self, names, a16s, gts) -> None:
        """One same-length group, one call each of HuBERT, RMVPE and the
        spectrogram (`rvc_tpu/preprocess/features.py:111-127`)."""
        a = np.stack(a16s)
        feats = self._hubert(a)
        if self.pitch.method == "rmvpe":
            f0 = self.pitch._model.infer_from_audio(a, thred=0.03)
            f0 = np.where((f0 >= 50.0) & (f0 <= 1100.0), f0, 0.0)
        else:
            f0 = np.stack([self.pitch.extract(x) for x in a16s])
        spec = self._spec(np.stack(gts))
        for i, name in enumerate(names):
            self._save(name, f0[i], feats[i], spec[i])

    def process_all(self, batch_size: int = 8, cpu_cores: Optional[int] = None) -> int:
        """Every segment of `sliced_audios_16k` (with its target-rate twin in
        `sliced_audios`), grouped by exact 16 kHz length and batched up to
        batch_size; cpu_cores threads decode the audio. Returns the count."""
        w16 = os.path.join(self.exp_dir, "sliced_audios_16k")
        gt = os.path.join(self.exp_dir, "sliced_audios")
        files = [f for f in sorted(os.listdir(w16)) if f.endswith(".wav")]

        def _load(f):
            return audio_utils.load_audio(os.path.join(w16, f), 16000)

        if cpu_cores and cpu_cores > 1 and len(files) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=cpu_cores) as ex:
                audios = list(ex.map(_load, files))
        else:
            audios = [_load(f) for f in files]
        groups: dict = {}
        for f, a16 in zip(files, audios):
            groups.setdefault(len(a16), []).append((os.path.splitext(f)[0], a16, f))

        n = 0
        step = max(batch_size, 1)
        for _, items in sorted(groups.items()):
            for j in range(0, len(items), step):
                chunk = items[j: j + step]
                gts = [audio_utils.to_mono(audio_utils.load_wav(os.path.join(gt, f))[0])
                       for _, _, f in chunk]
                if len(chunk) > 1 and len({len(g) for g in gts}) == 1:
                    self.process_batch([c[0] for c in chunk], [c[1] for c in chunk], gts)
                    n += len(chunk)
                else:
                    for name, _, f in chunk:
                        self.process_pair(name, os.path.join(w16, f), os.path.join(gt, f))
                        n += 1
        return n
