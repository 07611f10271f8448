"""Top-level inference API (counterpart of `rvc_tpu/api.py`).

``RVC(config=get_config(48000), seed=0).infer(audio_16k)`` converts a clip
on the card. Weights are random, made from `seed`, unless port state dicts
are given (`utils.weights` carries `rvc_tpu` parameters across). Loading
upstream `.pth` / `.safetensors` files, retrieval and the audio effects
are not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from rvc_tpu_torch.configs import RVCConfig, get_config
from rvc_tpu_torch.models.hubert import HubertConfig, HubertModel
from rvc_tpu_torch.models.rmvpe import E2E
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.pipelines.offline import SAMPLE_RATE, Pipeline
from rvc_tpu_torch.utils import audio as audio_utils
from rvc_tpu_torch.utils.device import resolve_device, use_fp32_numerics


class RVC:
    """Voice model + HuBERT + RMVPE, wired into the offline pipeline.

    device: None runs on the card (and raises when there is none); pass
    "cpu" to run the kernels' plain PyTorch versions on the host.
    synthesizer_state / hubert_state / rmvpe_state: port state dicts,
    loaded with strict=True; each missing one is a seeded random init.
    """

    def __init__(self, config: Optional[RVCConfig] = None, seed: int = 0,
                 device=None, synthesizer_state: Optional[Mapping] = None,
                 hubert_state: Optional[Mapping] = None,
                 rmvpe_state: Optional[Mapping] = None,
                 source_noise: bool = True):
        self.device = resolve_device(device)
        use_fp32_numerics()
        self.cfg = config or get_config(48000)
        # init on the host from the seed, so every device gets the same weights
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            synth = build_synthesizer(self.cfg)
            hubert = HubertModel(HubertConfig())
            rmvpe = E2E()
        for module, state in ((synth, synthesizer_state), (hubert, hubert_state),
                              (rmvpe, rmvpe_state)):
            if state is not None:
                module.load_state_dict(state, strict=True)
            module.eval().requires_grad_(False).to(self.device)
        self.pipeline = Pipeline(self.cfg.data.sample_rate, synth, hubert, rmvpe,
                                 source_noise=source_noise)

    def infer(self, audio_16k: np.ndarray, sid: int = 0, pitch: float = 0.0,
              volume_envelope: float = 1.0, protect: float = 0.5,
              f0_autotune: bool = False, f0_autotune_strength: float = 1.0) -> np.ndarray:
        """16 kHz mono float array -> converted audio at the model's rate
        (RMVPE pitch, no retrieval)."""
        return self.pipeline.pipeline(
            np.asarray(audio_16k, dtype=np.float32), sid=sid, pitch_shift=pitch,
            volume_envelope=volume_envelope, protect=protect, f0_autotune=f0_autotune,
            f0_autotune_strength=f0_autotune_strength)

    def infer_file(self, audio_input: str, audio_output: str, **kwargs) -> str:
        """WAV (any rate) in, 16-bit WAV at the model's rate out."""
        out = self.infer(audio_utils.load_audio(audio_input, SAMPLE_RATE), **kwargs)
        audio_utils.save_wav(audio_output, out, self.cfg.data.sample_rate)
        return audio_output
