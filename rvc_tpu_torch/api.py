"""Top-level inference API (counterpart of `rvc_tpu/api.py`).

``RVC("model.pth", index_path="model.index").infer_file("in.wav", "out.wav")``
converts a recording on the card with a user's voice model: an upstream
`.pth` inference checkpoint or a native `.safetensors` file with its
`.json` config sidecar, and the model's FAISS `.index` for retrieval. With
no model path the weights are random, made from `seed`. Around the
conversion, on the host as in the reference: formant shifting of the input,
splitting on silence, noise reduction, the post-processing effects and
non-WAV export.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from rvc_tpu_torch.configs import RVCConfig, config_from_dict, get_config
from rvc_tpu_torch.models.hubert import HubertConfig, HubertModel
from rvc_tpu_torch.models.rmvpe import E2E
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.pipelines.offline import SAMPLE_RATE, Pipeline
from rvc_tpu_torch.realtime.fx import build_fx_chain
from rvc_tpu_torch.retrieval import read_faiss_index
from rvc_tpu_torch.utils import audio as audio_utils
from rvc_tpu_torch.utils import weights as W
from rvc_tpu_torch.utils.device import resolve_device, use_fp32_numerics
from rvc_tpu_torch.utils.embedders import resolve_embedder
from rvc_tpu_torch.utils.formant import formant_shift
from rvc_tpu_torch.utils.noise import reduce_noise
from rvc_tpu_torch.utils.split_audio import merge_audio, split_silence_nonsilent


# Upstream .pth inference checkpoints carry an 18-element config list
# (`rvc/train/process/extract_model.py`): [spec_channels, segment_size,
# inter, hidden, filter, heads, layers, kernel, p_dropout, resblock,
# resblock_kernel_sizes, resblock_dilation_sizes, upsample_rates,
# upsample_initial_channel, upsample_kernel_sizes, spk_embed_dim,
# gin_channels, sr]
def config_from_pth_list(lst, use_f0: bool = True) -> RVCConfig:
    sr = lst[17]
    if isinstance(sr, str):  # some checkpoints store "48k"
        sr = {"32k": 32000, "40k": 40000, "48k": 48000}[sr]
    cfg = get_config(sr)
    return config_from_dict({
        "data": {"sample_rate": sr,
                 "filter_length": (lst[0] - 1) * 2,
                 "hop_length": cfg.data.hop_length,
                 "win_length": cfg.data.win_length,
                 "n_mel_channels": cfg.data.n_mel_channels},
        "model": {"inter_channels": lst[2], "hidden_channels": lst[3],
                  "filter_channels": lst[4], "n_heads": lst[5],
                  "n_layers": lst[6], "kernel_size": lst[7],
                  "p_dropout": lst[8],
                  "resblock": str(lst[9]),
                  "resblock_kernel_sizes": lst[10],
                  "resblock_dilation_sizes": lst[11],
                  "upsample_rates": lst[12],
                  "upsample_initial_channel": lst[13],
                  "upsample_kernel_sizes": lst[14],
                  "spk_embed_dim": lst[15], "gin_channels": lst[16],
                  "use_f0": use_f0},
        "train": {"segment_size": lst[1] if lst[1] > 100 else lst[1] * cfg.data.hop_length},
    })


def _load_model(model_path: Optional[str], config: Optional[RVCConfig]
                ) -> Tuple[RVCConfig, Optional[Mapping]]:
    """(config, synthesizer state dict or None for a random init)."""
    if not model_path:
        return config or get_config(48000), None
    if not os.path.exists(model_path):
        # never a random init on a mistyped path: that "converts" with noise
        raise FileNotFoundError(f"model checkpoint not found: {model_path}")
    if model_path.endswith(".safetensors"):
        sidecar = os.path.splitext(model_path)[0] + ".json"
        if config is None and os.path.exists(sidecar):
            with open(sidecar) as f:
                config = config_from_dict(json.load(f))
        return config or get_config(48000), W.synthesizer_from_jax(W.load_params(model_path))
    if model_path.endswith(".pth"):
        sd = W.load_torch_checkpoint(model_path)
        meta = sd.pop("__meta__")
        if config is None and "config" in meta:
            config = config_from_pth_list(list(meta["config"]), use_f0=bool(meta.get("f0", 1)))
        return config or get_config(48000), W.synthesizer_from_pth(sd)
    raise ValueError(f"unsupported model format {os.path.splitext(model_path)[1]!r} "
                     "(expected .safetensors or .pth)")


def _load_hubert(path: str) -> Mapping:
    """A HuBERT / ContentVec checkpoint -> the port's HuBERT state dict,
    without ContentVec's projection head: the pipeline reads the hidden
    states, as the reference does."""
    if path.endswith(".safetensors"):
        sd = W.hubert_from_jax(W.load_params(path))
    else:
        sd = W.hubert_from_pth(W.load_torch_checkpoint(path))
    return {k: v for k, v in sd.items() if not k.startswith("final_proj.")}


class RVC:
    """``RVC(model_path, index_path=...).infer_file(in_wav, out_wav, ...)``.

    model_path: an upstream `.pth` or a native `.safetensors` (with its
    `.json` sidecar); None builds a random model from `config` and `seed`.
    hubert_path: a HuBERT / ContentVec checkpoint; None resolves
    `embedder_model` (`utils/embedders.py`), and an absent contentvec is a
    seeded random HuBERT. index_path: the model's FAISS IVFFlat `.index`.
    A path that is given but missing raises FileNotFoundError.
    device: None runs on the card (and raises when there is none); pass
    "cpu" to run the kernels' plain PyTorch versions on the host.
    source_noise: the NSF source's noise on (True) or off (False); None
    leaves it to RVC_TPU_SOURCE_NOISE at each conversion ("0" turns it off).
    synthesizer_state / hubert_state / rmvpe_state: port state dicts in
    place of the checkpoints, loaded with strict=True.
    """

    def __init__(self, model_path: Optional[str] = None, config: Optional[RVCConfig] = None,
                 hubert_path: Optional[str] = None, index_path: Optional[str] = None,
                 seed: int = 0, embedder_model: str = "contentvec",
                 embedder_model_custom: Optional[str] = None, *, device=None,
                 source_noise: Optional[bool] = None, synthesizer_state: Optional[Mapping] = None,
                 hubert_state: Optional[Mapping] = None,
                 rmvpe_state: Optional[Mapping] = None):
        self.device = resolve_device(device)
        use_fp32_numerics()
        self.cfg, loaded = _load_model(model_path, config)
        if synthesizer_state is None:
            synthesizer_state = loaded
        elif loaded is not None:
            raise ValueError("give model_path or synthesizer_state, not both")
        if hubert_path is None:
            hubert_path = resolve_embedder(embedder_model, embedder_model_custom)
        elif not os.path.exists(hubert_path):
            raise FileNotFoundError(f"HuBERT checkpoint not found: {hubert_path}")
        if hubert_path and hubert_state is None:
            hubert_state = _load_hubert(hubert_path)
        if index_path and not os.path.exists(index_path):
            raise FileNotFoundError(f"index not found: {index_path}")
        self.index = read_faiss_index(index_path) if index_path else None
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
              f0_method: str = "rmvpe", index_rate: float = 0.75,
              volume_envelope: float = 1.0, protect: float = 0.5,
              f0_autotune: bool = False, f0_autotune_strength: float = 1.0,
              pitch_guidance: bool = True, input_f0: Optional[np.ndarray] = None,
              proposed_pitch: bool = False, proposed_pitch_threshold: float = 155.0,
              split_audio: bool = False, clean_audio: bool = False,
              clean_strength: float = 0.5, formant_shifting: bool = False,
              formant_qfrency: float = 1.0, formant_timbre: float = 1.0,
              post_process: bool = False, f0_hop_length: int = 160,
              **fx_kwargs) -> np.ndarray:
        """16 kHz mono float array -> converted audio at the model's rate.
        f0_method: rmvpe, crepe, crepe-tiny, fcpe, dio, pm, harvest or
        hybrid[a+b+...]; input_f0 (one f0 per 10 ms frame) replaces the
        extraction; proposed_pitch shifts toward proposed_pitch_threshold Hz;
        f0_hop_length is CREPE's analysis hop. index_rate applies only when
        the model has an index; an f0-less model converts without pitch.

        On the host, in the reference's order: formant_shifting (with a
        timbre other than 1) warps the input's envelope; split_audio
        converts each non-silent interval apart and merges them back;
        clean_audio gates stationary noise at clean_strength; post_process
        runs the effects that fx_kwargs turn on (`realtime.fx.build_fx_chain`).
        """
        audio_16k = np.asarray(audio_16k, dtype=np.float32)
        if formant_shifting and formant_timbre != 1.0:
            audio_16k = formant_shift(audio_16k, SAMPLE_RATE, formant_qfrency, formant_timbre)

        def convert(a: np.ndarray) -> np.ndarray:
            return self.pipeline.pipeline(
                a, sid=sid, pitch_shift=pitch, f0_method=f0_method, index=self.index,
                index_rate=index_rate if self.index is not None else 0.0,
                pitch_guidance=pitch_guidance and self.cfg.model.use_f0,
                volume_envelope=volume_envelope, protect=protect, f0_autotune=f0_autotune,
                f0_autotune_strength=f0_autotune_strength, input_f0=input_f0,
                proposed_pitch=proposed_pitch, proposed_pitch_threshold=proposed_pitch_threshold,
                f0_hop_length=f0_hop_length)

        sr = self.cfg.data.sample_rate
        if split_audio:
            intervals, segments = split_silence_nonsilent(audio_16k, SAMPLE_RATE)
            out = merge_audio(intervals, [convert(s) for s in segments], len(audio_16k),
                              SAMPLE_RATE, sr)
        else:
            out = convert(audio_16k)
        if clean_audio:
            out = reduce_noise(out, sr, clean_strength)
        if post_process:
            out = build_fx_chain(**fx_kwargs)(out, sr)
        return out

    def infer_file(self, audio_input: str, audio_output: str, export_format: str = "WAV",
                   **kwargs) -> str:
        """An audio file (any rate) in, the converted audio at the model's
        rate out: a 16-bit WAV at audio_output, or for MP3 / FLAC / OGG /
        M4A audio_output's stem with that extension, through soundfile or
        the ffmpeg binary (RuntimeError when neither can). Returns the path
        written."""
        out = self.infer(audio_utils.load_audio(audio_input, SAMPLE_RATE), **kwargs)
        if export_format.upper() != "WAV":
            return audio_utils.encode_audio(out, self.cfg.data.sample_rate,
                                            os.path.splitext(audio_output)[0], export_format)
        audio_utils.save_wav(audio_output, out, self.cfg.data.sample_rate)
        return audio_output
