"""Frozen dataclass configs for RVC models, data and training.

Mirrors the capability of the reference's per-sample-rate JSON configs
(`rvc/configs/{32000,40000,48000}.json`) and the `HParams` attr-dict
(`rvc/train/utils.py:222`), as typed, hashable dataclasses. A copy of
`rvc_tpu/configs/config.py`: the port imports nothing of `rvc_tpu`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    max_wav_value: float = 32768.0
    sample_rate: int = 48000
    filter_length: int = 2048  # n_fft of the training linear spectrogram
    hop_length: int = 480
    win_length: int = 2048
    n_mel_channels: int = 128
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None

    @property
    def spec_channels(self) -> int:
        return self.filter_length // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    text_enc_hidden_dim: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.0
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    upsample_rates: Tuple[int, ...] = (12, 10, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (24, 20, 4, 4)
    use_spectral_norm: bool = False
    gin_channels: int = 256
    spk_embed_dim: int = 109
    use_f0: bool = True
    vocoder: str = "HiFi-GAN"  # HiFi-GAN | MRF HiFi-GAN | RefineGAN
    checkpointing: bool = False  # rematerialize the decoder in training


@dataclass(frozen=True)
class TrainConfig:
    log_interval: int = 200
    seed: int = 1234
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.999875
    segment_size: int = 17280  # in samples at target sr
    c_mel: float = 45.0
    c_kl: float = 1.0
    # extensions over the JSON surface (MLX trainer semantics,
    # rvc_mlx/train/trainer.py:70-124)
    batch_size: int = 8
    warmup_epochs: int = 0
    d_lr_scale: float = 1.0
    d_loss_threshold: float = 0.0  # skip D update while its loss < threshold (0 = off)
    d_step_per_g_step: int = 1     # extra D updates per G update (rvc/train/train.py)
    grad_clip_norm: float = 1000.0
    use_bf16: bool = True


@dataclass(frozen=True)
class RVCConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @property
    def segment_frames(self) -> int:
        return self.train.segment_size // self.data.hop_length


@dataclass(frozen=True)
class PipelineConfig:
    """Offline-pipeline chunking knobs (reference `rvc/configs/config.py:51-55`).

    x_* are in seconds at the 16 kHz analysis rate: reflect-pad per chunk,
    the split-point search half-window, the chunk center spacing, and the
    maximum un-chunked length.
    """

    x_pad: int = 1
    x_query: int = 6
    x_center: int = 38
    x_max: int = 41
    # inference-time frame bucketing for stable jit caches (TPU-specific):
    # feature-frame counts are padded up to the next multiple of this.
    frame_bucket: int = 96


def _sr_defaults(sample_rate: int) -> RVCConfig:
    if sample_rate == 48000:
        return RVCConfig(
            data=DataConfig(sample_rate=48000, filter_length=2048, hop_length=480,
                            win_length=2048, n_mel_channels=128),
            model=ModelConfig(upsample_rates=(12, 10, 2, 2),
                              upsample_kernel_sizes=(24, 20, 4, 4)),
            train=TrainConfig(segment_size=17280),
        )
    if sample_rate == 40000:
        return RVCConfig(
            data=DataConfig(sample_rate=40000, filter_length=2048, hop_length=400,
                            win_length=2048, n_mel_channels=125),
            model=ModelConfig(upsample_rates=(10, 10, 2, 2),
                              upsample_kernel_sizes=(16, 16, 4, 4)),
            train=TrainConfig(segment_size=12800),
        )
    if sample_rate == 32000:
        return RVCConfig(
            data=DataConfig(sample_rate=32000, filter_length=1024, hop_length=320,
                            win_length=1024, n_mel_channels=80),
            model=ModelConfig(upsample_rates=(10, 8, 2, 2),
                              upsample_kernel_sizes=(20, 16, 4, 4)),
            train=TrainConfig(segment_size=12800),
        )
    raise ValueError(f"unsupported sample rate: {sample_rate}")


def get_config(sample_rate: int = 48000, **overrides) -> RVCConfig:
    """Return the canonical config for a target sample rate.

    ``overrides`` may patch nested fields using ``data_``/``model_``/``train_``
    prefixes, e.g. ``get_config(48000, model_spk_embed_dim=1)``.
    """
    cfg = _sr_defaults(sample_rate)
    if not overrides:
        return cfg
    data_kw, model_kw, train_kw = {}, {}, {}
    for k, v in overrides.items():
        if k.startswith("data_"):
            data_kw[k[5:]] = v
        elif k.startswith("model_"):
            model_kw[k[6:]] = v
        elif k.startswith("train_"):
            train_kw[k[6:]] = v
        else:
            raise ValueError(f"unknown override {k!r}")
    return RVCConfig(
        data=dataclasses.replace(cfg.data, **data_kw),
        model=dataclasses.replace(cfg.model, **model_kw),
        train=dataclasses.replace(cfg.train, **train_kw),
    )


def _tupleize(x):
    if isinstance(x, list):
        return tuple(_tupleize(v) for v in x)
    return x


def config_from_dict(d: dict) -> RVCConfig:
    """Build an RVCConfig from the reference's JSON dict layout
    (``{"train": ..., "data": ..., "model": ...}``). Unknown keys ignored."""

    def pick(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _tupleize(v) for k, v in src.items() if k in names})

    return RVCConfig(
        data=pick(DataConfig, d.get("data", {})),
        model=pick(ModelConfig, d.get("model", {})),
        train=pick(TrainConfig, d.get("train", {})),
    )


def config_to_dict(cfg: RVCConfig) -> dict:
    return {
        "data": dataclasses.asdict(cfg.data),
        "model": dataclasses.asdict(cfg.model),
        "train": dataclasses.asdict(cfg.train),
    }


def load_config(path: str) -> RVCConfig:
    with open(path) as f:
        return config_from_dict(json.load(f))


def save_config(cfg: RVCConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)
