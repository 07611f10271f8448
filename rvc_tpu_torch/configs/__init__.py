"""Configuration dataclasses (a copy of `rvc_tpu.configs`)."""

from rvc_tpu_torch.configs.config import (
    DataConfig,
    ModelConfig,
    PipelineConfig,
    RVCConfig,
    TrainConfig,
    config_from_dict,
    config_to_dict,
    get_config,
)

__all__ = [
    "DataConfig",
    "ModelConfig",
    "TrainConfig",
    "RVCConfig",
    "PipelineConfig",
    "get_config",
    "config_from_dict",
    "config_to_dict",
]
