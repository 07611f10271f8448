"""Named-embedder resolution (a copy of `rvc_tpu/utils/embedders.py`).

The content encoder is chosen by name: contentvec (the default) or a
language HuBERT base, each a checkpoint under
``$RVC_TPU_MODELS_DIR/embedders/<name>/`` (default ``models/``), or a
custom path. All share the HuBERT-base architecture.
"""

from __future__ import annotations

import os
from typing import Optional

EMBEDDER_MODELS = (
    "contentvec",
    "chinese-hubert-base",
    "japanese-hubert-base",
    "korean-hubert-base",
    "custom",
)

_CKPT_NAMES = ("model.safetensors", "pytorch_model.bin", "model.pt", "model.pth")


def models_dir() -> str:
    return os.environ.get("RVC_TPU_MODELS_DIR", "models")


def resolve_embedder(embedder_model: str = "contentvec",
                     embedder_model_custom: Optional[str] = None) -> Optional[str]:
    """The checkpoint path of a named embedder, or None when the default
    contentvec is not present (the caller then makes a seeded random
    HuBERT). Any other embedder that cannot be found raises: converting
    with another content encoder than the one asked for is wrong."""
    if embedder_model not in EMBEDDER_MODELS:
        raise ValueError(f"unknown embedder_model {embedder_model!r}; choose from "
                         f"{list(EMBEDDER_MODELS)}")
    if embedder_model == "custom":
        if not embedder_model_custom:
            raise ValueError("embedder_model='custom' requires embedder_model_custom "
                             "(path to the checkpoint)")
        if not os.path.exists(embedder_model_custom):
            raise FileNotFoundError(f"custom embedder not found: {embedder_model_custom}")
        return embedder_model_custom
    root = os.path.join(models_dir(), "embedders", embedder_model)
    for name in _CKPT_NAMES:
        p = os.path.join(root, name)
        if os.path.exists(p):
            return p
    if embedder_model == "contentvec":
        return None
    raise FileNotFoundError(f"embedder {embedder_model!r} not found under {root}; place "
                            f"one of {_CKPT_NAMES} there")
