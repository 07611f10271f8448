"""Device selection, float32 numerics and the inference compute-dtype
policy of the port's entry points."""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    None means the card: it raises when there is no CUDA device rather
    than carrying on quietly on the CPU. Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rvc_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def use_fp32_numerics() -> None:
    """Keep float32 convolutions and matmuls in full float32, and bf16
    matmuls' sums in float32.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits: enough to move RMVPE's argmax and the HuBERT
    features away from the reference. The port runs the path in float32.
    cuBLAS may reduce a bf16 GEMM's split sums in bf16 by default; the
    reference accumulates every bf16 product in float32
    (`preferred_element_type=float32`).
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def compute_dtype(device: torch.device) -> torch.dtype:
    """The inference compute dtype of a conversion on `device`, read from
    RVC_TPU_BF16 at each call (the reference's `_compute_dtype`).

    "1": HuBERT, the retrieval re-entry, enc_p and the flow run in bf16 with
    float32 sums, norm statistics and softmax; the decoder's activations
    and the f0 program stay float32. "0": all float32. Unset, bf16 on a
    CUDA device (the reference's default on its accelerator) and float32
    elsewhere. The fused offline path, `BatchConverter` and the realtime
    block program follow it; the staged path, extraction and training run
    float32, as in the reference.
    """
    default = "1" if device.type == "cuda" else "0"
    return torch.bfloat16 if os.environ.get("RVC_TPU_BF16", default) == "1" else torch.float32


def bf16_f0() -> bool:
    """RVC_TPU_BF16_F0=1 (default off) runs the fused offline f0 program's
    RMVPE U-Net trunk in bf16; the log-mel and the BiGRU / fc head stay
    float32 (the reference's opt-in of `_build_f0_program`)."""
    return os.environ.get("RVC_TPU_BF16_F0", "0") == "1"


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; for a CUDA device copied from pinned memory
    without waiting for the work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
