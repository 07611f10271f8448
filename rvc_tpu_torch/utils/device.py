"""Device selection and float32 numerics for the port's entry points."""

from __future__ import annotations

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
    """Keep float32 convolutions and matmuls in full float32.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits: enough to move RMVPE's argmax and the HuBERT
    features away from the reference. The port runs the path in float32.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; for a CUDA device copied from pinned memory
    without waiting for the work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
