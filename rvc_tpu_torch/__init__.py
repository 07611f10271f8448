"""rvc_tpu_torch: the PyTorch/CUDA port of `rvc_tpu`, for one NVIDIA H100.

Ground rules of the port:

* `rvc_tpu/` is the reference and is not touched by the port. Each module
  here has a counterpart of the same path there (`configs/`, `ops/`,
  `models/`, `pipelines/`, `utils/`, `api.py`), and tests feed both the
  same numpy inputs and the same parameters.
* This package imports `torch`, never `jax` or `flax`, and nothing of
  `rvc_tpu`, not even its JAX-free modules: it keeps its own copy of what
  it needs (configs, audio DSP, the mel filterbank, the autotune table).
* Every Pallas kernel of `rvc_tpu` on the ported path is a CUDA C++ kernel
  written by hand for `sm_90a` (`csrc/*.cu`), built with `nvcc` at first
  use into `_build/` and bound with `ctypes` (`ops/kernels/`). Each
  wrapper runs its plain PyTorch version for a CPU tensor, launches its
  kernel for a CUDA tensor (or raises), and counts its launches.
* Entry points run on the card unless the caller passes `device="cpu"`;
  with no GPU and no explicit CPU request they raise.
* The path runs in float32 with TF32 off (`utils/device.py`), like the
  reference's CPU path.
* Public functions keep the reference's `(B, T, C)` layout; module and
  parameter names follow the upstream torch checkpoint keys.
"""
