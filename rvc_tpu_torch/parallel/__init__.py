"""Batched conversion (counterpart of `rvc_tpu/parallel`): `BatchConverter`,
equal-length batches and long-form utterances on one card."""

from rvc_tpu_torch.parallel.infer import BatchConverter

__all__ = ["BatchConverter"]
