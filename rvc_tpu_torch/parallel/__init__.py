"""Batched conversion and training across devices and ranks (counterpart of
`rvc_tpu/parallel`): `BatchConverter` (equal-length batches and long-form
utterances), the ("data", "model") mesh and its rules (`mesh`), joining
the ranks (`distributed`), tensor parallelism (`tp`) and the mesh's train
step (`train`).

`BatchConverter` is imported on first use: the models import `tp`, and
`BatchConverter` imports the models."""


def __getattr__(name):
    if name == "BatchConverter":
        from rvc_tpu_torch.parallel.infer import BatchConverter

        return BatchConverter
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["BatchConverter"]
