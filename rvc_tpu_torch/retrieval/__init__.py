"""Retrieval (the "R" in RVC): IVFFlat build, search and blend, and the
FAISS IVFFlat file format (counterpart of `rvc_tpu/retrieval`)."""

from rvc_tpu_torch.retrieval.faiss_io import read_faiss_index, write_faiss_index
from rvc_tpu_torch.retrieval.ivf import IVFFlatIndex, build_index, index_blend

__all__ = [
    "IVFFlatIndex",
    "build_index",
    "index_blend",
    "read_faiss_index",
    "write_faiss_index",
]
