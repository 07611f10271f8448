"""IVFFlat index: k-means training, coarse assignment, exact search and the
retrieval blend (counterpart of `rvc_tpu/retrieval/ivf.py`).

The reference's semantics (`extract_index.py:43-70` build: ``IVF{n},Flat``
with ``n = min(16 sqrt(N), N / 39)``, nprobe 1; `pipeline_mlx.py:183-204`
query: k = 8 squared-L2 search, 1/d^2 weights, the weighted sum of the
neighbours) on the reference's design: search is one dense (Q, N) distance
product masked to the probed lists, then top-k. The products are float32
`torch.matmul` (TF32 off, `utils/device.py`); the JAX package has no Pallas
kernel here. Distances keep the ``|q|^2 - 2 q.v + |v|^2`` expansion of the
reference (a query equal to a stored vector may come out slightly below 0).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from rvc_tpu_torch.utils.device import resolve_device


def _sq_dist(x: torch.Tensor, x_sq: torch.Tensor, c: torch.Tensor,
             c_sq: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (N, K) of rows of x to rows of c, expanded."""
    return x_sq[:, None] - 2.0 * (x @ c.T) + c_sq[None, :]


def _lloyd_sums(x: torch.Tensor, centroids: torch.Tensor, c_sq: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums and counts of x's nearest-centroid assignment, by a
    one-hot product as in the reference (an index_add_ sums in another order)."""
    assign = torch.argmin(_sq_dist(x, (x * x).sum(1), centroids, c_sq), dim=1)
    one_hot = F.one_hot(assign, centroids.shape[0]).to(x.dtype)
    if mask is not None:
        one_hot = one_hot * mask[:, None]
    return one_hot.T @ x, one_hot.sum(0)


def _lloyd_update(centroids, sums, counts):
    return torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], centroids)


def _kmeans_fit(x: torch.Tensor, init: torch.Tensor, n_iters: int = 25) -> torch.Tensor:
    """Lloyd's k-means. x: (N, D); init: (K, D) -> centroids (K, D)."""
    centroids = init
    for _ in range(n_iters):
        sums, counts = _lloyd_sums(x, centroids, (centroids * centroids).sum(1))
        centroids = _lloyd_update(centroids, sums, counts)
    return centroids


def _kmeans_fit_chunked(x: torch.Tensor, mask: torch.Tensor, init: torch.Tensor,
                        n_iters: int = 25) -> torch.Tensor:
    """Memory-bounded Lloyd's: x pre-chunked to (n_chunks, C, D) with a
    (n_chunks, C) validity mask; each iteration accumulates the sums and
    counts chunk by chunk, so memory is O(C K), not O(N K)."""
    centroids = init
    for _ in range(n_iters):
        c_sq = (centroids * centroids).sum(1)
        sums, counts = torch.zeros_like(centroids), torch.zeros_like(centroids[:, 0])
        for xc, mc in zip(x, mask):
            s, c = _lloyd_sums(xc, centroids, c_sq, mc)
            sums, counts = sums + s, counts + c
        centroids = _lloyd_update(centroids, sums, counts)
    return centroids


def kmeans_fit(x: np.ndarray, init: np.ndarray, n_clusters: int, n_iters: int = 25,
               chunk: int = 8192, max_dense_cells: int = 1 << 27,
               device=None) -> np.ndarray:
    """K-means that bounds device memory: one dense pass when N * K is
    small, else the chunked scan. device: None is the card."""
    device = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    init = np.asarray(init, dtype=np.float32)
    if init.shape[0] != n_clusters:
        raise ValueError(f"{init.shape[0]} initial centroids for {n_clusters} clusters")
    init_t = torch.from_numpy(init).to(device)
    n = len(x)
    if n * n_clusters <= max_dense_cells:
        return _kmeans_fit(torch.from_numpy(x).to(device), init_t, n_iters).cpu().numpy()
    n_chunks = -(-n // chunk)
    xp = np.pad(x, ((0, n_chunks * chunk - n), (0, 0))).reshape(n_chunks, chunk, -1)
    mask = np.zeros((n_chunks, chunk), np.float32)
    mask.reshape(-1)[:n] = 1.0
    return _kmeans_fit_chunked(torch.from_numpy(xp).to(device),
                               torch.from_numpy(mask).to(device), init_t,
                               n_iters).cpu().numpy()


def _ivf_search(queries: torch.Tensor, vectors: torch.Tensor, vec_sq: torch.Tensor,
                list_ids: torch.Tensor, centroids: torch.Tensor, k: int,
                nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact IVF search: probe the nprobe nearest lists of each query, take
    the k nearest vectors among them (squared L2, the FAISS metric).
    queries (Q, D), vectors (N, D), vec_sq (N,), list_ids (N,) int64,
    centroids (K, D) -> (distances (Q, k), indices (Q, k)); slots past a
    short list hold +inf."""
    q_sq = (queries * queries).sum(1)
    cd = _sq_dist(queries, q_sq, centroids, (centroids * centroids).sum(1))
    probes = torch.topk(-cd, nprobe, dim=1).indices                       # (Q, nprobe)
    d = _sq_dist(queries, q_sq, vectors, vec_sq)                           # (Q, N)
    in_probe = (list_ids[None, :, None] == probes[:, None, :]).any(-1)     # (Q, N)
    d = torch.where(in_probe, d, torch.full_like(d, math.inf))
    neg, idx = torch.topk(-d, k, dim=1)
    return -neg, idx


def _flat_search(queries: torch.Tensor, vectors: torch.Tensor, vec_sq: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-nearest search over all vectors (squared L2)."""
    d = _sq_dist(queries, (queries * queries).sum(1), vectors, vec_sq)
    neg, idx = torch.topk(-d, k, dim=1)
    return -neg, idx


def index_blend(feats: torch.Tensor, neighbors: torch.Tensor, distances: torch.Tensor,
                index_rate: float) -> torch.Tensor:
    """RVC's retrieval blend: normalised 1/d^2 weights, the weighted sum of
    the neighbours, mixed with the features by index_rate. feats (T, C),
    neighbors (T, k, C), distances (T, k); +inf distances weigh 0."""
    w = 1.0 / distances.clamp(min=1e-12) ** 2
    w = w / w.sum(1, keepdim=True)
    blended = (neighbors * w[:, :, None]).sum(1)
    return index_rate * blended + (1.0 - index_rate) * feats


@dataclass
class IVFFlatIndex:
    """In-memory IVFFlat: centroids, the vectors in id order and each
    vector's list. Search masks the lists instead of scanning them.

    The arrays stay numpy on the host; `tensors(device)` keeps one copy on
    each device it is asked for (the reference's `_dev()`)."""

    centroids: np.ndarray          # (nlist, d)
    vectors: np.ndarray            # (N, d) in id order
    list_ids: np.ndarray           # (N,) int32
    nprobe: int = 1
    metric: str = "l2"
    _cache: Dict[torch.device, tuple] = field(default_factory=dict, repr=False,
                                              compare=False)

    @property
    def d(self) -> int:
        return self.vectors.shape[1]

    @property
    def ntotal(self) -> int:
        return self.vectors.shape[0]

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    def tensors(self, device) -> Tuple[torch.Tensor, ...]:
        """(vectors, |v|^2, list_ids int64, centroids) on `device`, cached."""
        device = torch.device(device)
        if device not in self._cache:
            v = torch.from_numpy(np.ascontiguousarray(self.vectors, np.float32)).to(device)
            self._cache[device] = (
                v, (v * v).sum(1),
                torch.from_numpy(self.list_ids.astype(np.int64)).to(device),
                torch.from_numpy(np.ascontiguousarray(self.centroids, np.float32)).to(device))
        return self._cache[device]

    def search_device(self, queries: torch.Tensor, k: int = 8,
                      nprobe: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Search on the queries' device; tensors in, tensors out."""
        v, v_sq, lids, cents = self.tensors(queries.device)
        return _ivf_search(queries, v, v_sq, lids, cents, k, int(nprobe or self.nprobe))

    def search(self, queries: np.ndarray, k: int = 8, nprobe: Optional[int] = None,
               device=None) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, d) -> (squared distances (Q, k), indices (Q, k)), exact
        FAISS-IVF semantics at nprobe (default: the index's). device: None
        is the card."""
        q = torch.from_numpy(np.asarray(queries, dtype=np.float32)).to(resolve_device(device))
        d, i = self.search_device(q, k, nprobe)
        return d.cpu().numpy(), i.cpu().numpy()

    def reconstruct_n(self, start: int = 0, n: Optional[int] = None) -> np.ndarray:
        n = self.ntotal if n is None else n
        return self.vectors[start: start + n].copy()

    def add(self, vectors: np.ndarray, chunk: int = 65536, device=None) -> None:
        """Append vectors, each assigned to its nearest centroid, `chunk`
        rows at a time (O(chunk * nlist) device memory). device: None is
        the card."""
        device = resolve_device(device)
        vectors = np.asarray(vectors, dtype=np.float32)
        cents = torch.from_numpy(np.ascontiguousarray(self.centroids, np.float32)).to(device)
        c_sq = (cents * cents).sum(1)
        parts = []
        for j in range(0, len(vectors), chunk):
            v = torch.from_numpy(vectors[j: j + chunk]).to(device)
            d = _sq_dist(v, (v * v).sum(1), cents, c_sq)
            parts.append(torch.argmin(d, dim=1).cpu().numpy().astype(np.int32))
        assign = np.concatenate(parts) if parts else np.zeros((0,), np.int32)
        self.vectors = np.concatenate([self.vectors, vectors]) if self.ntotal else vectors
        self.list_ids = np.concatenate([self.list_ids, assign]) if self.list_ids.size else assign
        self._cache.clear()


def default_nlist(n: int) -> int:
    """FAISS factory sizing of the reference: min(16 sqrt(N), N / 39)."""
    return max(1, min(int(16 * math.sqrt(n)), n // 39 if n >= 39 else 1))


def build_index(features: np.ndarray, nlist: Optional[int] = None, nprobe: int = 1,
                seed: int = 0, kmeans_iters: int = 25, max_train_points: int = 200_000,
                device=None) -> IVFFlatIndex:
    """Train and fill an IVFFlat from (N, d) features, as
    `extract_index.py:29-70`: k-means on at most max_train_points of them
    (the same numpy draws as the reference: the training subset, then the
    initial centroids), then every vector added. device: None is the card."""
    device = resolve_device(device)
    features = np.asarray(features, dtype=np.float32)
    n, d = features.shape
    nlist = nlist or default_nlist(n)
    rng = np.random.default_rng(seed)
    train = features
    if n > max_train_points:
        train = features[rng.choice(n, max_train_points, replace=False)]
    init = train[rng.choice(len(train), nlist, replace=len(train) < nlist)]
    centroids = kmeans_fit(train, init, nlist, kmeans_iters, device=device)
    idx = IVFFlatIndex(centroids=centroids, vectors=np.zeros((0, d), np.float32),
                       list_ids=np.zeros((0,), np.int32), nprobe=nprobe)
    idx.add(features, device=device)
    return idx
