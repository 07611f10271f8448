"""`rvc_tpu_torch.retrieval` against `rvc_tpu.retrieval`: the same index
arrays and numpy queries through both searches, k-means from the same
initial centroids, and FAISS files written by one side read by the other.

Indices are compared only on random Gaussian data, where distances do not
tie; where a probed list is shorter than k, `lax.top_k` and `torch.topk`
fill the +inf slots with different indices, which the blend weighs 0, so
only the blended features are compared there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu import retrieval as JR
from rvc_tpu.retrieval import ivf as jax_ivf
from rvc_tpu_torch import retrieval as PR
from rvc_tpu_torch.retrieval import ivf as port_ivf

CPU = "cpu"


def _gauss(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _blobs(seed, n_clusters, per_cluster, d, spread=1.0):
    """Well-separated clusters, each wide enough that two centroids drawn in
    one of them split it far from rounding: assignments do not flip."""
    rng = np.random.default_rng(seed)
    centers = 10.0 * rng.standard_normal((n_clusters, d)).astype(np.float32)
    x = centers.repeat(per_cluster, 0) + spread * rng.standard_normal(
        (n_clusters * per_cluster, d)).astype(np.float32)
    return x[rng.permutation(len(x))]


def _port_index(idx) -> PR.IVFFlatIndex:
    return PR.IVFFlatIndex(centroids=idx.centroids.copy(), vectors=idx.vectors.copy(),
                           list_ids=idx.list_ids.copy(), nprobe=idx.nprobe)


@pytest.fixture(scope="module")
def gaussian_index():
    """A JAX-built index of N = 2000 Gaussian vectors at d = 768."""
    return JR.build_index(_gauss(0, 2000, 768), kmeans_iters=5)


@pytest.mark.parametrize("nprobe", [1, 4])
def test_ivf_search_matches_jax(gaussian_index, nprobe):
    queries = _gauss(1, 64, 768)
    ref_d, ref_i = gaussian_index.search(queries, k=8, nprobe=nprobe)
    got_d, got_i = _port_index(gaussian_index).search(queries, k=8, nprobe=nprobe, device=CPU)
    assert np.isfinite(ref_d).all()  # every probed list holds 8 or more vectors
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_allclose(got_d, ref_d, rtol=1e-4)


def test_flat_search_matches_jax():
    vectors, queries = _gauss(2, 700, 96), _gauss(3, 40, 96)
    vec_sq = (vectors * vectors).sum(1)
    ref_d, ref_i = jax_ivf._flat_search(jnp.asarray(queries), jnp.asarray(vectors),
                                        jnp.asarray(vec_sq), 8)
    got_d, got_i = port_ivf._flat_search(torch.from_numpy(queries), torch.from_numpy(vectors),
                                         torch.from_numpy(vec_sq), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-4)


def test_index_blend_matches_jax():
    feats, neighbors = _gauss(4, 50, 64), _gauss(5, 50, 8, 64)
    dist = np.abs(_gauss(6, 50, 8)) + 0.05
    dist[0, 0] = 0.0            # a query equal to a stored vector: max(d, 1e-12) dominates
    ref = jax_ivf.index_blend(jnp.asarray(feats), jnp.asarray(neighbors), jnp.asarray(dist), 0.75)
    got = PR.index_blend(torch.from_numpy(feats), torch.from_numpy(neighbors),
                         torch.from_numpy(dist), 0.75)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_short_lists_blend_like_jax():
    """Lists of ~3 vectors leave +inf slots among the 8 neighbours: the
    blended features agree, whichever index fills those slots."""
    vectors = _gauss(7, 60, 32)
    jidx = JR.build_index(vectors, nlist=20, kmeans_iters=3)
    queries = vectors[:16] + 0.1 * _gauss(8, 16, 32)
    ref_d, ref_i = jidx.search(queries, k=8)
    assert np.isinf(ref_d).any()
    ref = np.asarray(jax_ivf.index_blend(jnp.asarray(queries), jnp.asarray(vectors[ref_i]),
                                         jnp.asarray(ref_d), 0.75))
    pidx = _port_index(jidx)
    d, i = pidx.search_device(torch.from_numpy(queries))
    got = PR.index_blend(torch.from_numpy(queries), torch.from_numpy(vectors)[i], d, 0.75)
    # the |q|^2 - 2qv + |v|^2 expansion cancels to ~1e-5 absolute near d = 0.4,
    # which 1/d^2 doubles in relative terms
    np.testing.assert_allclose(d.numpy(), ref_d, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
def test_kmeans_matches_jax(chunked):
    """Same initial centroids; the centroids within float32 rounding of the
    two sums' orders (well-separated clusters, so no assignment flips)."""
    x = _blobs(9, 12, 40, 24)
    init = x[:12].copy()
    kw = dict(chunk=64, max_dense_cells=0) if chunked else {}
    ref = jax_ivf.kmeans_fit(x, init, 12, n_iters=6, **kw)
    got = port_ivf.kmeans_fit(x, init, 12, n_iters=6, device=CPU, **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_build_index_matches_jax():
    """The same seed draws the same training points and initial centroids:
    the same list of every vector on separated clusters."""
    x = _blobs(10, 16, 30, 48)
    ref = JR.build_index(x, nlist=16, seed=3, kmeans_iters=8)
    got = PR.build_index(x, nlist=16, seed=3, kmeans_iters=8, device=CPU)
    np.testing.assert_array_equal(got.list_ids, ref.list_ids)
    np.testing.assert_allclose(got.centroids, ref.centroids, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.vectors, x)
    assert port_ivf.default_nlist(len(x)) == jax_ivf.default_nlist(len(x))


def test_build_index_subsamples_like_jax():
    """Above max_train_points both sides train on the same subset."""
    x = _blobs(11, 8, 40, 16)
    ref = JR.build_index(x, nlist=8, seed=5, kmeans_iters=4, max_train_points=100)
    got = PR.build_index(x, nlist=8, seed=5, kmeans_iters=4, max_train_points=100, device=CPU)
    np.testing.assert_array_equal(got.list_ids, ref.list_ids)
    np.testing.assert_allclose(got.centroids, ref.centroids, rtol=1e-4, atol=1e-5)


def test_add_in_chunks_and_reconstruct():
    x = _gauss(12, 300, 8)
    one = PR.build_index(x, nlist=6, device=CPU)
    two = PR.IVFFlatIndex(centroids=one.centroids.copy(), vectors=np.zeros((0, 8), np.float32),
                          list_ids=np.zeros((0,), np.int32))
    two.add(x[:100], chunk=37, device=CPU)
    two.add(x[100:], chunk=37, device=CPU)
    np.testing.assert_array_equal(two.list_ids, one.list_ids)
    np.testing.assert_array_equal(two.reconstruct_n(0, 300), x)


def test_faiss_files_cross_read(tmp_path, gaussian_index):
    """JAX writes, the port reads; the port writes, JAX reads; one index
    gives byte-identical files from both writers."""
    jax_path, port_path = str(tmp_path / "jax.index"), str(tmp_path / "port.index")
    JR.write_faiss_index(gaussian_index, jax_path)
    got = PR.read_faiss_index(jax_path)
    np.testing.assert_array_equal(got.centroids, gaussian_index.centroids)
    np.testing.assert_array_equal(got.vectors, gaussian_index.vectors)
    np.testing.assert_array_equal(got.list_ids, gaussian_index.list_ids)
    assert (got.nprobe, got.metric) == (gaussian_index.nprobe, gaussian_index.metric)
    PR.write_faiss_index(got, port_path)
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    back = JR.read_faiss_index(port_path)
    np.testing.assert_array_equal(back.vectors, gaussian_index.vectors)
    np.testing.assert_array_equal(back.list_ids, gaussian_index.list_ids)


@pytest.mark.parametrize("keep", [3, 40, 120, 0.5, 0.999], ids=lambda k: f"keep{k}")
def test_truncated_file_raises(tmp_path, keep):
    """Cut in the header, the quantizer, the list sizes or the lists."""
    idx = PR.build_index(_gauss(13, 200, 12), nlist=5, device=CPU)
    path = str(tmp_path / "t.index")
    PR.write_faiss_index(idx, path)
    data = open(path, "rb").read()
    n = keep if isinstance(keep, int) else int(keep * len(data))
    with open(path, "wb") as f:
        f.write(data[:n])
    with pytest.raises(ValueError):
        PR.read_faiss_index(path)
