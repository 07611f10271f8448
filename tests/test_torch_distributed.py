"""Multi-card training and the multi-device BatchConverter of the port on the
CPU: the loader's per-host shards against the JAX loader; a two-rank gloo
train step (`parallel.train.spawn` of `trainer_job`, a `file://` store)
against the port's one-process `TrainStep` on the whole global batch and
against the JAX package's `make_sharded_train_step` on a (data = 2) mesh of
the conftest's virtual CPU devices, with the JAX step's draws handed to both
ports; ZeRO-1's bytes against the JAX sharding's; `BatchConverter` on a
mesh naming the CPU twice against one device.

Bars: the index lists equal; two ranks against one process: every metric
of step 1 within rel 1e-5, G and D after 2 steps within rel_l2 1e-4 (over
each network), the moments (all of an optimizer's) within rel_l2 1e-4 (nu)
and 8e-3 (bf16 mu, one bf16 ulp), the ranks' parameters equal bit for bit;
against the JAX sharded step `test_torch_train_step.py`'s bars against
`make_train_step` (each loss rel 1e-4, grad norm rel 1e-3); the mesh
against one device max abs 1e-5 with the source noise on."""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.models.synthesizer import build_synthesizer as jax_build
from rvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rvc_tpu.parallel.train import make_sharded_train_step, shard_batch, shard_state
from rvc_tpu.parallel.train import state_bytes_per_device as jax_state_bytes
from rvc_tpu.train import data as jax_data
from rvc_tpu.train import train_step as JT
from rvc_tpu_torch.configs import config_to_dict
from rvc_tpu_torch.parallel import BatchConverter
from rvc_tpu_torch.parallel.mesh import make_mesh, zero1_dim
from rvc_tpu_torch.parallel.train import spawn, trainer_job
from rvc_tpu_torch.pipelines.offline import Pipeline
from rvc_tpu_torch.train import data as port_data
from rvc_tpu_torch.train.train_step import Batch, TrainStep, make_optimizers
from rvc_tpu_torch.utils import audio as audio_utils
from torch_port_helpers import (huberts, jax_draws, rmvpes, synthesizers, t, train_batch,
                                train_configs, train_pair)

KEY = 5
STEPS = 2
LOSSES = ("loss_g_total", "loss_d", "loss_mel", "loss_kl", "loss_adv", "loss_fm")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the loader's per-host shards
# ---------------------------------------------------------------------------

def _rows(n=23, seed=0):
    rng = np.random.default_rng(seed)
    rows = [{"n_frames": int(f)} for f in rng.integers(20, 260, n)]
    rows[3].pop("n_frames")     # no metadata: the top bucket
    return rows


@pytest.mark.parametrize("host_id", [0, 1])
def test_loader_shards_match_jax(host_id):
    """num_hosts = 2: the same index lists as the JAX loader, over two
    epochs; both ranks step equally often, in the same buckets."""
    rows = _rows()
    kw = dict(batch_size=3, seed=7, num_hosts=2)
    port = port_data.DataLoader(port_data.RVCDataset(rows, 320), host_id=host_id, **kw)
    ref = jax_data.DataLoader(jax_data.RVCDataset(rows, 320), host_id=host_id, **kw)
    other = port_data.DataLoader(port_data.RVCDataset(rows, 320), host_id=1 - host_id, **kw)
    assert len(port) == len(ref) == 23 // 6
    for epoch in (0, 1):
        for loader in (port, ref, other):
            loader.set_epoch(epoch)
        got = port._batches_indices()
        assert got == ref._batches_indices() and got
        buckets = [[port_data._bucket_of(rows[i].get("n_frames", 900)) for i in b]
                   for b in got]
        mates = [[port_data._bucket_of(rows[i].get("n_frames", 900)) for i in b]
                 for b in other._batches_indices()]
        assert len(buckets) == len(mates)
        assert [set(b) for b in buckets] == [set(m) for m in mates]
        assert all(len(set(b)) == 1 for b in buckets)


def _dataset_files(root, n, T=40, hop=320, bad=()):
    """n rows of random features on disk; the rows in `bad` lack theirs."""
    rng = np.random.default_rng(1)
    rows = []
    for i in range(n):
        base = str(root / f"r{i}")
        T_i = T - 3 * i
        if i not in bad:
            np.save(base + "_feats.npy", rng.standard_normal((T_i // 2, 768)).astype(np.float32))
        np.save(base + "_f0.npy", rng.uniform(100, 300, T_i).astype(np.float32))
        np.save(base + "_f0c.npy", rng.integers(1, 255, T_i).astype(np.int32))
        np.save(base + "_spec.npy", rng.standard_normal((T_i, 9)).astype(np.float32))
        audio_utils.save_wav(base + ".wav", 0.1 * rng.standard_normal(T_i * hop), 32000)
        rows.append(dict(audio=base + ".wav", features=base + "_feats.npy", f0=base + "_f0.npy",
                         f0_coarse=base + "_f0c.npy", spec=base + "_spec.npy", sid=i % 2,
                         n_frames=T_i))
    return rows


def test_loader_batches_match_jax_with_a_corrupt_row(tmp_path):
    """A row that fails to load becomes a copy of one that loads and T is
    the bucket of the metadata, on both packages (the same arrays); a batch
    whose rows all fail raises."""
    rows = _dataset_files(tmp_path, 8, bad=(1,))
    for host_id in (0, 1):
        kw = dict(batch_size=2, num_hosts=2, host_id=host_id, shuffle=False)
        got = list(port_data.DataLoader(port_data.RVCDataset(rows, 320), **kw))
        ref = list(jax_data.DataLoader(jax_data.RVCDataset(rows, 320), **kw))
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            for a, b in zip(g, r):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    broken = [dict(r, features=r["features"] + ".gone") for r in rows]
    with pytest.raises(RuntimeError, match="failed to load"):
        next(iter(port_data.DataLoader(port_data.RVCDataset(broken, 320), 2, num_hosts=2,
                                       host_id=0)))


# ---------------------------------------------------------------------------
# the two-rank step
# ---------------------------------------------------------------------------

def _global_batch(cfg):
    b = train_batch(cfg, 3, B=4, T=24, lengths=(24, 19, 22, 17))
    return b, Batch(*(t(x) for x in b))._replace(pitch=t(b[2]).long(), sid=t(b[7]).long())


def _jax_sharded_step(gp, dp, np_batch):
    """Step 1's metrics of `make_sharded_train_step` on make_mesh(n_data=2)
    from (gp, dp), with the key the draws came from, and the sharded
    state's `state_bytes_per_device`."""
    jcfg, _ = train_configs()
    g_tx, d_tx = JT.make_optimizers(jcfg, 100)
    state = JT.TrainState(gp, dp, g_tx.init(gp), d_tx.init(dp), jnp.zeros((), jnp.int32))
    mesh = jax_make_mesh(n_data=2, n_model=1)
    state = shard_state(state, mesh)
    step = make_sharded_train_step(jcfg, jax_build(jcfg), JT.build_discriminator(jcfg), mesh,
                                   state=state)
    batch = shard_batch(JT.Batch(*map(jnp.asarray, np_batch)), mesh)
    _, metrics = step(state, batch, jax.random.PRNGKey(KEY))
    return {k: float(v) for k, v in metrics.items()}, jax_state_bytes(state, mesh)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two gloo ranks of `trainer_job` (seed 0: `train_pair(0)`'s init) for
    STEPS steps on the global batch of 4 with the JAX step's draws; the
    JAX sharded step (compiled in a thread meanwhile) and the port's
    one-process TrainStep on the same batch and draws."""
    _, cfg = train_configs()
    np_batch, batch = _global_batch(cfg)
    draws = [jax_draws(jax.random.PRNGKey(KEY + s), cfg, np_batch) for s in range(STEPS)]
    net_g, net_d, gp, dp = train_pair(0)
    work = tmp_path_factory.mktemp("ranks")
    job = str(work / "job.pt")
    torch.save({"config": config_to_dict(cfg), "seed": 0, "device": "cpu",
                "batch": tuple(batch), "steps": STEPS, "draws": draws, "moments": True},
               job)
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(_jax_sharded_step, gp, dp, np_batch)
        spawn(trainer_job, 2, (job,), init_method=f"file://{work / 'store'}", device="cpu",
              threads=2)
        jax_metrics, jax_bytes = jax_run.result()
    ranks = [torch.load(f"{job}.rank{r}", weights_only=False) for r in range(2)]

    g_opt, d_opt = make_optimizers(cfg, net_g, net_d, 1)   # the trainer_job's one step an epoch
    step = TrainStep(cfg, net_g, net_d, g_opt, d_opt)
    ref = [{k: float(v) for k, v in step(batch, **draws[s]).items()} for s in range(STEPS)]
    return SimpleNamespace(ranks=ranks, ref=ref, net_g=net_g, net_d=net_d, g_opt=g_opt,
                           d_opt=d_opt, jax_metrics=jax_metrics, jax_bytes=jax_bytes)


def _rel_l2(got, ref):
    got, ref = got.double(), ref.double()
    return float(torch.linalg.vector_norm(got - ref) / max(torch.linalg.vector_norm(ref), 1e-30))


def _moments_rel_l2(got, ref):
    """rel_l2 over a whole network's parameters, or all of an optimizer's
    moments of one kind: a leaf whose gradient is rounding noise (an
    attention key's bias, ~1e-11) has no relative error to speak of alone,
    and Adam turns that noise into whole steps."""
    return _rel_l2(torch.cat([x.flatten() for x in got]), torch.cat([x.flatten() for x in ref]))


def test_two_ranks_match_one_process(two_ranks):
    """Step 1's metrics, then G, D and both optimizers' moments after STEPS
    steps, on each rank against one process at the same global batch."""
    r = two_ranks
    for rank in r.ranks:
        for k, v in r.ref[0].items():
            assert rank["metrics"][0][k] == pytest.approx(v, rel=1e-5, abs=1e-9), k
        for name, net in (("g", r.net_g), ("d", r.net_d)):
            ref = net.state_dict()
            assert _moments_rel_l2([rank[name][k] for k in ref], ref.values()) < 1e-4, name
        for name, opt in (("g_opt", r.g_opt), ("d_opt", r.d_opt)):
            state = rank[name]
            assert int(state["count"]) == int(opt.count) == STEPS
            assert all(a.dtype == b.dtype for a, b in zip(state["mu"], opt.mu))
            assert _moments_rel_l2(state["nu"], opt.nu) < 1e-4, name
            assert _moments_rel_l2(state["mu"], opt.mu) < 8e-3, name


def test_ranks_stay_identical(two_ranks):
    """Parameters bit for bit across the ranks after STEPS steps, and the
    gathered moments alike; the metrics are the global batch's on both."""
    a, b = two_ranks.ranks
    for name in ("g", "d"):
        for k, v in a[name].items():
            assert torch.equal(v, b[name][k]), (name, k)
    for name in ("g_opt", "d_opt"):
        for key in ("mu", "nu"):
            assert all(torch.equal(x, y) for x, y in zip(a[name][key], b[name][key]))
    assert a["metrics"] == b["metrics"]
    assert a["all_reduced_bytes"] > 0 and a["all_gathered_bytes"] > 0


def test_two_ranks_match_jax_sharded_step(two_ranks):
    """Step 1 against `make_sharded_train_step` on make_mesh(n_data=2) with
    the same parameters, batch and key."""
    metrics = two_ranks.jax_metrics
    got = two_ranks.ranks[0]["metrics"][0]
    for k in LOSSES:
        assert got[k] == pytest.approx(metrics[k], rel=1e-4, abs=1e-6), k
    assert got["grad_norm_g"] == pytest.approx(metrics["grad_norm_g"], rel=1e-3)


def test_zero1_bytes_match_jax(two_ranks):
    """Per-rank optimizer bytes equal the JAX ZeRO-1 sharding's at data = 2
    on the same model, but for the counts: optax keeps two int32 step counts
    an optimizer (Adam's and the schedule's), the port one. Below 0.6 x the
    global bytes, `test_shard_state_zero1_memory`'s form."""
    ref = two_ranks.jax_bytes
    for rank in two_ranks.ranks:
        got = rank["state_bytes"]
        counts = 2 * 4           # one int32 count fewer in each of two optimizers
        assert got["opt_bytes_per_device"] == ref["opt_bytes_per_device"] - counts
        assert got["opt_bytes_global"] == ref["opt_bytes_global"] - counts
        assert got["param_bytes_global"] == ref["param_bytes_global"]
        assert got["param_bytes_per_device"] == ref["param_bytes_per_device"]
        assert got["n_devices"] == ref["n_devices"] == 2
        assert got["opt_bytes_per_device"] < 0.6 * got["opt_bytes_global"]


@pytest.mark.parametrize("shape,n,want", [
    ((768, 3072), 4, 1), ((3072, 768), 4, 0), ((16,), 4, None), ((255, 257), 2, None),
    ((192, 192, 3), 2, 0), ((1 << 16,), 1, None), ((4, 1 << 14), 2, 1), ((2, 1 << 15), 2, 1)])
def test_zero1_rule_matches_jax(shape, n, want):
    """`zero1_dim` puts "data" where the reference's `_zero1_spec` does."""
    from jax.sharding import PartitionSpec as P

    from rvc_tpu.parallel.mesh import _zero1_spec

    spec = tuple(_zero1_spec(P(), np.zeros(shape, np.float32), n))
    assert (spec.index("data") if "data" in spec else None) == want == zero1_dim(shape, n)


# ---------------------------------------------------------------------------
# BatchConverter on a mesh
# ---------------------------------------------------------------------------

def _chirp(seconds, f_start, seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * 16000)) / 16000
    phase = 2 * np.pi * (f_start * tt + 60 * tt * tt)
    return (0.5 * np.sin(phase) + 0.01 * rng.standard_normal(len(tt))).astype(np.float32)


def test_batch_converter_mesh_matches_one_device():
    """A mesh naming the CPU twice (two host threads, two shards) against
    one device, the source noise on: the noise is drawn for the whole batch
    and cut per shard, so the rows agree; convert_long_batch's groups of 3
    round up to 4."""
    port_s, _, _ = synthesizers()
    pipe = Pipeline(32000, port_s, huberts()[0], rmvpes()[0], source_noise=True)
    rvc = SimpleNamespace(pipeline=pipe, cfg=SimpleNamespace(data=SimpleNamespace(
        sample_rate=32000)), device=torch.device("cpu"))
    one, two = BatchConverter(rvc), BatchConverter(rvc, make_mesh(devices=["cpu", "cpu"]))
    assert two.mesh.shape == {"data": 2, "model": 1}
    batch = np.stack([_chirp(0.6, f, seed=i) for i, f in enumerate((110., 180., 260., 140.))])
    sids = np.array([0, 1, 1, 0])
    ref = one.convert_batch(batch, sids, pitch_shift=2.0)
    got = two.convert_batch(batch, sids, pitch_shift=2.0)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="does not split"):
        two.convert_batch(batch[:3])
    utts = [_chirp(s, f, seed=10 + i) for i, (s, f) in enumerate(((1.2, 130.), (0.3, 220.)))]
    kw = dict(sids=[1, 0], chunk_seconds=0.5, pad_seconds=0.1, batch_size=3)
    for g, r in zip(two.convert_long_batch(utts, **kw), one.convert_long_batch(
            utts, **dict(kw, batch_size=4))):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)
