"""Tensor parallelism of the port on the CPU (the ("data", "model") mesh of
`rvc_tpu_torch.parallel`), against the JAX package's mesh:

- the rules: for every parameter of the full-width 48 kHz G (enc_q
  included) and the v2 D, built on the meta device and not run, at
  n_model 2 and 4, the torch dimension the port's rule splits is the one
  `rvc_tpu.parallel.mesh.param_shardings` splits, carried across by the
  reference's own checkpoint converters (each parameter handed over as an
  array that varies along the port's dimension only); the HuBERT rules'
  specs equal `_semantic_spec`'s on the full-size HuBERT's paths;
- the bytes a rank holds (parameters, optimizer state) equal JAX's
  `state_bytes_per_device(shard_state(...))` at meshes (1, 2) and (2, 2),
  less the optax step count the port does not keep (one int32 an
  optimizer);
- the plain partial-sum ResBlock chain and K1 stage over two gloo ranks
  against the whole ones, outputs and gradients;
- three steps of two gloo ranks on mesh (1, 2) (`trainer_job`) at a
  min_size small enough that the attention, FFN and ResBlock pairs all
  shard, against one process and against `make_sharded_train_step` on
  `make_mesh(n_data=1, n_model=2)` at the same min_size, with the JAX
  step's draws handed to both ports;
- `train --mesh_model 2 --device cpu` as two coordinator ranks against
  one process.

Bars: outputs and gradients of the partial chain rel_l2 < 1e-6 (float32,
another summation order); two ranks against one process: each step's
losses rel 1e-5, G and D after 3 steps rel_l2 < 1e-4; against the JAX
sharded step, losses rel 1e-4 and grad_norm_g rel 1e-3
(`test_torch_train_step.py`'s bars against `make_train_step`); the CLI's
epoch metrics rtol 2e-3 (`test_torch_cli_distributed.py`'s).
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.parallel import mesh as jax_mesh
from rvc_tpu.models.synthesizer import build_synthesizer as jax_build
from rvc_tpu.parallel.train import make_sharded_train_step, shard_batch, shard_state
from rvc_tpu.parallel.train import state_bytes_per_device as jax_state_bytes
from rvc_tpu.train import train_step as JT
from rvc_tpu.utils import weights as JW
from rvc_tpu_torch.configs import config_to_dict, get_config
from rvc_tpu_torch.models.discriminators import build_discriminator
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.parallel import tp
from rvc_tpu_torch.parallel.mesh import Axis, semantic_spec
from rvc_tpu_torch.parallel.train import (ShardedAdamW, spawn, state_bytes_per_device,
                                          trainer_job)
from rvc_tpu_torch.train.train_step import Batch, TrainStep, make_optimizers
from torch_port_helpers import (jax_draws, partial_chain_job, t, train_batch, train_configs,
                                train_pair)

KEY = 5
STEPS = 3
SMALL_MIN = 4096         # the tiny model: attention and FFN pairs shard, and its C = 32 stage
                         # as the full-width C = 128 one (k = 3 whole, k = 7 and 11 shard)
LOSSES = ("loss_g_total", "loss_d", "loss_mel", "loss_kl", "loss_adv", "loss_fm")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel_l2(got, ref):
    got, ref = got.double(), ref.double()
    return float(torch.linalg.vector_norm(got - ref) / max(torch.linalg.vector_norm(ref), 1e-30))


# ---------------------------------------------------------------------------
# the rules against the reference's
# ---------------------------------------------------------------------------

def _marked(shape, dim):
    """An array of `shape` varying along dim only (all zeros for None)."""
    if dim is None:
        return np.broadcast_to(np.float32(0), shape)
    ramp = np.arange(1, shape[dim] + 1, dtype=np.float32)
    return np.broadcast_to(ramp.reshape([-1 if i == dim else 1 for i in range(len(shape))]),
                           shape)


def _varying_dim(a):
    a = np.asarray(a)
    dims = [d for d in range(a.ndim) if a.shape[d] > 1 and np.ptp(a, axis=d).max() > 0]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


@pytest.fixture(scope="module")
def full_width():
    """The full-width 48 kHz G built for training and its D, on meta."""
    cfg = get_config(48000)
    with torch.device("meta"):
        return build_synthesizer(cfg, training=True), build_discriminator(cfg)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("net", ["synthesizer", "discriminator"])
def test_rules_pick_the_reference_dims(full_width, net, n_model):
    module = full_width[0] if net == "synthesizer" else full_width[1]
    dims = tp.plan(module, net, n_model)
    shapes = {k: tuple(p.shape) for k, p in module.named_parameters()}
    state = {k: _marked(shapes[k], dims[k]) for k in shapes}
    convert = (JW.convert_synthesizer_state_dict if net == "synthesizer"
               else JW.convert_discriminator_state_dict)
    params = convert(state)
    mesh = jax_mesh.make_mesh(n_data=1, n_model=n_model)
    specs = jax.tree_util.tree_leaves_with_path(jax_mesh.param_shardings(params, mesh))
    leaves = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(specs) == len(shapes)
    for path, sharding in specs:
        spec = tuple(sharding.spec)
        want = spec.index("model") if "model" in spec else None
        assert _varying_dim(leaves[path]) == want, jax.tree_util.keystr(path)
    n_split = sum(d is not None for d in dims.values())
    assert n_split > 0
    if net == "synthesizer":
        split = {k for k, d in dims.items() if d is not None}
        # the K2 stage's chains, the C = 128 stage's k = 7 and 11, the FFNs
        for r in (0, 1, 2, 4, 5):
            assert f"dec.resblocks.{r}.convs1.0.weight" in split
        assert "enc_p.encoder.ffn_layers.0.conv_1.weight" in split
        whole = ("dec.resblocks.3.convs1.0.weight", "dec.resblocks.6.convs1.0.weight",
                 "enc_p.encoder.attn_layers.0.conv_q.weight")
        assert not split & set(whole)


@pytest.mark.parametrize("n_model", [2, 4])
def test_hubert_rules_match_the_reference(n_model):
    """The HuBERT rows of the table (specs only: no path runs HuBERT
    sharded) on the full-size HuBERT's paths and shapes."""
    from rvc_tpu_torch.models.hubert import HubertConfig, HubertModel

    with torch.device("meta"):
        hubert = HubertModel(HubertConfig())
    state = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
             for k, v in hubert.state_dict().items() if v.is_floating_point()}
    params = JW.convert_hubert_state_dict(state)
    flat = {jax_mesh._path_str(p): v for p, v in jax.tree_util.tree_leaves_with_path(params)}
    hits = 0
    for path, v in flat.items():
        ref = jax_mesh._semantic_spec(path, v, n_model)
        got = semantic_spec(path, v.shape, n_model)
        assert (None if ref is None else tuple(ref)) == got, path
        hits += got is not None and "model" in got
    assert hits >= 6 * 12           # q/k/v/out_proj, intermediate/output_dense a layer


# ---------------------------------------------------------------------------
# the bytes a rank holds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    """The JAX train state of `train_pair(0)`'s init, on the host (numpy:
    `shard_state` then splits it on the host, without a program per leaf)."""
    jcfg, _ = train_configs()
    _, _, gp, dp = train_pair(0)
    g_tx, d_tx = JT.make_optimizers(jcfg, 100)
    state = JT.TrainState(gp, dp, jax.jit(g_tx.init)(gp), jax.jit(d_tx.init)(dp),
                          jnp.zeros((), jnp.int32))
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_rank_bytes_match_jax(jax_state, n_data, n_model):
    """Every rank of the port's mesh holds JAX's per-device bytes of the
    same sharded state, at SMALL_MIN."""
    _, cfg = train_configs()
    mesh = jax_mesh.make_mesh(n_data=n_data, n_model=n_model)
    ref = jax_state_bytes(shard_state(jax_state, mesh, SMALL_MIN), mesh)
    for d in range(n_data):
        for m in range(n_model):
            net_g, net_d, _, _ = train_pair(0)
            tp.shard_modules(net_g, net_d, Axis(n_model, m), SMALL_MIN)
            g_opt, d_opt = make_optimizers(cfg, net_g, net_d, 100, optimizer=lambda p, lr, **kw:
                                           ShardedAdamW(p, lr, data=Axis(n_data, d),
                                                        model=Axis(n_model, m),
                                                        min_size=SMALL_MIN, **kw))
            got = state_bytes_per_device(net_g, net_d, g_opt, d_opt, n_data * n_model)
            counts = 2 * 4       # one int32 count fewer in each of two optimizers
            assert got["param_bytes_per_device"] == ref["param_bytes_per_device"], (d, m)
            assert got["param_bytes_global"] == ref["param_bytes_global"]
            assert got["opt_bytes_per_device"] == ref["opt_bytes_per_device"] - counts, (d, m)
            assert got["opt_bytes_global"] == ref["opt_bytes_global"] - counts
            assert got["n_devices"] == ref["n_devices"]
            assert got["param_bytes_per_device"] < 0.6 * got["param_bytes_global"]


# ---------------------------------------------------------------------------
# the partial-sum chain
# ---------------------------------------------------------------------------

def test_partial_chain_matches_whole(tmp_path):
    """Two gloo ranks of the plain partial chain (C = 16, C_M = 8, k = 5)
    and of a K1 stage with one whole and two sharded chains, against the
    whole references: outputs and every gradient (a shard's against its
    slice of the whole one)."""
    from rvc_tpu_torch.ops.kernels.resblock import (resblock_chain_reference,
                                                     resblock_group_reference)

    rng = np.random.default_rng(0)
    C, ks, ds = 16, (3, 5, 7), ((1, 3, 5), (1, 3, 5), (1, 2, 3))

    def chain(k):
        return tuple(t(rng.standard_normal(s).astype(np.float32) * sc) for s, sc in (
            ((3, k, C, C), 0.2), ((3, C), 0.1), ((3, k, C, C), 0.2), ((3, C), 0.1)))

    x = t(rng.standard_normal((2, 40, C)).astype(np.float32))
    grad = t(rng.standard_normal((2, 40, C)).astype(np.float32))
    chains = [chain(k) for k in ks]
    job = str(tmp_path / "job.pt")
    torch.save({"x": x, "grad": grad, "kernel_sizes": ks, "dilations": ds, "chain_index": 1,
                "chain": [(chains[1], True)],
                "group": [(chains[0], False), (chains[1], True), (chains[2], True)]}, job)
    spawn(partial_chain_job, 2, (job,), init_method=f"file://{tmp_path / 'store'}",
          device="cpu", threads=2)
    ranks = [torch.load(f"{job}.rank{r}", weights_only=False) for r in range(2)]

    for name, sharded in (("chain", (True,)), ("group", (False, True, True))):
        leaves = [x.clone().requires_grad_(True)] + [
            w.clone().requires_grad_(True)
            for c in (chains[1:2] if name == "chain" else chains) for w in c]
        if name == "chain":
            y = resblock_chain_reference(leaves[0], *leaves[1:], kernel_size=ks[1],
                                         dilations=ds[1])
        else:
            y = resblock_group_reference(leaves[0], tuple(leaves[1:]), ks, ds)
        want = torch.autograd.grad(y, leaves, grad)
        for r, rank in enumerate(ranks):
            out, got = rank[name]
            assert _rel_l2(out, y.detach()) < 1e-6, (name, r)
            assert _rel_l2(got[0], want[0]) < 1e-6, (name, r, "x")
            for c, split in enumerate(sharded):
                for j, what in enumerate(("w1", "b1", "w2", "b2")):
                    g, w = got[1 + 4 * c + j], want[1 + 4 * c + j]
                    if split and what == "w1":
                        w = w[..., r * C // 2:(r + 1) * C // 2]
                    elif split and what == "w2":
                        w = w[:, :, r * C // 2:(r + 1) * C // 2, :]
                    assert g.shape == w.shape and _rel_l2(g, w) < 1e-6, (name, r, c, what)


# ---------------------------------------------------------------------------
# the step on mesh (1, 2)
# ---------------------------------------------------------------------------

def _global_batch(cfg):
    b = train_batch(cfg, 3, B=4, T=24, lengths=(24, 19, 22, 17))
    return b, Batch(*(t(x) for x in b))._replace(pitch=t(b[2]).long(), sid=t(b[7]).long())


def _jax_tp_step(state, np_batch):
    """Step 1's metrics of `make_sharded_train_step` on make_mesh(n_data=1,
    n_model=2) at SMALL_MIN from `state`, with the key the draws came
    from."""
    jcfg, _ = train_configs()
    mesh = jax_mesh.make_mesh(n_data=1, n_model=2)
    state = shard_state(state, mesh, SMALL_MIN)
    step = make_sharded_train_step(jcfg, jax_build(jcfg), JT.build_discriminator(jcfg), mesh,
                                   state=state)
    batch = shard_batch(JT.Batch(*map(jnp.asarray, np_batch)), mesh)
    _, metrics = step(state, batch, jax.random.PRNGKey(KEY))
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory, jax_state):
    """Two gloo ranks of `trainer_job` on mesh (1, 2) at SMALL_MIN (seed 0:
    `train_pair(0)`'s init) for STEPS steps with the JAX step's draws; the
    JAX sharded step (compiled in a thread meanwhile) and the port's
    one-process TrainStep on the same batch and draws."""
    _, cfg = train_configs()
    np_batch, batch = _global_batch(cfg)
    draws = [jax_draws(jax.random.PRNGKey(KEY + s), cfg, np_batch) for s in range(STEPS)]
    net_g, net_d, _, _ = train_pair(0)
    work = tmp_path_factory.mktemp("tp")
    job = str(work / "job.pt")
    torch.save({"config": config_to_dict(cfg), "seed": 0, "device": "cpu",
                "batch": tuple(batch), "steps": STEPS, "draws": draws, "moments": True,
                "mesh_model": 2, "min_size": SMALL_MIN}, job)
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(_jax_tp_step, jax_state, np_batch)
        spawn(trainer_job, 2, (job,), init_method=f"file://{work / 'store'}", device="cpu",
              threads=2)
        jax_metrics = jax_run.result()
    ranks = [torch.load(f"{job}.rank{r}", weights_only=False) for r in range(2)]
    g_opt, d_opt = make_optimizers(cfg, net_g, net_d, 1)
    step = TrainStep(cfg, net_g, net_d, g_opt, d_opt)
    ref = [{k: float(v) for k, v in step(batch, **draws[s]).items()} for s in range(STEPS)]
    return SimpleNamespace(ranks=ranks, ref=ref, net_g=net_g, net_d=net_d, g_opt=g_opt,
                           d_opt=d_opt, jax_metrics=jax_metrics)


def test_tp_step_matches_one_process(tp_ranks):
    """Each step's losses and grad norm, then the gathered G, D and moments
    after STEPS steps, on each rank against one process."""
    r = tp_ranks
    for rank in r.ranks:
        assert rank["mesh"] == {"data": 1, "model": 2}
        for s in range(STEPS):
            for k in LOSSES + ("grad_norm_g",):
                assert rank["metrics"][s][k] == pytest.approx(r.ref[s][k], rel=1e-5,
                                                              abs=1e-9), (s, k)
        for name, net in (("g", r.net_g), ("d", r.net_d)):
            ref = net.state_dict()
            assert rank[name].keys() == ref.keys()
            got = torch.cat([rank[name][k].flatten() for k in ref])
            assert _rel_l2(got, torch.cat([v.flatten() for v in ref.values()])) < 1e-4, name
        for name, opt in (("g_opt", r.g_opt), ("d_opt", r.d_opt)):
            state = rank[name]
            assert [m.shape for m in state["nu"]] == [m.shape for m in opt.nu]
            got, want = (torch.cat([m.flatten() for m in ms]) for ms in (state["nu"], opt.nu))
            assert _rel_l2(got, want) < 1e-4, name


def test_tp_ranks_shard_and_talk(tp_ranks):
    """The pairs ran tensor-parallel: the model axis all-reduced and
    all-gathered every step, each rank holds about half the parameter
    bytes, and the two ranks' gathered states are equal."""
    a, b = tp_ranks.ranks
    for rank in (a, b):
        assert rank["tp_kinds"]["pair"] > 0 and rank["tp_kinds"]["gathered"] > 0
        comm = rank["model_comm"]
        assert comm["all_reduce"] >= STEPS * 8 and comm["all_gather"] > 0
        sb = rank["state_bytes"]
        assert sb["param_bytes_per_device"] < 0.6 * sb["param_bytes_global"]
    assert (a["model_index"], b["model_index"]) == (0, 1)
    for name in ("g", "d"):
        for k, v in a[name].items():
            assert torch.equal(v, b[name][k]), (name, k)
    assert a["metrics"] == b["metrics"]


def test_tp_step_matches_jax_sharded_step(tp_ranks):
    """Step 1 against `make_sharded_train_step` on make_mesh(n_data=1,
    n_model=2) at the same min_size, parameters, batch and key."""
    metrics = tp_ranks.jax_metrics
    got = tp_ranks.ranks[0]["metrics"][0]
    for k in LOSSES:
        assert got[k] == pytest.approx(metrics[k], rel=1e-4, abs=1e-6), k
    assert got["grad_norm_g"] == pytest.approx(metrics["grad_norm_g"], rel=1e-3)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = """
import sys
import torch
torch.set_num_threads(2)
from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from rvc_tpu_torch.train import trainer
trainer.build_discriminator = lambda cfg: MultiPeriodDiscriminator(periods=(2,))
from rvc_tpu_torch.cli import main
main(sys.argv[1:])
"""


def test_train_cli_mesh_model(tmp_path):
    """`train --mesh_model 2 --device cpu` as two coordinator ranks on one
    data index (D cut to S and one period, as the CLI tests cut it): one
    epoch, its metrics against one process at the same batch, the export
    whole; the spawn path starts --mesh_model ranks under --device cpu."""
    import argparse

    from rvc_tpu_torch.cli import _spawns_ranks
    from test_torch_cli_distributed import TINY, _write_corpus

    solo, mesh = tmp_path / "solo", tmp_path / "mesh"
    _write_corpus(solo / "m")
    _write_corpus(mesh / "m")
    store = f"file://{tmp_path / 'store'}"

    def run(logs, extra=()):
        cmd = [sys.executable, "-c", CLI, "train", "--model_name", "m", "--logs_dir",
               str(logs), "--sample_rate", "32000", "--total_epoch", "1", "--batch_size", "8",
               "--save_every_epoch", "5", "--warmup_epochs", "0", "--no_shuffle",
               "--config_overrides", TINY, "--device", "cpu", *extra]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                cwd=ROOT, text=True)

    procs = [run(solo)] + [run(mesh, ["--coordinator", store, "--num_hosts", "2", "--host_id",
                                      str(i), "--mesh_model", "2"]) for i in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out[-3000:]}"
    solo_line, rank0, rank1 = (json.loads(o.strip().splitlines()[-1]) for o in outs)
    assert "mesh={'data': 1, 'model': 2}" in outs[1]
    assert (rank0["host"], rank1["host"]) == (0, 0) and (rank0["rank"], rank1["rank"]) == (0, 1)
    assert rank0["model"] == str(mesh / "m" / "m.safetensors") and rank1["model"] is None
    assert rank0["epochs_run"] == solo_line["epochs_run"] == 1
    logs = []
    for exp in (solo, mesh):
        with open(exp / "m" / "ckpt" / "train_log.jsonl") as f:
            logs.append([json.loads(line) for line in f])
    assert len(logs[0]) == len(logs[1]) == 1
    for k in LOSSES + ("grad_norm_g",):
        np.testing.assert_allclose(logs[1][0][k], logs[0][0][k], rtol=2e-3, err_msg=k)
    from rvc_tpu_torch.utils.weights import load_params

    a, b = (load_params(str(exp / "m" / "m.safetensors")) for exp in (solo, mesh))
    assert a.keys() == b.keys() and all(a[k].shape == b[k].shape for k in a)
    args = argparse.Namespace(coordinator=None, num_hosts=None, device="cpu", mesh_model=2)
    assert _spawns_ranks(args) == 2


def test_batch_converter_splits_rows_over_data_only():
    """A (2, 2) mesh of four CPU members: `BatchConverter` takes one device
    a data index (the first of its row) and splits each batch's rows in
    two, as the reference splits over "data" only; the rows match one
    device."""
    from rvc_tpu_torch.parallel import BatchConverter
    from rvc_tpu_torch.parallel.mesh import make_mesh
    from rvc_tpu_torch.pipelines.offline import Pipeline
    from test_torch_distributed import _chirp
    from torch_port_helpers import huberts, rmvpes, synthesizers

    pipe = Pipeline(32000, synthesizers()[0], huberts()[0], rmvpes()[0], source_noise=True)
    rvc = SimpleNamespace(pipeline=pipe, cfg=SimpleNamespace(data=SimpleNamespace(
        sample_rate=32000)), device=torch.device("cpu"))
    mesh = make_mesh(n_model=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    one, grid = BatchConverter(rvc), BatchConverter(rvc, mesh)
    assert len(grid.devices) == 2
    batch = np.stack([_chirp(0.6, f, seed=i) for i, f in enumerate((110., 180., 260., 140.))])
    ref = one.convert_batch(batch, np.array([0, 1, 1, 0]))
    np.testing.assert_allclose(grid.convert_batch(batch, np.array([0, 1, 1, 0])), ref,
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="does not split"):
        grid.convert_batch(batch[:3])
