"""`train` across processes on the CPU: two processes of the port's CLI
(`--device cpu --num_hosts 2 --host_id i --coordinator file://...`, gloo)
against one process at the same global batch (8 = 1 x 8 = 2 x 4, no
shuffle), as `tests/unit/test_multiprocess.py:166-201` holds the JAX CLI;
then the checkpoint of each resumed at the other world size.

Each process runs the CLI's `main` with the discriminator cut to S and one
period, as `test_torch_trainer.py`'s `small_discriminator` cuts it (its
checkpoints would otherwise run to hundreds of MB a save).

Bars: every metric of each epoch within rtol 2e-3 (the JAX test's); one
log line an epoch and one export (rank 0 writes); a resume into one
process loads the two ranks' gathered moments as they are, and a resume
into two ranks gathers back the one process's file bit for bit."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rvc_tpu_torch.configs import config_from_dict
from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from rvc_tpu_torch.monitoring import NullTracker
from rvc_tpu_torch.train import trainer as trainer_mod
from rvc_tpu_torch.train.data import DataLoader, RVCDataset
from rvc_tpu_torch.utils import audio as audio_utils
from rvc_tpu_torch.utils import weights as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = json.dumps({"model_spk_embed_dim": 2, "model_n_layers": 1,
                   "model_upsample_initial_channel": 64, "train_segment_size": 3840})
PRELUDE = """
import sys
import torch
torch.set_num_threads(2)
from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from rvc_tpu_torch.train import trainer
trainer.build_discriminator = lambda cfg: MultiPeriodDiscriminator(periods=(2,))
"""
CLI = PRELUDE + """
from rvc_tpu_torch.cli import main
main(sys.argv[1:])
"""
# one rank of a resume: the checkpoint `name` into a two-rank trainer, then
# saved again as "resaved" (the moments gathered back)
RESUME = PRELUDE + """
import json, os
import torch.distributed as dist
from rvc_tpu_torch.configs import config_from_dict
from rvc_tpu_torch.monitoring import NullTracker
from rvc_tpu_torch.parallel.distributed import initialize
from rvc_tpu_torch.parallel.mesh import make_mesh
from rvc_tpu_torch.train.data import DataLoader, RVCDataset
from rvc_tpu_torch.train.trainer import RVCTrainer
ckpt, name, store, rank = sys.argv[1:5]
initialize(store, 2, int(rank), device="cpu")
with open(os.path.join(ckpt, name + "_state.json")) as f:
    cfg = config_from_dict(json.load(f)["config"])
tr = RVCTrainer(cfg, DataLoader(RVCDataset([], cfg.data.hop_length), 1), checkpoint_dir=ckpt,
                tracker=NullTracker(), mesh=make_mesh(), device="cpu")
tr.resume(name)
assert any(m.numel() < p.numel() for m, p in zip(tr.g_opt.mu, tr.g_opt.params))
tr.step_fn(True)
tr.save_checkpoint("resaved")
dist.destroy_process_group()
"""


def _write_corpus(exp_dir, n=8, T=48, spec_ch=513, hop=320, sr=32000):
    """`tests/unit/test_multiprocess.py`'s synthetic extracted dataset."""
    os.makedirs(exp_dir, exist_ok=True)
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n):
        base = os.path.join(exp_dir, f"s{i}")
        f0 = np.full(T, 150.0 + 10 * i, np.float32)
        np.save(base + "_feats.npy", rng.standard_normal((T // 2, 768)).astype(np.float32))
        np.save(base + "_f0.npy", f0)
        np.save(base + "_f0c.npy", np.clip((f0 / 4).astype(np.int32), 1, 255))
        np.save(base + "_spec.npy", rng.standard_normal((T, spec_ch)).astype(np.float32))
        audio_utils.save_wav(base + ".wav", (0.1 * rng.standard_normal(T * hop)).astype(
            np.float32), sr)
        rows.append("|".join([base + ".wav", base + "_feats.npy", base + "_f0.npy",
                              base + "_f0c.npy", "0", base + "_spec.npy"]))
    with open(os.path.join(exp_dir, "filelist_train.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def _train(logs_dir, batch_size, extra=()):
    cmd = [sys.executable, "-c", CLI, "train", "--model_name", "m", "--logs_dir", str(logs_dir),
           "--sample_rate", "32000", "--total_epoch", "2", "--batch_size", str(batch_size),
           "--save_every_epoch", "5", "--warmup_epochs", "0", "--no_shuffle",
           "--config_overrides", TINY, "--device", "cpu", *extra]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT,
                            text=True)


def _finish(procs):
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(solo dir, dual dir, their final JSON lines): one process at batch 8
    and two at 4, started together."""
    root = tmp_path_factory.mktemp("cli")
    solo, dual = root / "solo", root / "dual"
    _write_corpus(solo / "m")
    _write_corpus(dual / "m")
    store = f"file://{root / 'store'}"
    procs = [_train(solo, 8)] + [
        _train(dual, 4, ["--coordinator", store, "--num_hosts", "2", "--host_id", str(i)])
        for i in range(2)]
    lines = _finish(procs)
    return solo / "m", dual / "m", lines


def _log(exp):
    with open(exp / "ckpt" / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def test_two_processes_match_one(runs):
    solo, dual, (solo_line, rank0, rank1) = runs
    a, b = _log(solo), _log(dual)
    assert len(a) == len(b) == 2                     # rank 0 alone logs
    for x, y in zip(a, b):
        assert x["batches"] == y["batches"] == 1
        for k in ("loss_g_total", "loss_d", "loss_mel", "loss_kl", "loss_adv", "loss_fm",
                  "grad_norm_g"):
            np.testing.assert_allclose(y[k], x[k], rtol=2e-3, err_msg=k)
    assert (rank0["host"], rank1["host"]) == (0, 1)
    assert rank0["model"] == str(dual / "m.safetensors") and rank1["model"] is None
    assert solo_line["model"] == str(solo / "m.safetensors")
    assert os.path.exists(dual / "m.safetensors") and os.path.exists(dual / "m.json")
    assert rank0["epochs_run"] == rank1["epochs_run"] == 2


def _opt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same_state(a, b):
    for net in ("g_opt", "d_opt"):
        assert torch.equal(a[net]["count"], b[net]["count"])
        for key in ("mu", "nu"):
            assert len(a[net][key]) == len(b[net][key])
            assert all(torch.equal(x, y) for x, y in zip(a[net][key], b[net][key])), (net, key)


def test_resume_across_world_sizes(runs, monkeypatch):
    """The two ranks' checkpoint into one process (moments and parameters
    as written; the moments near the one process's own run), and the one
    process's checkpoint into two ranks, which gather it back unchanged."""
    solo, dual, _ = runs
    monkeypatch.setattr(trainer_mod, "build_discriminator",
                        lambda cfg: MultiPeriodDiscriminator(periods=(2,)))
    ckpt = dual / "ckpt"
    with open(ckpt / "last_state.json") as f:
        meta = json.load(f)
    cfg = config_from_dict(meta["config"])
    one = trainer_mod.RVCTrainer(cfg, DataLoader(RVCDataset([], cfg.data.hop_length), 1),
                                 checkpoint_dir=str(ckpt), tracker=NullTracker(), device="cpu")
    one.resume("last")
    assert (one.epoch, one.step) == (meta["epoch"], meta["step"]) == (2, 2)
    written = _opt(ckpt / "last_opt.pt")
    _assert_same_state({"g_opt": one.g_opt.state_dict(), "d_opt": one.d_opt.state_dict()},
                       written)
    g = W.load_params(str(ckpt / "last_G.safetensors"))
    for k, v in W.synthesizer_to_jax(one.net_g.state_dict()).items():
        np.testing.assert_array_equal(v, g[k], err_msg=k)
    own = _opt(solo / "ckpt" / "last_opt.pt")
    for net in ("g_opt", "d_opt"):
        for key, bar in (("nu", 1e-4), ("mu", 8e-3)):   # over all of an optimizer's
            x, y = (torch.cat([t.double().flatten() for t in s[net][key]])
                    for s in (written, own))
            assert float((x - y).norm() / y.norm()) < bar, (net, key)

    store = f"file://{solo.parent / 'resume_store'}"
    procs = [subprocess.Popen([sys.executable, "-c", RESUME, str(solo / "ckpt"), "last", store,
                               str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              cwd=ROOT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    _assert_same_state(_opt(solo / "ckpt" / "resaved_opt.pt"),
                       _opt(solo / "ckpt" / "last_opt.pt"))
    for part in ("G", "D"):
        a = W.load_params(str(solo / "ckpt" / f"resaved_{part}.safetensors"))
        b = W.load_params(str(solo / "ckpt" / f"last_{part}.safetensors"))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
