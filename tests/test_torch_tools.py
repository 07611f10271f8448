"""The port's host tools against the JAX package's on the same files and
audio: `tools/model_tools.py` (model_information, model_blender, convert,
audio_analyzer), `tools/plot_logs.py`, `monitoring/voice_metrics.py`, and
their CLI subcommands.

Bars: JSON dicts equal; blended and converted tensors equal bit for bit,
with equal config sidecars; the voice metrics within 1e-6."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from rvc_tpu.monitoring import voice_metrics as jax_metrics
from rvc_tpu.tools import model_tools as jax_tools
from rvc_tpu.tools import plot_logs as jax_plot
from rvc_tpu_torch.cli import main
from rvc_tpu_torch.configs import config_to_dict
from rvc_tpu_torch.configs import get_config as port_get_config
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.monitoring import voice_metrics
from rvc_tpu_torch.tools import model_tools, plot_logs
from rvc_tpu_torch.utils import audio as audio_utils
from rvc_tpu_torch.utils import weights as W
from torch_port_helpers import SMALL_SYNTH_ARGS


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Two small seeded voice models as upstream `.pth` files, and the first
    as a native `.safetensors` with its `.json` config."""
    root = tmp_path_factory.mktemp("models")
    cfg = port_get_config(32000, **SMALL_SYNTH_ARGS)
    paths = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        state = build_synthesizer(cfg).state_dict()
        paths.append(W.export_pth(state, cfg, str(root / f"m{seed}.pth"), name=f"m{seed}"))
    native = str(root / "m0.safetensors")
    torch.manual_seed(0)
    W.save_params(W.synthesizer_to_jax(build_synthesizer(cfg).state_dict()), native,
                  config=config_to_dict(cfg))
    return root, paths, native


def _same_files(a, b):
    """Two .safetensors (the port's writer, the JAX package's) hold the same
    tensors, bit for bit, and equal .json sidecars where either has one."""
    got, ref = W.load_params(a), load_file(b)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    sides = [os.path.splitext(p)[0] + ".json" for p in (a, b)]
    assert os.path.exists(sides[0]) == os.path.exists(sides[1])
    if os.path.exists(sides[0]):
        with open(sides[0]) as f, open(sides[1]) as g:
            assert json.load(f) == json.load(g)


@pytest.mark.parametrize("which", ["pth", "safetensors"])
def test_model_information_matches_jax(models, which):
    _, paths, native = models
    path = paths[0] if which == "pth" else native
    got, ref = model_tools.model_information(path), jax_tools.model_information(path)
    assert json.dumps(got, default=str) == json.dumps(ref, default=str)
    assert got["n_params"] > 0


@pytest.mark.parametrize("second", ["pth", "safetensors"])
def test_model_blender_matches_jax(models, second):
    """ratio 0.3 of the first .pth and the second model (a .pth, or the
    first's own .safetensors)."""
    root, paths, native = models
    b = paths[1] if second == "pth" else native
    got = model_tools.blend_models(paths[0], b, 0.3, str(root / f"port_{second}.safetensors"))
    ref = jax_tools.blend_models(paths[0], b, 0.3, str(root / f"jax_{second}.safetensors"))
    _same_files(got, ref)


def test_convert_matches_jax(models):
    root, paths, _ = models
    got = model_tools.convert_model(paths[1], str(root / "port_conv.safetensors"))
    ref = jax_tools.convert_model(paths[1], str(root / "jax_conv.safetensors"))
    _same_files(got, ref)


def test_audio_analyzer_matches_jax(tmp_path):
    sr = 22050
    t = np.arange(int(1.3 * sr)) / sr
    y = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(0).standard_normal(len(t))
    path = str(tmp_path / "a.wav")
    audio_utils.save_wav(path, y.astype(np.float32), sr)
    got = model_tools.analyze_audio(path, str(tmp_path / "port.png"))
    ref = jax_tools.analyze_audio(path, str(tmp_path / "jax.png"))
    assert got.pop("plot_path") == str(tmp_path / "port.png")
    assert ref.pop("plot_path") == str(tmp_path / "jax.png")
    assert got == ref
    assert os.path.getsize(tmp_path / "port.png") > 0


def test_voice_metrics_match_jax():
    rng = np.random.default_rng(3)
    sr = 16000
    t = np.arange(sr) / sr
    ref = 0.5 * np.sin(2 * np.pi * 200 * t) + 0.01 * rng.standard_normal(sr)
    est = 0.45 * np.sin(2 * np.pi * 203 * t + 0.2) + 0.02 * rng.standard_normal(sr)
    f0_ref = np.where(rng.random(100) > 0.2, rng.uniform(100, 300, 100), 0.0)
    f0_est = np.where(rng.random(100) > 0.2, f0_ref * rng.uniform(0.97, 1.03, 100), 0.0)
    got = voice_metrics.f0_accuracy(f0_ref, f0_est)
    want = jax_metrics.f0_accuracy(f0_ref, f0_est)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    for name, args in (("mel_cepstral_distortion", (ref, est, sr)),
                       ("spectrogram_correlation", (ref, est)),
                       ("log_mel_correlation", (ref, est, sr)),
                       ("signal_to_noise_ratio", (ref, est))):
        got = getattr(voice_metrics, name)(*args)
        assert got == pytest.approx(getattr(jax_metrics, name)(*args), abs=1e-6), name
    assert voice_metrics.spectrogram_correlation(ref, est, top_db=80.0) == pytest.approx(
        jax_metrics.spectrogram_correlation(ref, est, top_db=80.0), abs=1e-6)


def _train_log(path):
    rows = [{"epoch": e, "loss_g_total": 40.0 - e, "loss_d": 3.0 + 0.1 * e,
             "grad_norm_g": 1.0 / (e + 1), "batches": 2} for e in range(4)]
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\nnot json\n")


def test_plot_logs_match_jax(tmp_path):
    log = str(tmp_path / "train_log.jsonl")
    _train_log(log)
    assert plot_logs.load_jsonl(log) == jax_plot.load_jsonl(log)
    out = plot_logs.plot(log, str(tmp_path / "curves.png"))
    assert out == str(tmp_path / "curves.png") and os.path.getsize(out) > 0


def test_tool_subcommands(models, tmp_path, capsys, monkeypatch):
    """The five subcommands with the reference's flags; `tensorboard` falls
    back to PNG plots of the JSONL logs where tensorboard does not import."""
    root, paths, _ = models
    main(["model_information", "--model_path", paths[0]])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(
        jax_tools.model_information(paths[0]), default=str))
    out = str(tmp_path / "blend.safetensors")
    main(["model_blender", "--pth_path_1", paths[0], "--pth_path_2", paths[1],
          "--ratio", "0.5", "--output_path", out])
    assert capsys.readouterr().out.strip() == f"wrote {out}"
    _same_files(out, jax_tools.blend_models(paths[0], paths[1], 0.5,
                                            str(tmp_path / "jax_blend.safetensors")))
    main(["convert", "--pth_path", paths[0], "--output_path", str(tmp_path / "c.safetensors")])
    assert os.path.exists(tmp_path / "c.safetensors") and os.path.exists(tmp_path / "c.json")
    wav = str(tmp_path / "a.wav")
    audio_utils.save_wav(wav, np.zeros(1600, np.float32), 16000)
    capsys.readouterr()
    main(["audio_analyzer", "--input_path", wav, "--plot_path", ""])
    assert json.loads(capsys.readouterr().out)["samples"] == 1600
    logs = tmp_path / "logs" / "m" / "ckpt"
    logs.mkdir(parents=True)
    _train_log(str(logs / "train_log.jsonl"))
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    main(["tensorboard", "--logs_path", str(tmp_path / "logs")])
    assert capsys.readouterr().out.strip() == str(logs / "train_log.png")
    assert os.path.getsize(logs / "train_log.png") > 0
