"""`rvc_tpu_torch.cli` on the CPU: `infer` and `batch_infer` with a `.pth`
and an `.index` that the JAX package wrote, against `RVC(...).infer_file`
on the same files, with the pitch methods' flags too (the post-processing
and export flags: `test_torch_cli_postfx.py`). The voice model is narrow
but takes HuBERT's 768-wide
features, as upstream v2 models do; HuBERT and RMVPE are the seeded random
full-size modules that `RVC` builds when no checkpoint is found."""

import argparse
import json

import numpy as np
import pytest

from rvc_tpu import retrieval as JR
from rvc_tpu.configs import get_config
from rvc_tpu.utils import weights as W
from rvc_tpu_torch.api import RVC
from rvc_tpu_torch.cli import main
from rvc_tpu_torch.configs import get_config as port_get_config
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.utils import audio as audio_utils
from torch_port_helpers import SMALL_SYNTH_ARGS, numpy_state

V2_ARGS = {k: v for k, v in SMALL_SYNTH_ARGS.items() if k != "model_text_enc_hidden_dim"}


def _tone(seconds, f, seed):
    t = np.arange(int(seconds * 16000)) / 16000
    noise = 0.01 * np.random.default_rng(seed).standard_normal(len(t))
    return (0.4 * np.sin(2 * np.pi * f * t) + noise).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A folder of two WAVs, and the JAX package's .pth and .index."""
    import torch

    root = tmp_path_factory.mktemp("cli")
    (root / "in").mkdir()
    for name, f in (("a.wav", 150.0), ("b.wav", 220.0)):
        audio_utils.save_wav(str(root / "in" / name), _tone(0.6, f, seed=int(f)), 16000)
    torch.manual_seed(3)
    port = build_synthesizer(port_get_config(32000, **V2_ARGS))
    W.export_pth(W.convert_synthesizer_state_dict(numpy_state(port)),
                 get_config(32000, **V2_ARGS), str(root / "model.pth"))
    feats = np.random.default_rng(4).standard_normal((400, 768)).astype(np.float32)
    JR.write_faiss_index(JR.build_index(feats, seed=0, kmeans_iters=4), str(root / "model.index"))
    return root


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The full-size HuBERT and RMVPE run on two threads, beside the
    suite's other workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_embedders(tmp_path, monkeypatch):
    """No contentvec on disk: HuBERT is the seeded random init."""
    monkeypatch.setenv("RVC_TPU_MODELS_DIR", str(tmp_path / "models"))


def _model_args(files):
    return ["--model_path", str(files / "model.pth"), "--index_path", str(files / "model.index"),
            "--device", "cpu"]


def _api(files):
    return RVC(model_path=str(files / "model.pth"), index_path=str(files / "model.index"),
               device="cpu")


def test_infer_equals_the_api(files, tmp_path):
    out = tmp_path / "cli.wav"
    main(["infer", "--input_path", str(files / "in" / "a.wav"), "--output_path", str(out),
          "--pitch", "2", "--protect", "0.33", *_model_args(files)])
    rvc = _api(files)
    assert rvc.index is not None and rvc.index.ntotal == 400
    rvc.infer_file(str(files / "in" / "a.wav"), str(tmp_path / "api.wav"), pitch=2,
                   protect=0.33, index_rate=0.75)
    got, sr = audio_utils.load_wav(str(out))
    ref, _ = audio_utils.load_wav(str(tmp_path / "api.wav"))
    assert sr == 32000 and got.shape == (int(0.6 * 32000),) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_batch_infer_equals_the_api(files, tmp_path, capsys):
    main(["batch_infer", "--input_folder", str(files / "in"), "--output_folder",
          str(tmp_path / "out"), *_model_args(files)])
    assert "2 files converted" in capsys.readouterr().out
    rvc = _api(files)
    for name in ("a", "b"):
        rvc.infer_file(str(files / "in" / f"{name}.wav"), str(tmp_path / f"{name}.wav"))
        got, _ = audio_utils.load_wav(str(tmp_path / "out" / f"{name}_output.wav"))
        ref, _ = audio_utils.load_wav(str(tmp_path / f"{name}.wav"))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("flags,kwargs", [
    (["--f0_method", "crepe-tiny"], dict(f0_method="crepe-tiny")),
    (["--f0_method", "crepe-tiny", "--hop_length", "320"],
     dict(f0_method="crepe-tiny", f0_hop_length=320)),
    (["--f0_file", "f0.txt"], dict(input_f0="f0.txt")),
    (["--proposed_pitch", "--proposed_pitch_threshold", "200"],
     dict(proposed_pitch=True, proposed_pitch_threshold=200.0)),
], ids=["f0_method", "hop_length", "f0_file", "proposed_pitch"])
def test_pitch_flags_equal_the_api(files, tmp_path, flags, kwargs):
    """The staged path's pitch flags convert on the CPU, as the API does
    with the same arguments. The f0 file is read with np.loadtxt and
    flattened (one value per 10 ms frame, here 6 rows of 10)."""
    f0 = (150.0 + 20.0 * np.sin(np.arange(60) / 7.0)).reshape(6, 10)
    np.savetxt(tmp_path / "f0.txt", f0)
    flags = [str(tmp_path / f) if f == "f0.txt" else f for f in flags]
    if "input_f0" in kwargs:
        kwargs = dict(input_f0=np.loadtxt(tmp_path / "f0.txt", dtype=np.float32).ravel())
    out = tmp_path / "cli.wav"
    main(["infer", "--input_path", str(files / "in" / "a.wav"), "--output_path", str(out),
          *_model_args(files), *flags])
    _api(files).infer_file(str(files / "in" / "a.wav"), str(tmp_path / "api.wav"), **kwargs)
    got, sr = audio_utils.load_wav(str(out))
    ref, _ = audio_utils.load_wav(str(tmp_path / "api.wav"))
    assert sr == 32000 and got.shape == (int(0.6 * 32000),) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_unknown_f0_method_fails(files, tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(["infer", "--input_path", str(files / "in" / "a.wav"), "--output_path",
              str(tmp_path / "o.wav"), *_model_args(files), "--f0_method", "bogus"])
    assert exit_info.value.code == 2
    assert "invalid f0 method 'bogus'" in capsys.readouterr().err
    assert not (tmp_path / "o.wav").exists()


def test_default_device_is_the_card(files, tmp_path, monkeypatch):
    """Without --device the CLI runs on the card, and with none it raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["infer", "--input_path", str(files / "in" / "a.wav"), "--output_path",
              str(tmp_path / "o.wav"), "--model_path", str(files / "model.pth")])


@pytest.mark.parametrize("features", ["missing", "empty"])
def test_index_without_features_exits_2(tmp_path, capsys, features):
    """As `rvc_tpu/cli.py`'s `index`: the message on stderr and exit 2,
    a missing features directory counting as an empty one."""
    if features == "empty":
        (tmp_path / "m" / "features").mkdir(parents=True)
    with pytest.raises(SystemExit) as e:
        main(["index", "--model_name", "m", "--logs_dir", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 2
    assert "no features found; run extract first" in capsys.readouterr().err


class _StubTrainer:
    """`RVCTrainer` without the training: one epoch run, its export named."""

    def __init__(self, *args, **kwargs):
        pass

    def train(self, total_epoch, save_every=None):
        return {"epochs_run": total_epoch, "best_loss": 1.5}

    def export_inference_model(self, path):
        return path


def _raise(exc):
    def fn(args):
        raise exc
    return fn


@pytest.mark.parametrize("failure,warning", [
    ("FileNotFoundError", "(FileNotFoundError: no features dir)"),
    ("SystemExit", "(exit 2)"),
    ("no features", "(exit 2)"),
])
def test_train_summary_survives_a_failed_index(tmp_path, capsys, monkeypatch, failure, warning):
    """`train --index_algorithm Auto` after a finished run: a failed index
    build (an exception, a SystemExit, or the real `index` with no features
    directory) prints the reference's warning, and the JSON summary line
    still comes out."""
    import rvc_tpu_torch.cli as cli
    from rvc_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "RVCTrainer", _StubTrainer)
    if failure == "FileNotFoundError":
        monkeypatch.setattr(cli, "cmd_index", _raise(FileNotFoundError("no features dir")))
    elif failure == "SystemExit":
        monkeypatch.setattr(cli, "cmd_index", _raise(SystemExit(2)))
    exp = tmp_path / "m"
    exp.mkdir()
    (exp / "filelist_train.txt").write_text("")
    main(["train", "--model_name", "m", "--logs_dir", str(tmp_path), "--total_epoch", "1",
          "--index_algorithm", "Auto", "--device", "cpu"])
    out = capsys.readouterr()
    assert f"warning: post-training index build failed {warning}" in out.err
    summary = json.loads(out.out.strip().splitlines()[-1])
    assert summary == {"epochs_run": 1, "best_loss": 1.5, "model": str(exp / "m.safetensors"),
                       "host": 0, "rank": 0}


def _subparser(parser, command):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[command]


def _actions(parser) -> dict:
    return {a.dest: (a.option_strings, a.default, a.choices and list(a.choices), a.required,
                     a.nargs, a.const)
            for a in parser._actions if a.dest not in ("help", "device")}


@pytest.mark.parametrize("command", ["tts", "download", "prerequisites"])
def test_parser_actions_match_reference(monkeypatch, command):
    """Flag for flag (dest, option strings, default, choices, required,
    nargs), the port's --device aside; and the same defaults set."""
    import rvc_tpu.cli as jax_cli
    from rvc_tpu_torch.cli import build_parser

    seen = {}

    def capture(self, argv=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jax_cli.main([command])
    monkeypatch.undo()
    ref, got = _subparser(seen["parser"], command), _subparser(build_parser(), command)
    assert _actions(got) == _actions(ref)
    assert {k: v for k, v in got._defaults.items() if k != "fn"} == \
        {k: v for k, v in ref._defaults.items() if k != "fn"}
    if command == "tts":
        assert got._defaults["fn"].__name__ == "cmd_tts"
        assert [a.default for a in got._actions if a.dest == "device"] == [None]
