"""`rvc_tpu_torch.cli` on the CPU: `infer` and `batch_infer` with a `.pth`
and an `.index` that the JAX package wrote, against `RVC(...).infer_file`
on the same files, with the pitch methods' flags too (the post-processing
and export flags: `test_torch_cli_postfx.py`). The voice model is narrow
but takes HuBERT's 768-wide
features, as upstream v2 models do; HuBERT and RMVPE are the seeded random
full-size modules that `RVC` builds when no checkpoint is found."""

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
