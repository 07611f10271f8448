"""`rvc_tpu_torch.cli` with the post-processing and export flags, on the
CPU, against `RVC(...).infer_file` on the same files (the JAX package's
`.pth` and `.index`, built by `test_torch_cli.files`). A file of its own, so
that its conversions run beside `test_torch_cli.py`'s; its full-size
HuBERT and RMVPE run on two threads, beside the suite's other workers."""

import shutil
import sys

import numpy as np
import pytest

from rvc_tpu_torch.cli import main
from rvc_tpu_torch.utils import audio as audio_utils
from test_torch_cli import (_api, _model_args, files, no_embedders,  # noqa: F401 (fixtures)
                            two_threads)


@pytest.fixture(scope="module")
def api(files, tmp_path_factory):
    """One RVC over the files for the module (no contentvec on disk)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RVC_TPU_MODELS_DIR", str(tmp_path_factory.mktemp("models")))
        yield _api(files)


@pytest.mark.parametrize("flags,kwargs", [
    (["--split_audio"], dict(split_audio=True)),
    (["--export_format", "MP3"], None),
    (["--post_process", "--reverb"], dict(post_process=True, reverb=True)),
    (["--post_process", "--gain", "--gain_db", "3"], dict(post_process=True, gain=True,
                                                         gain_db=3.0)),
], ids=["split_audio", "export_format", "reverb", "gain_db"])
def test_postfx_and_export_flags(files, api, tmp_path, monkeypatch, flags, kwargs):
    """Splitting and the effects convert on the CPU as the API does with the
    same arguments; MP3 without soundfile or ffmpeg fails with the
    encoder's RuntimeError and writes no file."""
    argv = ["infer", "--input_path", str(files / "in" / "a.wav"), "--output_path",
            str(tmp_path / "o.wav"), *_model_args(files), *flags]
    if kwargs is None:
        monkeypatch.setitem(sys.modules, "soundfile", None)
        monkeypatch.setattr(shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="cannot export MP3"):
            main(argv)
        assert list(tmp_path.iterdir()) == []
        return
    main(argv)
    api.infer_file(str(files / "in" / "a.wav"), str(tmp_path / "api.wav"), **kwargs)
    got, sr = audio_utils.load_wav(str(tmp_path / "o.wav"))
    ref, _ = audio_utils.load_wav(str(tmp_path / "api.wav"))
    assert sr == 32000 and np.isfinite(got).all() and len(got) >= int(0.6 * 32000)
    np.testing.assert_array_equal(got, ref)
