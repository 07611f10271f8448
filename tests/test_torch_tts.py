"""`rvc_tpu_torch.tools.tts` and `cli tts` against `rvc_tpu`'s on the same
stubs: the built-in catalog, `list_voices` from each of its sources,
`synthesize` and `tts_and_convert` through a stub `edge_tts` module (the
real one needs a network), and the CLI's refusals. No model is built: the
conversions go to a recording stub."""

import json
import sys
import types

import numpy as np
import pytest

from rvc_tpu import cli as jax_cli
from rvc_tpu.tools import tts as J
from rvc_tpu_torch import cli as port_cli
from rvc_tpu_torch.tools import tts as P
from rvc_tpu_torch.utils.audio import save_wav


class _Recorder:
    """A stub `rvc`: `infer_file` records its arguments."""

    def __init__(self):
        self.calls = []

    def infer_file(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return args[1]


def _edge_tts(said: list, voices=()):
    """A stub `edge_tts`: `Communicate(...).save(path)` records the text,
    voice and rate and writes a seeded 16 kHz chirp WAV; `list_voices`
    returns `voices`."""
    mod = types.ModuleType("edge_tts")

    class Communicate:
        def __init__(self, text, voice, rate="+0%"):
            self.args = (text, voice, rate)

        async def save(self, path):
            said.append(self.args)
            t = np.arange(8000) / 16000
            tone = 0.3 * np.sin(2 * np.pi * (150 * t + 100 * t * t))
            save_wav(path, tone.astype(np.float32), 16000)

    async def list_voices():
        return [{"ShortName": v} for v in voices]

    mod.Communicate, mod.list_voices = Communicate, list_voices
    return mod


def test_builtin_catalog_equals_reference():
    got = P.builtin_catalog()
    assert got == J.builtin_catalog() and len(got) == 322
    assert P.FALLBACK_VOICES == J.FALLBACK_VOICES


@pytest.mark.parametrize("source", ["edge_tts", "dicts", "strings", "none"])
def test_list_voices_equals_reference(monkeypatch, tmp_path, source):
    """edge-tts where it imports; else RVC_TPU_TTS_VOICES (a list of dicts
    or of names); else the built-in catalog."""
    monkeypatch.chdir(tmp_path)                     # no models/tts_voices.json here
    monkeypatch.delenv("RVC_TPU_TTS_VOICES", raising=False)
    stub = _edge_tts([], voices=("zz-ZZ-BNeural", "aa-AA-ANeural"))
    monkeypatch.setitem(sys.modules, "edge_tts", stub if source == "edge_tts" else None)
    if source in ("dicts", "strings"):
        names = ["en-US-GuyNeural", "de-DE-KatjaNeural"]
        data = [{"ShortName": n} for n in names] if source == "dicts" else names
        (tmp_path / "voices.json").write_text(json.dumps(data))
        monkeypatch.setenv("RVC_TPU_TTS_VOICES", str(tmp_path / "voices.json"))
    got = P.list_voices()
    assert got == J.list_voices()
    want = {"edge_tts": ["aa-AA-ANeural", "zz-ZZ-BNeural"],
            "dicts": ["de-DE-KatjaNeural", "en-US-GuyNeural"],
            "strings": ["de-DE-KatjaNeural", "en-US-GuyNeural"]}
    assert got == want.get(source, P.builtin_catalog())


def _run_both(monkeypatch, fn):
    """fn(module) for each package with its own stub edge_tts; the stubs'
    records."""
    out = []
    for module in (J, P):
        said = []
        monkeypatch.setitem(sys.modules, "edge_tts", _edge_tts(said))
        out.append((fn(module), said))
    return out


@pytest.mark.parametrize("rate", [0, 25, -10])
def test_synthesize_equals_reference(monkeypatch, tmp_path, rate):
    runs = _run_both(monkeypatch, lambda m: m.synthesize(
        "Hello there.", "en-GB-RyanNeural", rate, str(tmp_path / f"{m.__name__}.wav")))
    assert [s for _, s in runs] == [[("Hello there.", "en-GB-RyanNeural", f"{rate:+d}%")]] * 2


def test_tts_and_convert_equals_reference(monkeypatch, tmp_path):
    """The same text, voice and rate to edge-tts, and the same
    `infer_file` call: (tts wav, output, the infer kwargs)."""
    def run(module):
        rvc = _Recorder()
        out = module.tts_and_convert(rvc, "Speak.", "en-US-AriaNeural", str(tmp_path / "o.wav"),
                                     rate=5, tts_wav=str(tmp_path / "t.wav"), pitch=2.0,
                                     f0_method="pm", index_rate=0.5)
        return out, rvc.calls

    ref, got = _run_both(monkeypatch, run)
    assert got == ref
    (out, calls), said = got
    assert said == [("Speak.", "en-US-AriaNeural", "+5%")] and len(calls) == 1


def _argv(tmp_path, *extra):
    return ["tts", "--output_path", str(tmp_path / "out.wav"), "--model_path", "m.pth",
            "--output_tts_path", str(tmp_path / "tts.wav"), *extra]


def test_cli_tts_refuses_without_edge_tts(monkeypatch, tmp_path, capsys):
    """Exit 2 with the reference's message, before any model is loaded."""
    monkeypatch.setitem(sys.modules, "edge_tts", None)
    errs = []
    for cli in (jax_cli, port_cli):
        with pytest.raises(SystemExit) as e:
            cli.main(_argv(tmp_path, "--tts_text", "hi"))
        assert e.value.code == 2
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "edge-tts is not installed" in errs[1]


def test_cli_tts_refuses_empty_text(monkeypatch, tmp_path, capsys):
    monkeypatch.setitem(sys.modules, "edge_tts", _edge_tts([]))
    (tmp_path / "empty.txt").write_text("  \n")
    for extra in ((), ("--tts_file", str(tmp_path / "empty.txt"))):
        for cli in (jax_cli, port_cli):
            with pytest.raises(SystemExit) as e:
                cli.main(_argv(tmp_path, *extra))
            assert e.value.code == 2
            assert "no TTS text" in capsys.readouterr().err


def test_cli_tts_reads_the_text_file(monkeypatch, tmp_path):
    """--tts_file's text, --tts_voice and --tts_rate go to edge-tts, and the
    conversion gets what the reference's gets (its wav, the output and the
    infer kwargs)."""
    (tmp_path / "text.txt").write_text("  Read me aloud.\n")
    argv = _argv(tmp_path, "--tts_file", str(tmp_path / "text.txt"), "--tts_voice",
                 "fr-FR-DeniseNeural", "--tts_rate", "-20", "--pitch", "3", "--f0_method", "pm")
    runs = []
    for cli in (jax_cli, port_cli):
        said, rvc = [], _Recorder()
        monkeypatch.setitem(sys.modules, "edge_tts", _edge_tts(said))
        monkeypatch.setattr(cli, "_load_rvc", lambda args: rvc)
        cli.main(argv)
        runs.append((said, rvc.calls))
    assert runs[0] == runs[1]
    assert runs[1][0] == [("Read me aloud.", "fr-FR-DeniseNeural", "-20%")]


def test_cli_tts_converts_on_the_card_by_default(monkeypatch, tmp_path):
    """Without --device, tts loads its model on the card, and with none it
    raises (no fallback to the host)."""
    import torch

    monkeypatch.setitem(sys.modules, "edge_tts", _edge_tts([]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(_argv(tmp_path, "--tts_text", "hi"))
