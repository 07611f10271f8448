"""The port's RefineGAN decoder against the benchmark's plain reference
(`portbench/reference/refinegan.py`) at small widths, its spans under
RVC_TPU_TRACE=1, and the data-parallel collectives' spans on two gloo
ranks."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rvc_tpu_torch.configs import config_to_dict, get_config
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.utils import profiling

from portbench.drivers import longform_refinegan as D
from portbench.reference import refinegan as RG

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(model_spk_embed_dim=2, model_n_layers=1, model_hidden_channels=32,
             model_inter_channels=16, model_filter_channels=64, model_gin_channels=16,
             model_text_enc_hidden_dim=32, model_upsample_initial_channel=64,
             model_vocoder="RefineGAN")
B, T = 2, 12


@pytest.fixture(scope="module")
def pair():
    """(port Synthesizer, reference Synthesizer) with one seeded state."""
    cfg = get_config(32000, **SMALL)
    port = build_synthesizer(cfg).eval()
    ref = RG.build(config_to_dict(cfg)).eval()
    state = D.make(ref, 2 ** 31 + 5, "cpu", 2)
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port, ref


def _inputs():
    g = torch.Generator().manual_seed(3)
    f0 = 100 + 200 * torch.rand(B, T, generator=g)
    f0[:, 3:5] = 0.0                                      # an unvoiced stretch
    return dict(z=torch.randn(B, T, 16, generator=g), f0=f0,
                phone=torch.randn(B, T, 32, generator=g),
                pitch=torch.randint(1, 255, (B, T), generator=g),
                sid=torch.tensor([0, 1]), g=torch.randn(B, 1, 16, generator=g))


def _gen(noise):
    return torch.Generator().manual_seed(0x5EED) if noise else None


@pytest.mark.parametrize("noise", [True, False], ids=["noise", "quiet"])
@pytest.mark.parametrize("entry", ["decoder", "infer"])
def test_port_matches_reference(pair, entry, noise):
    port, ref = pair
    x = _inputs()
    with torch.inference_mode():
        if entry == "decoder":
            got = port.dec(x["z"], x["f0"], g=x["g"], generator=_gen(noise))[:, :, 0]
            want = ref.dec(x["z"].transpose(1, 2), x["f0"], x["g"].transpose(1, 2),
                           _gen(noise))
        else:
            lengths = torch.tensor([T, T - 3])
            got = port.infer(x["phone"], lengths, x["pitch"], x["f0"], x["sid"],
                             generator=_gen(noise))[0][:, :, 0]
            want = ref.infer(x["phone"], lengths, x["pitch"], x["f0"], x["sid"], _gen(noise))
    assert got.shape == want.shape == (B, T * 320)
    rel = float((got - want).norm() / want.norm())
    assert rel < 1e-5 and float(want.std()) > 1e-3, rel
    if noise and entry == "decoder":            # the noise moves the output
        with torch.inference_mode():
            quiet = ref.dec(x["z"].transpose(1, 2), x["f0"], x["g"].transpose(1, 2), None)
        assert float((quiet - want).norm() / want.norm()) > 1e-3


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.refinegan; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('rvc_tpu', 'rvc_tpu_torch', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_decoder_spans_and_noise_counter(pair, monkeypatch):
    """Under RVC_TPU_TRACE=1 the decoder opens decoder/source once and
    decoder/stage once a stage, and draws the same noise as untraced: its
    output with the generator is the untraced one, number for number."""
    port, _ = pair
    x = _inputs()
    with torch.inference_mode():
        quiet = port.dec(x["z"], x["f0"], g=x["g"], generator=_gen(True))
    monkeypatch.setenv("RVC_TPU_TRACE", "1")
    monkeypatch.setattr(profiling, "_GLOBAL", profiling.SpanTimer())
    with torch.inference_mode():
        traced = port.dec(x["z"], x["f0"], g=x["g"], generator=_gen(True))
    counts = profiling.global_tracer().counts
    assert counts["decoder/source"] == 1 and counts["decoder/stage"] == 4
    assert torch.equal(traced, quiet)


def collectives(path: str) -> None:
    """A rank of the dp spans test: one all-reduce and one all-gather with
    tracing on; writes the span names it saw to path.rank<r>."""
    import torch.distributed as dist

    from rvc_tpu_torch.parallel.train import all_gather_coalesced, all_reduce_mean

    os.environ["RVC_TPU_TRACE"] = "1"
    r = dist.get_rank()
    mean = all_reduce_mean([torch.full((3,), float(r)), torch.ones(2, 2) * r])
    parts = all_gather_coalesced([torch.full((2,), float(r))])
    names = sorted(profiling.global_tracer().counts)
    torch.save(dict(names=names, mean=mean[0].tolist(), parts=[p[0].tolist() for p in parts]),
               f"{path}.rank{r}")


def test_dp_spans_on_two_gloo_ranks(tmp_path):
    from rvc_tpu_torch.parallel.train import spawn

    path = str(tmp_path / "job")
    spawn(collectives, 2, (path,), init_method=f"file://{tmp_path / 'store'}", device="cpu",
          threads=1)
    for r in range(2):
        out = torch.load(f"{path}.rank{r}")
        assert out["names"] == ["dp/all_gather", "dp/all_reduce"]
        assert out["mean"] == [0.5] * 3 and out["parts"] == [[0.0, 0.0], [1.0, 1.0]]
