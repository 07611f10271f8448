"""Checkpoint ingestion of the port (`rvc_tpu_torch.utils.weights`,
`api.config_from_pth_list`, `api._load_model`) against the JAX package's
loaders, on files the JAX package wrote."""

import dataclasses

import numpy as np
import pytest
import torch

from rvc_tpu import api as jax_api
from rvc_tpu.configs import config_to_dict as jax_config_to_dict
from rvc_tpu.configs import get_config
from rvc_tpu.utils import weights as W
from rvc_tpu_torch import api as port_api
from rvc_tpu_torch.configs import config_to_dict
from rvc_tpu_torch.configs import get_config as port_get_config
from rvc_tpu_torch.models.hubert import HubertConfig, HubertModel
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.utils import weights as PW
from torch_port_helpers import SMALL_HUBERT, SMALL_SYNTH_ARGS, huberts, numpy_state, synthesizers


def _assert_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


def _jax_pth(tmp_path, use_f0):
    """(path of the JAX package's export of a small model, the port model)."""
    port, _, params = synthesizers(use_f0=use_f0)
    path = str(tmp_path / "model.pth")
    W.export_pth(params, get_config(32000, **SMALL_SYNTH_ARGS, model_use_f0=use_f0), path,
                 pitch_guidance=use_f0)
    return path, port


@pytest.mark.parametrize("use_f0", [True, False], ids=["f0", "f0less"])
def test_pth_loads_as_the_jax_loader_does(tmp_path, use_f0):
    """An fp16 upstream .pth: the port's tensors equal, bit for bit, what
    the JAX loader then `synthesizer_from_jax` give (both upcast, then fuse
    the weight norm in float32), and load strict into the model its config
    list describes."""
    path, port = _jax_pth(tmp_path, use_f0)
    ref_sd = W.load_torch_checkpoint(path)
    ref_sd.pop("__meta__")
    ref = PW.synthesizer_from_jax(W.convert_synthesizer_state_dict(ref_sd))
    sd = PW.load_torch_checkpoint(path)
    meta = sd.pop("__meta__")
    got = PW.synthesizer_from_pth(sd)
    _assert_equal(got, ref)
    assert any(k.endswith("parametrizations.weight.original0")
               for k in torch.load(path, weights_only=True)["weight"])
    cfg = port_api.config_from_pth_list(meta["config"], use_f0=bool(meta["f0"]))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, text_enc_hidden_dim=SMALL_SYNTH_ARGS["model_text_enc_hidden_dim"]))
    model = build_synthesizer(cfg)
    model.load_state_dict(got, strict=True)
    assert model.use_f0 == use_f0
    # within fp16 of the model that was exported
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=2e-3,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("lst_of", ["small-32000", "default-48k", "f0less-40000"])
def test_config_from_pth_list_matches_jax(lst_of):
    """The 18-element config list, "48k"-style rates and use_f0 from "f0"."""
    cfg = {"small-32000": get_config(32000, **SMALL_SYNTH_ARGS),
           "default-48k": get_config(48000),
           "f0less-40000": get_config(40000)}[lst_of]
    m, d = cfg.model, cfg.data
    lst = [d.filter_length // 2 + 1, 32, m.inter_channels, m.hidden_channels,
           m.filter_channels, m.n_heads, m.n_layers, m.kernel_size, m.p_dropout, "1",
           list(m.resblock_kernel_sizes), [list(x) for x in m.resblock_dilation_sizes],
           list(m.upsample_rates), m.upsample_initial_channel, list(m.upsample_kernel_sizes),
           m.spk_embed_dim, m.gin_channels, "48k" if lst_of == "default-48k" else d.sample_rate]
    use_f0 = lst_of != "f0less-40000"
    got = config_to_dict(port_api.config_from_pth_list(lst, use_f0=use_f0))
    assert got == jax_config_to_dict(jax_api.config_from_pth_list(lst, use_f0=use_f0))
    assert got["model"]["use_f0"] == use_f0


def test_port_export_pth_writes_what_jax_writes(tmp_path):
    """The port's writer (used on the card, which has no JAX): the same keys,
    config list and f0 as the JAX package's export, the same fp16 values up
    to one fp16 step of the weight-norm g."""
    jax_path, port = _jax_pth(tmp_path, True)
    port_path = str(tmp_path / "port.pth")
    PW.export_pth(port.state_dict(), port_get_config(32000, **SMALL_SYNTH_ARGS), port_path)
    ref, got = torch.load(jax_path, weights_only=True), torch.load(port_path, weights_only=True)
    assert (got["config"], got["f0"], got["sr"]) == (ref["config"], ref["f0"], ref["sr"])
    assert sorted(got["weight"]) == sorted(ref["weight"])
    for k, v in ref["weight"].items():
        assert got["weight"][k].dtype == torch.float16, k
        np.testing.assert_allclose(got["weight"][k].float().numpy(), v.float().numpy(),
                                   rtol=1e-3, atol=1e-7, err_msg=k)


def test_safetensors_written_by_jax_read_by_the_port(tmp_path):
    """`save_params` of the JAX package (via the safetensors package): the
    port's reader gives the same flat paths, dtypes and values, and
    `_load_model` takes the .json sidecar."""
    from safetensors.numpy import load_file

    _, _, params = synthesizers()
    extra = {"ints": np.arange(6, dtype=np.int32).reshape(2, 3),
             "half": np.linspace(-1, 1, 5).astype(np.float16), "flag": np.array([True, False])}
    path = str(tmp_path / "model.safetensors")
    cfg = get_config(32000, **SMALL_SYNTH_ARGS)
    W.save_params({**params, "extra": extra}, path, config=jax_config_to_dict(cfg))
    got, ref = PW.load_params(path), load_file(path)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    W.save_params(params, path, config=jax_config_to_dict(cfg))
    port_cfg, state = port_api._load_model(path, None)
    assert config_to_dict(port_cfg) == config_to_dict(port_get_config(32000, **SMALL_SYNTH_ARGS))
    _assert_equal(state, PW.synthesizer_from_jax(params))


def test_port_safetensors_read_by_the_library(tmp_path):
    """The port's writer: `safetensors.numpy.load_file` reads it back
    exactly; the port reads BF16 files (upcast to float32)."""
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    flat = {"a/b/weight": np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32),
            "a/c": np.arange(7, dtype=np.int64), "h": np.ones((2, 2), np.float16),
            "u": np.arange(9, dtype=np.uint8)}
    path = str(tmp_path / "port.safetensors")
    PW.save_params(flat, path)
    back = load_file(path)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    bf = torch.randn(4, 6).bfloat16()
    save_file({"w": bf}, str(tmp_path / "bf.safetensors"))
    np.testing.assert_array_equal(PW.load_params(str(tmp_path / "bf.safetensors"))["w"],
                                  bf.float().numpy())


@pytest.mark.parametrize("naming", ["weight_g", "parametrizations"])
def test_hubert_pth_matches_jax(naming):
    """A HF HuBERT state dict: the "hubert." prefix, a weight-norm pos_conv
    with dim = 2 (g of shape (1, 1, K)) and keys the port has no use for.
    The port equals `convert_hubert_state_dict` -> `hubert_from_jax` and
    loads strict."""
    port, _, _ = huberts()
    sd = {f"hubert.{k}": v for k, v in numpy_state(port).items()}
    w = sd.pop("hubert.encoder.pos_conv_embed.conv.weight")
    g = np.sqrt((w * w).sum(axis=(0, 1), keepdims=True))
    names = (("weight_g", "weight_v") if naming == "weight_g"
             else ("parametrizations.weight.original0", "parametrizations.weight.original1"))
    sd[f"hubert.encoder.pos_conv_embed.conv.{names[0]}"] = g
    sd[f"hubert.encoder.pos_conv_embed.conv.{names[1]}"] = w * 1.7
    sd["hubert.masked_spec_embed"] = np.zeros(32, np.float32)
    sd["label_embs_concat"] = np.zeros((4, 32), np.float32)
    ref = PW.hubert_from_jax(W.convert_hubert_state_dict(dict(sd)))
    got = PW.hubert_from_pth(sd)
    _assert_equal(got, ref)
    HubertModel(HubertConfig(**SMALL_HUBERT)).load_state_dict(got, strict=True)
    np.testing.assert_allclose(got["encoder.pos_conv_embed.conv.weight"].numpy(), w,
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ext", [".pth", ".safetensors"])
def test_hubert_file_loads_as_jax(tmp_path, ext):
    """`RVC`'s HuBERT loader on a file with ContentVec's projection head:
    the tensors the JAX loader gives (`convert_hubert_state_dict`, or the
    native file), without the head, which the pipeline never reads."""
    port, _, _ = huberts()
    sd = {f"hubert.{k}": v for k, v in numpy_state(port).items()}
    rng = np.random.default_rng(14)
    sd["final_proj.weight"] = rng.standard_normal((16, 32)).astype(np.float32)
    sd["final_proj.bias"] = rng.standard_normal(16).astype(np.float32)
    params = W.convert_hubert_state_dict(dict(sd))
    path = str(tmp_path / f"hubert{ext}")
    if ext == ".pth":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    else:
        W.save_params(params, path)
    ref = {k: v for k, v in PW.hubert_from_jax(params).items() if not k.startswith("final_proj.")}
    got = port_api._load_hubert(path)
    _assert_equal(got, ref)
    HubertModel(HubertConfig(**SMALL_HUBERT)).load_state_dict(got, strict=True)


@pytest.mark.parametrize("case", ["contentvec-absent", "contentvec-present", "named-absent",
                                  "custom-missing", "custom-unset", "unknown"])
def test_resolve_embedder_as_jax(tmp_path, monkeypatch, case):
    """The same path, None or error as `rvc_tpu.utils.embedders`: an absent
    contentvec is None (a seeded random HuBERT), an absent named or custom
    embedder raises."""
    from rvc_tpu.utils import embedders as jax_embedders
    from rvc_tpu_torch.utils import embedders

    monkeypatch.setenv("RVC_TPU_MODELS_DIR", str(tmp_path))
    if case == "contentvec-present":
        (tmp_path / "embedders" / "contentvec").mkdir(parents=True)
        (tmp_path / "embedders" / "contentvec" / "model.pt").write_bytes(b"")
    args = {"contentvec-absent": ("contentvec", None), "contentvec-present": ("contentvec", None),
            "named-absent": ("korean-hubert-base", None),
            "custom-missing": ("custom", str(tmp_path / "missing.pt")),
            "custom-unset": ("custom", None), "unknown": ("wavlm", None)}[case]
    try:
        ref = jax_embedders.resolve_embedder(*args)
    except (ValueError, FileNotFoundError) as e:
        with pytest.raises(type(e)):
            embedders.resolve_embedder(*args)
    else:
        assert embedders.resolve_embedder(*args) == ref
        assert (ref is None) == (case == "contentvec-absent")


@pytest.mark.parametrize("name,error", [("missing.pth", FileNotFoundError),
                                        ("missing.safetensors", FileNotFoundError),
                                        ("model.ckpt", ValueError)])
def test_bad_model_path_raises_as_jax(tmp_path, name, error):
    (tmp_path / "model.ckpt").write_bytes(b"\0" * 16)
    path = str(tmp_path / name)
    with pytest.raises(error):
        jax_api.RVC(model_path=path)
    with pytest.raises(error):
        port_api.RVC(model_path=path, device="cpu")


@pytest.mark.parametrize("kw", ["index_path", "hubert_path"])
def test_missing_index_or_hubert_raises(tmp_path, kw):
    """The JAX package skips a missing index or HuBERT file and converts
    without retrieval or with random HuBERT weights; the port refuses."""
    with pytest.raises(FileNotFoundError, match="not found"):
        port_api.RVC(device="cpu", **{kw: str(tmp_path / "missing")})
