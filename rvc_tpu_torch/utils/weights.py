"""Checkpoints into the port's modules (counterpart of
`rvc_tpu/utils/weights.py`).

Upstream torch checkpoints (`.pth`): the port's parameter names are the
upstream ones, so `synthesizer_from_pth` / `hubert_from_pth` /
`fcpe_from_pth` fuse the weight norm (both namings) and keep the keys the
port has; `crepe_from_pth` takes a torchcrepe state dict as it is.
`export_pth` writes the upstream inference format.

Native checkpoints (`.safetensors` with a `.json` config sidecar) hold
`rvc_tpu`'s flat '/'-joined parameter paths: `load_params` / `save_params`
read and write the file format (no `safetensors` package needed), and
`synthesizer_from_jax` / `hubert_from_jax` / `rmvpe_from_jax` /
`crepe_from_jax` / `fcpe_from_jax` / `discriminator_from_jax` map such a
tree (weight norm already fused) onto the port's state dicts, in torch layouts: conv weights
(K, Cin, Cout) -> (Cout, Cin, K), transposed convs (K, Cin, Cout) ->
(Cin, Cout, K), and the 2-D forms alike. `synthesizer_to_jax` and
`discriminator_to_jax` map the port's back, so the port writes native
checkpoints too (a trainer's G and D, enc_q included, resume in either
package). `discriminator_from_pth` takes an upstream D checkpoint.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {'a/b/c': array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _conv1d(w):  # (K, Cin // g, Cout) -> (Cout, Cin // g, K)
    return w.transpose(2, 1, 0)


def _convtr1d(w):  # (K, Cin, Cout) -> (Cin, Cout, K)
    return w.transpose(1, 2, 0)


def _conv2d(w):  # (KH, KW, Cin // g, Cout) -> (Cout, Cin // g, KH, KW)
    return w.transpose(3, 2, 0, 1)


def _convtr2d(w):  # (KH, KW, Cin, Cout) -> (Cin, Cout, KH, KW)
    return w.transpose(2, 3, 0, 1)


Rule = Tuple[str, str, Optional[Callable]]


def _convert(flat: Mapping[str, np.ndarray], rules: Sequence[Rule],
             what: str) -> Dict[str, torch.Tensor]:
    """Apply the first matching (regex, template, transform) rule to each
    path. Raises on an unmapped path."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in flat.items():
        for pat, tmpl, tf in rules:
            m = re.fullmatch(pat, path)
            if m is None:
                continue
            v = np.asarray(v, dtype=np.float32)
            out[m.expand(tmpl)] = torch.from_numpy(np.array(tf(v) if tf else v))
            break
        else:
            raise ValueError(f"{what}: no port parameter for {path!r}")
    return out


_INDEXED = ("attn_layers", "ffn_layers", "in_layers", "res_skip_layers", "ups",
            "noise_convs", "resblocks", "convs1", "convs2", "upsamples", "layers",
            "downsample_blocks", "upsample_conv_blocks")
# RefineGAN's ParallelResBlock: upstream's blocks.J Sequential holds AdaIN (0),
# the RefineResBlock (1) and AdaIN (2)
_PARALLEL = {"adain1": 0, "res": 1, "adain2": 2}


def _synth_key(path: str) -> str:
    parts = []
    for p in path.split("/"):
        m = re.fullmatch(r"flows_(\d+)", p)
        if m:  # upstream interleaves Flip modules: couplings at 0, 2, 4, 6
            parts.append(f"flows.{2 * int(m.group(1))}")
            continue
        m = re.fullmatch(r"mrfs_(\d+)_(\d+)", p)
        if m:
            parts.append(f"mrfs.{m.group(1)}.{m.group(2)}")
            continue
        m = re.fullmatch(r"(adain1|res|adain2)_(\d+)", p)
        if m:
            parts.append(f"blocks.{m.group(2)}.{_PARALLEL[m.group(1)]}")
            continue
        if p == "m_source_merge":
            parts.append("m_source.merge.0")
            continue
        m = re.fullmatch(r"(norm_layers_[12]|" + "|".join(_INDEXED) + r")_(\d+)", p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    key = ".".join(parts)
    if ".norm_layers_" in key:  # the VITS LayerNorm names its affine gamma / beta
        key = re.sub(r"\.weight$", ".gamma", re.sub(r"\.bias$", ".beta", key))
    return key


def synthesizer_from_jax(params: Mapping, enc_q: bool = False) -> Dict[str, torch.Tensor]:
    """`rvc_tpu` Synthesizer params -> `models.synthesizer.Synthesizer`
    state dict. The training-only posterior encoder (`enc_q/*`) is dropped
    unless enc_q is set (a model built for training)."""
    out = {}
    for path, v in flatten_tree(params).items():
        if path.startswith("enc_q/") and not enc_q:
            continue
        key = _synth_key(path)
        v = np.asarray(v, dtype=np.float32)
        if key.endswith(".weight") and v.ndim == 3:
            v = (_convtr1d(v) if re.search(r"(^|\.)(ups|upsamples)\.\d+\.weight$", key)
                 else _conv1d(v))
        out[key] = torch.from_numpy(np.array(v))
    return out


_PARALLEL_NAMES = {str(v): k for k, v in _PARALLEL.items()}


def synthesizer_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of `synthesizer_from_jax`: a port Synthesizer state dict
    -> `rvc_tpu`'s flat '/'-joined parameter paths in its layouts, which
    `save_params` writes as a native `.safetensors`."""
    out = {}
    for key, v in state.items():
        v = v.detach().float().cpu().numpy()
        key = re.sub(r"\.gamma$", ".weight", re.sub(r"\.beta$", ".bias", key))
        key = re.sub(r"flows\.(\d+)\.", lambda m: f"flows_{int(m.group(1)) // 2}.", key)
        key = re.sub(r"mrfs\.(\d+)\.(\d+)\.", r"mrfs_\1_\2.", key)
        key = re.sub(r"blocks\.(\d+)\.([012])\.",
                     lambda m: f"{_PARALLEL_NAMES[m.group(2)]}_{m.group(1)}.", key)
        key = key.replace("m_source.merge.0.", "m_source_merge.")
        key = re.sub(r"(norm_layers_[12]|" + "|".join(_INDEXED) + r")\.(\d+)\.", r"\1_\2.", key)
        if v.ndim == 3 and key.endswith(".weight"):   # back to (K, Cin, Cout)
            transposed = re.search(r"(^|\.)(ups|upsamples)_\d+\.weight$", key)
            v = v.transpose(2, 0, 1) if transposed else v.transpose(2, 1, 0)
        out[key.replace(".", "/")] = np.ascontiguousarray(v)
    return out


_HUBERT_RULES: Sequence[Rule] = (
    (r"feature_extractor/conv_layers_(\d+)/weight",
     r"feature_extractor.conv_layers.\1.conv.weight", _conv1d),
    (r"feature_extractor/gn_(weight|bias)",
     r"feature_extractor.conv_layers.0.layer_norm.\1", None),
    (r"fp_layer_norm/(weight|bias)", r"feature_projection.layer_norm.\1", None),
    (r"fp_projection/(weight|bias)", r"feature_projection.projection.\1", None),
    (r"pos_conv_embed/conv/weight", r"encoder.pos_conv_embed.conv.weight", _conv1d),
    (r"pos_conv_embed/conv/bias", r"encoder.pos_conv_embed.conv.bias", None),
    (r"encoder_layer_norm/(weight|bias)", r"encoder.layer_norm.\1", None),
    (r"layers_(\d+)/attention/(\w+)/(weight|bias)",
     r"encoder.layers.\1.attention.\2.\3", None),
    (r"layers_(\d+)/(layer_norm|final_layer_norm)/(weight|bias)",
     r"encoder.layers.\1.\2.\3", None),
    (r"layers_(\d+)/(intermediate_dense|output_dense)/(weight|bias)",
     r"encoder.layers.\1.feed_forward.\2.\3", None),
    (r"final_proj/(weight|bias)", r"final_proj.\1", None),
)


def hubert_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """`rvc_tpu` HubertModel params -> `models.hubert.HubertModel` state dict."""
    return _convert(flatten_tree(params), _HUBERT_RULES, "hubert")


_BLOCK = {"conv_0": "conv.0", "bn_0": "conv.1", "conv_1": "conv.3", "bn_1": "conv.4",
          "shortcut": "shortcut"}
_LEAF = r"(weight|bias|running_mean|running_var)"


def _rmvpe_rules(fc_index: int) -> Sequence[Rule]:
    rules = [
        (r"unet/encoder_bn/" + _LEAF, r"unet.encoder.bn.\1", None),
        (r"unet/decoder_layers_(\d+)/conv1/weight",
         r"unet.decoder.layers.\1.conv1.0.weight", _convtr2d),
        (r"unet/decoder_layers_(\d+)/bn1/" + _LEAF, r"unet.decoder.layers.\1.conv1.1.\2", None),
        (r"cnn/weight", "cnn.weight", _conv2d),
        (r"cnn/bias", "cnn.bias", None),
        (r"gru_fwd_(weight|bias)_(ih|hh)", r"fc.0.gru.\1_\2_l0", None),
        (r"gru_bwd_(weight|bias)_(ih|hh)", r"fc.0.gru.\1_\2_l0_reverse", None),
        (r"fc/(weight|bias)", rf"fc.{fc_index}.\1", None),
    ]
    for sub, name in _BLOCK.items():
        tf = _conv2d if sub in ("conv_0", "conv_1", "shortcut") else None
        for section, container in (("encoder", "conv"), ("intermediate", "conv"),
                                   ("decoder", "conv2")):
            head = rf"unet/{section}_layers_(\d+)/blocks_(\d+)/{sub}/"
            dst = rf"unet.{section}.layers.\1.{container}.\2.{name}."
            rules.append((head + r"weight", dst + "weight", tf))
            rules.append((head + r"(bias|running_mean|running_var)", dst + r"\3", None))
    return rules


def rmvpe_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """`rvc_tpu` RMVPE E2E (params, batch_stats) -> `models.rmvpe.E2E` state dict."""
    flat = {**flatten_tree(params), **flatten_tree(batch_stats)}
    fc_index = 1 if "gru_fwd_weight_ih" in flat else 0
    return _with_bn_counters(_convert(flat, _rmvpe_rules(fc_index), "rmvpe"))


def _with_bn_counters(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Add the `num_batches_tracked` buffer of every BatchNorm in `out`."""
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


_CREPE_RULES: Sequence[Rule] = (
    (r"conv(\d)/weight", r"conv\1.weight", _conv2d),
    (r"conv(\d)/bias", r"conv\1.bias", None),
    (r"conv(\d)_BN/(weight|bias|running_mean|running_var)", r"conv\1_BN.\2", None),
    (r"classifier/(weight|bias)", r"classifier.\1", None),
)


def crepe_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """`rvc_tpu` CREPEModel (params, batch_stats) -> `models.crepe.CREPEModel`
    state dict (torchcrepe's keys)."""
    flat = {**flatten_tree(params), **flatten_tree(batch_stats)}
    return _with_bn_counters(_convert(flat, _CREPE_RULES, "crepe"))


_LAYER = r"decoder_layers_(\d+)/"
_FCPE_RULES: Sequence[Rule] = (
    (r"stack_conv1/weight", "stack.0.weight", _conv1d),
    (r"stack_conv1/bias", "stack.0.bias", None),
    (r"stack_gn_(weight|bias)", r"stack.1.\1", None),
    (r"stack_conv2/weight", "stack.3.weight", _conv1d),
    (r"stack_conv2/bias", "stack.3.bias", None),
    (_LAYER + r"norm/(weight|bias)", r"decoder._layers.\1.norm.\2", None),
    (_LAYER + r"attn/to_(q|k|v|out)/(weight|bias)", r"decoder._layers.\1.attn.to_\2.\3", None),
    (_LAYER + r"attn/projection_matrix",
     r"decoder._layers.\1.attn.fast_attention.projection_matrix", None),
    (_LAYER + r"conformer/ln/(weight|bias)", r"decoder._layers.\1.conformer.net.0.\2", None),
    (_LAYER + r"conformer/conv_in/weight", r"decoder._layers.\1.conformer.net.2.weight",
     _conv1d),
    (_LAYER + r"conformer/conv_in/bias", r"decoder._layers.\1.conformer.net.2.bias", None),
    (_LAYER + r"conformer/depthwise/weight", r"decoder._layers.\1.conformer.net.4.conv.weight",
     _conv1d),
    (_LAYER + r"conformer/depthwise/bias", r"decoder._layers.\1.conformer.net.4.conv.bias",
     None),
    (_LAYER + r"conformer/conv_out/weight", r"decoder._layers.\1.conformer.net.6.weight",
     _conv1d),
    (_LAYER + r"conformer/conv_out/bias", r"decoder._layers.\1.conformer.net.6.bias", None),
    (r"(norm|dense_out)/(weight|bias)", r"\1.\2", None),
)


def fcpe_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """`rvc_tpu` FCPEModel params -> `models.fcpe.FCPEModel` state dict
    (the upstream `FCPE.py` keys)."""
    return _convert(flatten_tree(params), _FCPE_RULES, "fcpe")


# ---------------------------------------------------------------------------
# upstream torch checkpoints (.pth)
# ---------------------------------------------------------------------------


def fuse_weight_norm(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold weight-norm (g, v) pairs into plain weights, in float32.

    Both namings: ``X.weight_g`` / ``X.weight_v`` and
    ``X.parametrizations.weight.original0`` / ``original1``. w = g v / |v|,
    the norm over every axis where g has size 1 (dim = 0 convs give g
    (C, 1, 1); HF's pos_conv uses dim = 2, g (1, 1, K)). g and v are upcast
    before the fuse, so fp16 checkpoints fuse as the reference does.
    """
    out: Dict[str, np.ndarray] = {}
    done = set()
    for k in list(sd.keys()):
        if k in done:
            continue
        m = re.match(r"(.*)\.parametrizations\.weight\.original0$", k)
        if m is None:
            m = re.match(r"(.*)\.weight_g$", k)
            vkey = f"{m.group(1)}.weight_v" if m else None
        else:
            vkey = f"{m.group(1)}.parametrizations.weight.original1"
        if m and vkey in sd:
            g = np.asarray(sd[k], dtype=np.float32)
            v = np.asarray(sd[vkey], dtype=np.float32)
            axes = tuple(i for i, s in enumerate(g.shape) if s == 1) or tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
            out[f"{m.group(1)}.weight"] = g * v / np.maximum(norm, 1e-12)
            done.update({k, vkey})
        elif not re.search(r"\.(weight_g|weight_v|parametrizations\.)", k):
            out[k] = np.asarray(sd[k])
            done.add(k)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A .pth file (weights_only) -> {key: float32 array}, plus "__meta__":
    the checkpoint's other entries. Raw state dicts, training checkpoints
    (nested under "model") and inference exports (under "weight",
    `rvc/train/process/extract_model.py`) all load."""
    cpt = torch.load(path, map_location="cpu", weights_only=True)
    meta = {}
    for nest in ("model", "weight"):
        if isinstance(cpt, dict) and isinstance(cpt.get(nest), dict):
            meta = {k: v for k, v in cpt.items() if k != nest}
            cpt = cpt[nest]
            break
    out = {k: v.float().numpy() if hasattr(v, "numpy") else np.asarray(v)
           for k, v in cpt.items()}
    out["__meta__"] = meta
    return out


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def synthesizer_from_pth(sd: Mapping[str, np.ndarray], enc_q: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """Upstream Synthesizer state dict (from `load_torch_checkpoint`) -> the
    port's state dict: weight norm fused, the training-only enc_q dropped
    unless enc_q is set (a model built for training)."""
    fused = fuse_weight_norm({k: v for k, v in sd.items() if k != "__meta__"})
    return _tensors({k: v for k, v in fused.items() if enc_q or not k.startswith("enc_q.")})


# ---------------------------------------------------------------------------
# discriminators: the port's keys are upstream's (`discriminators.N.convs.M`,
# `discriminators.N.conv_post`); rvc_tpu names each one (`disc_s`,
# `disc_p_<period>`, `disc_r_<n_fft>`)
# ---------------------------------------------------------------------------

_PERIODS_BY_COUNT = {6: (2, 3, 5, 7, 11, 17), 8: (2, 3, 5, 7, 11, 17, 23, 37),
                     5: (2, 3, 5, 7, 11)}
_MRD_NFFT = (1024, 2048, 512)    # DiscriminatorR order (v3)


def _disc_names(first_weights: Mapping[int, np.ndarray]) -> Dict[int, str]:
    """{index: rvc_tpu name} from each discriminator's first conv weight
    (torch layout): 3-D is DiscriminatorS, (k, 1) taps DiscriminatorP, the
    rest DiscriminatorR, as `rvc_tpu.utils.weights.
    convert_discriminator_state_dict` tells them apart."""
    kinds = {i: "S" if w.ndim == 3 else "P" if w.shape[-1] == 1 else "R"
             for i, w in first_weights.items()}
    n_p = sum(k == "P" for k in kinds.values())
    periods = iter(_PERIODS_BY_COUNT.get(n_p, _PERIODS_BY_COUNT[8]))
    nffts = iter(_MRD_NFFT)
    return {i: "disc_s" if k == "S" else f"disc_p_{next(periods)}" if k == "P"
            else f"disc_r_{next(nffts)}" for i, k in sorted(kinds.items())}


def discriminator_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A port MultiPeriodDiscriminator state dict -> `rvc_tpu`'s flat
    '/'-joined parameter paths in its layouts."""
    firsts = {int(m.group(1)): v.detach().cpu().numpy() for k, v in state.items()
              if (m := re.fullmatch(r"discriminators\.(\d+)\.convs\.0\.weight", k))}
    names = _disc_names(firsts)
    out = {}
    for key, v in state.items():
        m = re.fullmatch(r"discriminators\.(\d+)\.(?:convs\.(\d+)|(conv_post))\.(weight|bias)",
                         key)
        if m is None:
            raise ValueError(f"discriminator: no rvc_tpu path for {key!r}")
        v = v.detach().float().cpu().numpy()
        if v.ndim == 3:
            v = v.transpose(2, 1, 0)
        elif v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        layer = f"convs_{m.group(2)}" if m.group(2) is not None else "conv_post"
        out[f"{names[int(m.group(1))]}/{layer}/{m.group(4)}"] = np.ascontiguousarray(v)
    return out


def discriminator_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """`rvc_tpu` MultiPeriodDiscriminator params -> the port's state dict:
    DiscriminatorS first, the periods in ascending order, then the
    resolutions in the v3 bank's order."""
    flat = flatten_tree(params)
    discs = sorted({p.split("/")[0] for p in flat})
    periods = sorted(int(d[len("disc_p_"):]) for d in discs if d.startswith("disc_p_"))
    order = (["disc_s"] + [f"disc_p_{p}" for p in periods]
             + [f"disc_r_{n}" for n in _MRD_NFFT if f"disc_r_{n}" in discs])
    if sorted(order) != discs:
        raise ValueError(f"discriminator: unknown sub-discriminators in {discs}")
    index = {name: i for i, name in enumerate(order)}
    out = {}
    for path, v in flat.items():
        disc, layer, leaf = path.split("/")
        layer = layer.replace("convs_", "convs.")
        v = np.asarray(v, dtype=np.float32)
        if v.ndim == 3:
            v = _conv1d(v)
        elif v.ndim == 4:
            v = _conv2d(v)
        out[f"discriminators.{index[disc]}.{layer}.{leaf}"] = torch.from_numpy(np.array(v))
    return out


def discriminator_from_pth(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """An upstream MultiPeriodDiscriminator state dict of layout v1, v2 or v3
    (`rvc/lib/algorithm/discriminators.py`; from `load_torch_checkpoint`)
    -> the port's state dict: the weight norm fused in float32 (both
    namings; spectral norm is not supported). Its keys are the port's."""
    fused = fuse_weight_norm({k: v for k, v in sd.items() if k != "__meta__"})
    bad = [k for k in fused if not re.fullmatch(
        r"discriminators\.\d+\.(?:convs\.\d+|conv_post)\.(?:weight|bias)", k)]
    if bad:
        raise ValueError(f"discriminator: unexpected keys {bad[:4]}")
    return _tensors(fused)


# the HF HuBERT / ContentVec keys the port has (the reference's
# `_HUBERT_RULES`); the rest (masked_spec_embed, label_embs_concat, ...) go
_HUBERT_KEYS = re.compile(
    r"(?:hubert\.)?(feature_extractor\.conv_layers\.\d+\.conv\.weight"
    r"|feature_extractor\.conv_layers\.0\.layer_norm\.(?:weight|bias)"
    r"|feature_projection\.(?:layer_norm|projection)\.(?:weight|bias)"
    r"|encoder\.pos_conv_embed\.conv\.(?:weight|bias)"
    r"|encoder\.layer_norm\.(?:weight|bias)"
    r"|encoder\.layers\.\d+\.attention\.(?:[qkv]|out)_proj\.(?:weight|bias)"
    r"|encoder\.layers\.\d+\.(?:layer_norm|final_layer_norm)\.(?:weight|bias)"
    r"|encoder\.layers\.\d+\.feed_forward\.(?:intermediate|output)_dense\.(?:weight|bias))"
    r"|(final_proj\.(?:weight|bias))")


def hubert_from_pth(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """HF HubertModel or ContentVec state dict -> `models.hubert.HubertModel`
    state dict: weight norm fused (pos_conv), the "hubert." prefix dropped."""
    out = {}
    for k, v in fuse_weight_norm({k: v for k, v in sd.items() if k != "__meta__"}).items():
        m = _HUBERT_KEYS.fullmatch(k)
        if m:
            out[m.group(1) or m.group(2)] = v
    return _tensors(out)


def crepe_from_pth(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A torchcrepe state dict (its keys are `models.crepe.CREPEModel`'s)
    -> the port's state dict, floating tensors cast to float32."""
    out = {}
    for k, v in sd.items():
        if k != "__meta__":
            v = torch.as_tensor(np.asarray(v))
            out[k] = v.float() if v.is_floating_point() else v
    return out


# the keys of upstream `FCPE.py`'s model that the port has (the reference's
# `_FCPE_RULES`); its cent tables and masks are buffers the port computes
_FCPE_KEYS = re.compile(
    r"stack\.[013]\.(?:weight|bias)"
    r"|decoder\._layers\.\d+\.(?:norm\.(?:weight|bias)|attn\.to_(?:q|k|v|out)\.(?:weight|bias)"
    r"|attn\.fast_attention\.projection_matrix"
    r"|conformer\.net\.(?:0|2|4\.conv|6)\.(?:weight|bias))"
    r"|(?:norm|dense_out)\.(?:weight|bias)")


def fcpe_from_pth(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The "model" entry of an upstream `fcpe.pt` -> `models.fcpe.FCPEModel`
    state dict: dense_out's weight norm fused in float32, the keys the port
    has kept."""
    fused = fuse_weight_norm({k: np.asarray(v) for k, v in sd.items() if k != "__meta__"})
    return _tensors({k: v for k, v in fused.items() if _FCPE_KEYS.fullmatch(k)})


# the layers upstream keeps under weight norm (`rvc/lib/algorithm`): the
# flow's WaveNets; the NSF decoder's ups and resblocks; the MRF decoder's
# upsamples and MRF convs; RefineGAN's pre_conv, mel_conv, downsample blocks
# and ParallelResBlock convs (not its conv_post, cond or AdaIN weights)
_WEIGHT_NORM = re.compile(
    r"(flow\.flows\.\d+\.enc\.(?:in_layers\.\d+|res_skip_layers\.\d+|cond_layer)"
    r"|dec\.ups\.\d+|dec\.resblocks\.\d+\.convs[12]\.\d+"
    r"|dec\.upsamples\.\d+|dec\.mrfs\.\d+\.\d+\.layers\.\d+\.conv[12]"
    r"|dec\.(?:pre_conv|mel_conv)|dec\.downsample_blocks\.\d+"
    r"|dec\.upsample_conv_blocks\.\d+\.(?:input_conv|blocks\.\d+\.1\.convs[12]\.\d+)"
    r")\.weight")


def export_pth(state: Mapping[str, torch.Tensor], cfg, path: str, *,
               pitch_guidance: bool = True, name: str = "model") -> str:
    """A port Synthesizer state dict -> the upstream inference .pth
    (`rvc/train/process/extract_model.py`): fp16 "weight" under the
    upstream keys with the weight norm split again as
    `parametrizations.weight.original0/1`, the 18-element "config" list and
    "f0"."""
    sd = {}
    for k, v in state.items():
        w = v.detach().float().cpu()
        m = _WEIGHT_NORM.fullmatch(k)
        if m:
            g = torch.linalg.vector_norm(w, dim=tuple(range(1, w.ndim)), keepdim=True)
            sd[f"{m.group(1)}.parametrizations.weight.original0"] = g.half()
            sd[f"{m.group(1)}.parametrizations.weight.original1"] = w.half()
        else:
            sd[k] = w.half()
    m, d = cfg.model, cfg.data
    config = [d.filter_length // 2 + 1, 32, m.inter_channels, m.hidden_channels,
              m.filter_channels, m.n_heads, m.n_layers, m.kernel_size, m.p_dropout,
              str(m.resblock), list(m.resblock_kernel_sizes),
              [list(x) for x in m.resblock_dilation_sizes], list(m.upsample_rates),
              m.upsample_initial_channel, list(m.upsample_kernel_sizes), m.spk_embed_dim,
              m.gin_channels, d.sample_rate]
    torch.save({"weight": sd, "config": config, "sr": d.sample_rate,
                "f0": int(pitch_guidance), "version": "v2", "model_name": name,
                "vocoder": m.vocoder}, path)
    return path


# ---------------------------------------------------------------------------
# native checkpoints: the safetensors file format
# (8-byte little-endian header length, a JSON header, raw little-endian data)
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
              "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}
_ST_CODES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def load_params(path: str) -> Dict[str, np.ndarray]:
    """A .safetensors file -> {flat '/'-joined path: array} (BF16 upcast to
    float32). Raises ValueError on a file that does not parse."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file ({len(data)} bytes)")
    n = struct.unpack("<Q", data[:8])[0]
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes past the end of the file")
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    out = {}
    for key, info in header.items():
        begin, end = info["data_offsets"]
        raw = data[8 + n + begin: 8 + n + end]
        dtype, shape = info["dtype"], tuple(info["shape"])
        if dtype == "BF16":
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32)
        elif dtype in _ST_DTYPES:
            arr = np.frombuffer(raw, _ST_DTYPES[dtype])
        else:
            raise ValueError(f"{path}: {key} has unsupported dtype {dtype}")
        if arr.size != int(np.prod(shape)) or len(raw) != end - begin:
            raise ValueError(f"{path}: {key} holds {len(raw)} bytes for shape {shape}")
        out[key] = arr.reshape(shape).astype(arr.dtype.newbyteorder("="))
    return out


def save_params(params: Mapping, path: str, config: Optional[dict] = None) -> None:
    """Parameters (nested or flat dicts of arrays) -> a .safetensors file
    under their '/'-joined paths, and `config` as the .json sidecar."""
    header, blobs, offset = {}, [], 0
    for key, v in sorted(flatten_tree(params).items()):
        v = np.ascontiguousarray(v, dtype=v.dtype.newbyteorder("<"))
        raw = v.tobytes()
        header[key] = {"dtype": _ST_CODES[v.dtype], "shape": list(v.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for raw in blobs:
            f.write(raw)
    if config is not None:
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(config, f, indent=2)
