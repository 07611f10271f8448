"""Carry the JAX package's parameters across to the port.

Each function takes a parameter tree of `rvc_tpu` (nested dicts of numpy
arrays, weight norm already fused) and returns the state dict of the
port's module, in torch layouts and under the upstream checkpoint names.
It is the inverse of the reference's `convert_*_state_dict`
(`rvc_tpu/utils/weights.py`): conv weights (K, Cin, Cout) -> (Cout, Cin, K),
transposed convs (K, Cin, Cout) -> (Cin, Cout, K), and the 2-D forms alike.
"""

from __future__ import annotations

import re
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
            "noise_convs", "resblocks", "convs1", "convs2")


def _synth_key(path: str) -> str:
    parts = []
    for p in path.split("/"):
        m = re.fullmatch(r"flows_(\d+)", p)
        if m:  # upstream interleaves Flip modules: couplings at 0, 2, 4, 6
            parts.append(f"flows.{2 * int(m.group(1))}")
            continue
        m = re.fullmatch(r"(norm_layers_[12]|" + "|".join(_INDEXED) + r")_(\d+)", p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    key = ".".join(parts)
    if ".norm_layers_" in key:  # the VITS LayerNorm names its affine gamma / beta
        key = re.sub(r"\.weight$", ".gamma", re.sub(r"\.bias$", ".beta", key))
    return key


def synthesizer_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """`rvc_tpu` Synthesizer params -> `models.synthesizer.Synthesizer`
    state dict. The training-only posterior encoder (`enc_q/*`) is dropped."""
    out = {}
    for path, v in flatten_tree(params).items():
        if path.startswith("enc_q/"):
            continue
        key = _synth_key(path)
        v = np.asarray(v, dtype=np.float32)
        if key.endswith(".weight") and v.ndim == 3:
            v = _convtr1d(v) if re.search(r"(^|\.)ups\.\d+\.weight$", key) else _conv1d(v)
        out[key] = torch.from_numpy(np.array(v))
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
    out = _convert(flat, _rmvpe_rules(fc_index), "rmvpe")
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out
