"""Shared small models for the `test_torch_*` parity tests.

Each pair is the port's module, initialised from a seed, and the JAX
reference module with the same parameters: the port's state dict goes
through the reference's own upstream-checkpoint converter
(`rvc_tpu.utils.weights.convert_*_state_dict`), which is much cheaper than
a JAX init. The tests feed both sides the same numpy inputs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from rvc_tpu.configs import get_config
from rvc_tpu.utils import weights as W
from rvc_tpu_torch.configs import get_config as port_get_config

# a narrow synthesizer: 1 text layer, 64-channel decoder (32, 16, 8, 4)
SMALL_SYNTH_ARGS = dict(
    model_spk_embed_dim=2, model_n_layers=1, model_hidden_channels=32,
    model_inter_channels=16, model_filter_channels=64, model_gin_channels=16,
    model_text_enc_hidden_dim=32, model_upsample_initial_channel=64,
    data_filter_length=64, train_segment_size=3200)
SMALL_SYNTH = get_config(32000, **SMALL_SYNTH_ARGS)
SMALL_HUBERT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=64, conv_dim=32, classifier_proj_size=32)
SMALL_RMVPE = dict(n_blocks=1, n_gru=1, en_de_layers=2, inter_layers=1,
                   en_out_channels=4, gru_hidden=16)


def stats(got, ref):
    """(rmse, correlation) of two arrays."""
    got = np.asarray(got, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    return float(np.sqrt(np.mean((got - ref) ** 2))), float(np.corrcoef(got, ref)[0, 1])


def assert_parity(got, ref, what: str):
    """ROADMAP's per-module bar: RMSE < 0.01 and correlation > 0.99."""
    rmse, corr = stats(got, ref)
    assert rmse < 0.01 and corr > 0.99, f"{what}: rmse {rmse:.3g}, corr {corr:.6f}"


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def numpy_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


@lru_cache(maxsize=None)
def synthesizers(seed: int = 0):
    """(port Synthesizer, JAX Synthesizer, its JAX params)."""
    from rvc_tpu.models.synthesizer import build_synthesizer as jax_build
    from rvc_tpu_torch.models.synthesizer import build_synthesizer

    torch.manual_seed(seed)
    port = build_synthesizer(port_get_config(32000, **SMALL_SYNTH_ARGS)).eval()
    params = W.convert_synthesizer_state_dict(numpy_state(port))
    return port, jax_build(SMALL_SYNTH), params


@lru_cache(maxsize=None)
def huberts(seed: int = 1):
    """(port HubertModel, JAX HubertModel, its JAX params)."""
    from rvc_tpu.models.hubert import HubertConfig, HubertModel as JaxHubert
    from rvc_tpu_torch.models import hubert

    torch.manual_seed(seed)
    port = hubert.HubertModel(hubert.HubertConfig(**SMALL_HUBERT)).eval()
    params = W.convert_hubert_state_dict(numpy_state(port))
    return port, JaxHubert(HubertConfig(**SMALL_HUBERT)), params


@lru_cache(maxsize=None)
def rmvpes(seed: int = 2):
    """(port E2E, JAX E2E, JAX variables) with non-trivial BatchNorm stats."""
    from rvc_tpu.models.rmvpe import E2E as JaxE2E
    from rvc_tpu_torch.models.rmvpe import E2E

    torch.manual_seed(seed)
    port = E2E(**SMALL_RMVPE).eval()
    gen = torch.Generator().manual_seed(seed)
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    params, batch_stats = W.convert_rmvpe_state_dict(numpy_state(port))
    return port, JaxE2E(**SMALL_RMVPE), {"params": params, "batch_stats": batch_stats}
