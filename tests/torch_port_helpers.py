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
def synthesizers(seed: int = 0, use_f0: bool = True, ups_gain: float = 1.0,
                 vocoder: str = "HiFi-GAN"):
    """(port Synthesizer, JAX Synthesizer, its JAX params); use_f0=False
    gives the f0-less model (plain HiFi-GAN decoder); an f0 model takes
    `vocoder`'s decoder (c = 64, rates (10, 8, 2, 2)). The decoder's
    upsampling weights are N(0, 0.01) at init, which leaves the NSF
    decoder's output to its sine source; ups_gain scales those of the
    NSF and plain HiFi-GAN so that the waveform follows the content
    features too."""
    from rvc_tpu.models.synthesizer import build_synthesizer as jax_build
    from rvc_tpu_torch.models.synthesizer import build_synthesizer

    args = dict(SMALL_SYNTH_ARGS, model_use_f0=use_f0, model_vocoder=vocoder)
    torch.manual_seed(seed)
    port = build_synthesizer(port_get_config(32000, **args)).eval()
    if ups_gain != 1.0:
        with torch.no_grad():
            for up in port.dec.ups:
                up.weight.mul_(ups_gain)
    params = W.convert_synthesizer_state_dict(numpy_state(port))
    return port, jax_build(get_config(32000, **args)), params


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


# the JAX train-step tests' tiny model (tests/unit/test_train_step.py)
TRAIN_ARGS = dict(model_spk_embed_dim=2, model_n_layers=1, model_upsample_initial_channel=64,
                  train_segment_size=320 * 12, train_batch_size=2)


def train_configs(**extra):
    """(JAX config, port config) of the tiny training model."""
    args = dict(TRAIN_ARGS, **extra)
    return get_config(32000, **args), port_get_config(32000, **args)


def train_pair(seed: int = 0, **extra):
    """(port G built for training, port D, JAX G params, JAX D params):
    the port's seeded init carried to JAX through the reference's own
    upstream converters (`convert_synthesizer_state_dict` keeps enc_q,
    `convert_discriminator_state_dict`)."""
    from rvc_tpu_torch.models.discriminators import build_discriminator
    from rvc_tpu_torch.models.synthesizer import build_synthesizer

    _, cfg = train_configs(**extra)
    torch.manual_seed(seed)
    net_g = build_synthesizer(cfg, training=True)
    net_d = build_discriminator(cfg)
    return (net_g, net_d, W.convert_synthesizer_state_dict(numpy_state(net_g)),
            W.convert_discriminator_state_dict(numpy_state(net_d)))


def train_batch(cfg, seed: int = 0, B: int = 2, T: int = 24, lengths=(24, 19)):
    """A numpy batch in the JAX `Batch` field order (phone, phone_lengths,
    pitch, pitchf, spec, spec_lengths, wave, sid)."""
    rng = np.random.default_rng(seed)
    hop = cfg.data.hop_length
    lengths = np.asarray(lengths, np.int32)
    f0 = rng.uniform(100.0, 300.0, (B, T)).astype(np.float32)
    f0[:, T // 3: T // 2] = 0.0
    return (rng.standard_normal((B, T, 768)).astype(np.float32), lengths,
            rng.integers(1, 255, (B, T)).astype(np.int32), f0,
            rng.standard_normal((B, T, cfg.data.spec_channels)).astype(np.float32), lengths,
            (0.1 * rng.standard_normal((B, T * hop))).astype(np.float32),
            np.arange(B, dtype=np.int32) % cfg.model.spk_embed_dim)


def jax_draws(key, cfg, batch, nsf: bool = True) -> dict:
    """The draws the JAX step makes from `key` (`train_step.py:216`,
    `synthesizer.py:121`): the posterior's eps, the segment starts and the
    NSF source noise, for the port's training forward."""
    import jax
    import jax.numpy as jnp

    rng_g, _ = jax.random.split(key)
    r_post, r_slice, r_dec = jax.random.split(rng_g, 3)
    B, T = batch[0].shape[:2]
    seg = cfg.segment_frames
    eps = np.asarray(jax.random.normal(r_post, (B, T, cfg.model.inter_channels), jnp.float32))
    max_starts = np.maximum(batch[5] - seg, 0)
    u = np.asarray(jax.random.uniform(r_slice, (B,)))
    ids = np.minimum((u * (max_starts + 1).astype(np.float32)).astype(np.int32), max_starts)
    out = {"eps": t(eps), "ids_slice": t(ids.astype(np.int64))}
    if nsf:
        upp = int(np.prod(cfg.model.upsample_rates))
        out["source_noise"] = t(np.asarray(jax.random.normal(r_dec, (B, seg * upp, 1))))
    return out


def partial_chain_job(path: str) -> None:
    """One rank of a model group spanning the process group: the plain
    partial-sum chain (`resblock_chain_partial_reference`) and K1 stage
    (`resblock_group_partial_reference`) from this rank's shards of the
    job's whole weights, with the gradients of x, the shards and the whole
    biases against the job's upstream gradient. Writes `path`.rank{r}."""
    import torch.distributed as dist

    from rvc_tpu_torch.ops.kernels.resblock import (resblock_chain_partial_reference,
                                                     resblock_group_partial_reference)
    from rvc_tpu_torch.parallel.mesh import Axis
    from rvc_tpu_torch.parallel.tp import local_slice

    job = torch.load(path, weights_only=False)
    model = Axis(dist.get_world_size(), dist.get_rank())
    x, grad = job["x"], job["grad"]
    C = x.shape[-1]
    cm = C // model.size
    cols = slice(model.index * cm, (model.index + 1) * cm)
    out = {}
    for name, chains in (("chain", job["chain"]), ("group", job["group"])):
        leaves = [x.clone().requires_grad_(True)]
        weights = []
        for (w1, b1, w2, b2), sharded in chains:
            if sharded:
                w1, w2 = w1[..., cols], w2[:, :, cols, :]
            w = [t.clone().requires_grad_(True) for t in (w1, b1, w2, b2)]
            leaves += w
            weights += [w[0], local_slice(w[1], 1, model) if sharded else w[1], w[2], w[3]]
        if name == "chain":
            i = job["chain_index"]
            y = resblock_chain_partial_reference(leaves[0], *weights, job["kernel_sizes"][i],
                                                 job["dilations"][i], 0.1, model)
        else:
            y = resblock_group_partial_reference(leaves[0], tuple(weights), job["kernel_sizes"],
                                                 job["dilations"], 0.1, model)
        out[name] = (y.detach(), [g.detach() for g in torch.autograd.grad(
            y, leaves, grad)])
    torch.save(out, f"{path}.rank{model.index}")


def span_tree(spans) -> dict:
    """{path from the root, "a > b": count} of `profiling.Span` records."""
    by_id = {s.id: s for s in spans}
    paths: dict = {}
    for s in spans:
        path, p = [s.name], s.parent
        while p is not None:
            path.insert(0, by_id[p].name)
            p = by_id[p].parent
        key = " > ".join(path)
        paths[key] = paths.get(key, 0) + 1
    return paths


def assert_nested(spans) -> None:
    """Every span's child lies inside it, on its thread, with its request id."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
            assert s.thread == p.thread and s.request == p.request, (s, p)
