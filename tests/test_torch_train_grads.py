"""The port's generator and discriminator gradients of one adversarial
step against the JAX package's, at the JAX tests' tiny model: the same
parameters, batch and draws. The JAX side is `make_train_step`'s G loss
(`rvc_tpu/train/train_step.py:g_loss_fn`, `d_loss_fn`) put together from
the reference's own modules and losses, since the jitted step does not
return its gradients. Bar: per-module gradient correlation > 0.9999 after
sanitizing on both sides (float32; sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.models.synthesizer import build_synthesizer as jax_build
from rvc_tpu.ops.commons import slice_segments
from rvc_tpu.ops.stft import mel_spectrogram
from rvc_tpu.train import losses as JL
from rvc_tpu.train import train_step as JT
from rvc_tpu.utils import weights as W
from rvc_tpu_torch.ops.kernels.adamw import sanitize_grads
from rvc_tpu_torch.train.train_step import Batch, TrainStep, make_optimizers
from torch_port_helpers import jax_draws, t, train_batch, train_configs, train_pair

KEY = 7


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_grads(jcfg, gp, dp, batch):
    """(total, G grads, D grads) of the reference's losses, sanitized."""
    net_g, net_d = jax_build(jcfg), JT.build_discriminator(jcfg)
    d, tr = jcfg.data, jcfg.train
    hop, seg = d.hop_length, jcfg.segment_frames * d.hop_length
    b = JT.Batch(*map(jnp.asarray, batch))
    rng_g, _ = jax.random.split(jax.random.PRNGKey(KEY))

    def mel(w):
        return mel_spectrogram(w, d.filter_length, d.n_mel_channels, d.sample_rate,
                               d.hop_length, d.win_length, d.mel_fmin, d.mel_fmax)

    def g_loss(gp):
        out = net_g.apply({"params": gp}, b.phone, b.phone_lengths, b.pitch, b.pitchf,
                          b.spec, b.spec_lengths, b.sid, rng=rng_g)
        real = slice_segments(b.wave, out.ids_slice * hop, seg)[:, :, None]
        loss = JL.mel_l1_loss(mel(real[:, :, 0]), mel(out.wave[:, :, 0])) * tr.c_mel
        loss = loss + JL.kl_loss(out.z_p, out.logs_q, out.m_p, out.logs_p, out.y_mask) * tr.c_kl
        _, y_d_gs, fmap_rs, fmap_gs = net_d.apply({"params": dp}, real, out.wave)
        loss = loss + JL.generator_loss(y_d_gs) + JL.feature_loss(fmap_rs, fmap_gs)
        return loss, (out.wave, real)

    (total, (y_hat, real)), g_grads = jax.jit(jax.value_and_grad(g_loss, has_aux=True))(gp)

    def d_loss(dp):
        y_d_rs, y_d_gs, _, _ = net_d.apply({"params": dp}, real, y_hat)
        return JL.discriminator_loss(y_d_rs, y_d_gs)

    d_grads = jax.jit(jax.grad(d_loss))(dp)
    return float(total), JT.sanitize_grads(g_grads), JT.sanitize_grads(d_grads)


def flat(tree) -> np.ndarray:
    leaves = sorted(W.flatten_tree(tree).items()) if isinstance(tree, dict) else [("", tree)]
    return np.concatenate([np.asarray(v, np.float64).ravel() for _, v in leaves])


def test_gradients_match_the_reference_per_module():
    jcfg, cfg = train_configs()
    net_g, net_d, gp, dp = train_pair(3)
    batch = train_batch(cfg, 3)
    ref_total, ref_g, ref_d = jax_grads(jcfg, gp, dp, batch)

    g_opt, d_opt = make_optimizers(cfg, net_g, net_d)
    step = TrainStep(cfg, net_g, net_d, g_opt, d_opt)
    b = Batch(*(t(x) for x in batch))
    b = b._replace(pitch=b.pitch.long(), sid=b.sid.long())
    total, _, y_hat, real = step.g_losses(b, **jax_draws(jax.random.PRNGKey(KEY), cfg, batch))
    assert float(total.detach()) == pytest.approx(ref_total, rel=1e-4)
    names = [n for n, _ in net_g.named_parameters()]
    g = W.convert_synthesizer_state_dict(
        {n: v.numpy() for n, v in zip(names, sanitize_grads(step.g_grads(total)))})
    d_loss = step.d_loss(real.detach(), y_hat.detach())
    d_names = [n for n, _ in net_d.named_parameters()]
    d = W.convert_discriminator_state_dict(
        {n: v.numpy() for n, v in zip(d_names, torch.autograd.grad(d_loss, d_opt.params))})

    assert sorted(g) == sorted(ref_g)
    for module in ("enc_p", "enc_q", "flow", "dec", "emb_g"):
        got, ref = flat(g[module]), flat(ref_g[module])
        corr = np.corrcoef(got, ref)[0, 1]
        assert corr > 0.9999, (module, corr)
    got, ref = flat(d), flat(ref_d)
    assert np.corrcoef(got, ref)[0, 1] > 0.9999
