"""Port modules against their JAX counterparts on the same parameters and
inputs (small widths). Bar: ROADMAP's per-module RMSE < 0.01 and
correlation > 0.99; float32 on both sides, so most agree far closer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.models import generators as JG
from rvc_tpu.models.encoders import TextEncoder as JaxTextEncoder
from rvc_tpu.models.flow import ResidualCouplingBlock as JaxFlow
from rvc_tpu.models.rmvpe import decode_salience as jax_decode
from rvc_tpu_torch.models.generators import sine_source
from rvc_tpu_torch.models.rmvpe import decode_salience
from torch_port_helpers import SMALL_SYNTH, assert_parity, huberts, rmvpes, synthesizers, t

M = SMALL_SYNTH.model
B, T = 2, 24
LENGTHS = np.array([T, 17], np.int32)


@pytest.fixture(scope="module")
def synth():
    return synthesizers()


def _rng(seed):
    return np.random.default_rng(seed)


@torch.no_grad()
def test_text_encoder(synth):
    port, _, params = synth
    rng = _rng(0)
    phone = rng.standard_normal((B, T, M.text_enc_hidden_dim)).astype(np.float32)
    pitch = rng.integers(1, 256, (B, T)).astype(np.int32)
    enc = JaxTextEncoder(M.inter_channels, M.hidden_channels, M.filter_channels,
                         M.n_heads, M.n_layers, M.kernel_size,
                         embedding_dim=M.text_enc_hidden_dim)
    ref = enc.apply({"params": params["enc_p"]}, jnp.asarray(phone), jnp.asarray(pitch),
                    jnp.asarray(LENGTHS))
    got = port.enc_p(t(phone), t(pitch).long(), t(LENGTHS))
    for name, g, r in zip(("m_p", "logs_p", "x_mask"), got, ref):
        assert_parity(g.numpy(), np.asarray(r), name)


@torch.no_grad()
def test_flow_reverse(synth):
    """Reverse order: flip BEFORE each coupling layer (flow.py:76-78)."""
    port, _, params = synth
    rng = _rng(1)
    x = rng.standard_normal((B, T, M.inter_channels)).astype(np.float32)
    mask = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.float32)[:, :, None]
    g = rng.standard_normal((B, 1, M.gin_channels)).astype(np.float32)
    flow = JaxFlow(M.inter_channels, M.hidden_channels, 5, 1, 3, gin_channels=M.gin_channels)
    ref = flow.apply({"params": params["flow"]}, jnp.asarray(x), jnp.asarray(mask),
                     g=jnp.asarray(g), reverse=True)
    assert_parity(port.flow(t(x), t(mask), t(g)).numpy(), np.asarray(ref), "flow")


def _f0(rng, n):
    f0 = rng.uniform(90, 400, (1, n)).astype(np.float32)
    f0[:, n // 3: n // 2] = 0.0  # an unvoiced run
    return f0


@torch.no_grad()
def test_nsf_generator_noise_off(synth):
    """Noise off on both sides; the 0.01 LReLU slope before conv_post."""
    port, _, params = synth
    rng = _rng(2)
    x = rng.standard_normal((1, T, M.inter_channels)).astype(np.float32)
    g = rng.standard_normal((1, 1, M.gin_channels)).astype(np.float32)
    f0 = _f0(rng, T)
    dec = JG.HiFiGANNSFGenerator(M.inter_channels, M.resblock_kernel_sizes,
                                 M.resblock_dilation_sizes, M.upsample_rates,
                                 M.upsample_initial_channel, M.upsample_kernel_sizes,
                                 M.gin_channels, SMALL_SYNTH.data.sample_rate)
    ref = dec.apply({"params": params["dec"]}, jnp.asarray(x), jnp.asarray(f0),
                    jnp.asarray(g), rng=None)
    got = port.dec(t(x), t(f0), t(g))
    assert got.shape == ref.shape
    assert_parity(got.numpy(), np.asarray(ref), "decoder")


def test_sine_source_with_the_reference_noise():
    """The same noise on both sides: the reference's own draw, handed over."""
    rng = _rng(3)
    f0 = _f0(rng, 12)
    key = jax.random.PRNGKey(7)
    ref, ref_v = JG.sine_source(jnp.asarray(f0), 40, 16000, rng=key)
    noise = np.asarray(jax.random.normal(key, ref.shape))
    got, got_v = sine_source(t(f0), 40, 16000, noise=t(noise))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@torch.no_grad()
def test_synthesizer_infer(synth):
    port, jnet, params = synth
    rng = _rng(4)
    phone = rng.standard_normal((1, T, M.text_enc_hidden_dim)).astype(np.float32)
    f0 = _f0(rng, T)
    pitch = rng.integers(1, 256, (1, T)).astype(np.int32)
    lengths, sid = np.array([T - 3], np.int32), np.array([1], np.int32)
    ref, _ = jnet.apply({"params": params}, jnp.asarray(phone), jnp.asarray(lengths),
                        jnp.asarray(pitch), jnp.asarray(f0), jnp.asarray(sid), rng=None,
                        method=jnet.infer)
    got, _ = port.infer(t(phone), t(lengths), t(pitch).long(), t(f0), t(sid).long())
    assert got.shape == ref.shape
    assert_parity(got.numpy(), np.asarray(ref), "Synthesizer.infer")


@torch.no_grad()
def test_hubert():
    port, jnet, params = huberts()
    audio = (0.3 * _rng(5).standard_normal((1, 8000))).astype(np.float32)
    ref = jnet.apply({"params": params}, jnp.asarray(audio), output_hidden_states=True)
    got = port(t(audio))
    assert got.shape == ref.shape
    assert_parity(got.numpy(), np.asarray(ref), "hubert")


@torch.no_grad()
def test_rmvpe_and_decode():
    """E2E on a 64-frame mel; decode_salience on the same salience is
    exact up to float32 rounding of the weighted cents (rtol 1e-5)."""
    port, jnet, variables = rmvpes()
    mel = _rng(6).standard_normal((1, 64, 128)).astype(np.float32)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(mel)))
    got = port(t(mel)).numpy()
    assert_parity(got, ref, "rmvpe salience")
    sal = np.concatenate([ref, np.zeros_like(ref[:, :4])], axis=1)
    sal[:, -4:, 200] = 0.02  # below the 0.03 voicing threshold -> 0 Hz
    np.testing.assert_allclose(decode_salience(t(sal)).numpy(),
                               np.asarray(jax_decode(jnp.asarray(sal), 0.03)), rtol=1e-5)
