"""One full G+D step with the MRF HiFi-GAN and RefineGAN decoders, the
port against the JAX package's `make_train_step` at the JAX tests' tiny
model. RefineGAN trains against the v3 discriminator (five periods and the
multi-resolution bank) and the multi-scale mel loss. The decoders' noise
(harmonic phases, source noise, AdaIN) is off on both sides: the JAX
decoders' draws are zeroed in this test (their module's `jax.random`
normal and uniform replaced), and the port's decoders take no generator.
The posterior's eps and the segment starts are the JAX step's own draws.
Bar: each loss to rel 1e-4."""

import types

import jax
import jax.numpy as jnp
import pytest
import torch

from rvc_tpu.models import generators_extra as JGX
from test_torch_train_step import LOSSES, KEY, assert_losses, jax_step, port_step
from torch_port_helpers import jax_draws, train_batch, train_configs, train_pair


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_decoders_without_noise(monkeypatch):
    random = types.SimpleNamespace(
        split=jax.random.split,
        normal=lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype),
        uniform=lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    proxy = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax) if not k.startswith("_")})
    proxy.random = random
    monkeypatch.setattr(JGX, "jax", proxy)


@pytest.mark.parametrize("vocoder", ["MRF HiFi-GAN", "RefineGAN"])
def test_vocoder_step_matches_make_train_step(vocoder, jax_decoders_without_noise):
    jcfg, cfg = train_configs(model_vocoder=vocoder)
    net_g, net_d, gp, dp = train_pair(4, model_vocoder=vocoder)
    assert net_d.use_multi_resolution == (vocoder == "RefineGAN")
    batch = train_batch(cfg, 4)
    _, ref = jax_step(jcfg, gp, dp, batch)
    draws = jax_draws(jax.random.PRNGKey(KEY), cfg, batch, nsf=False)
    _, got = port_step(cfg, net_g, net_d, batch, draws)
    assert_losses(got, ref, LOSSES)
