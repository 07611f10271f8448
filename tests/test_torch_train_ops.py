"""Training's ops, losses and modules in the port against the JAX package,
on the same numpy inputs and parameters (small widths): the training
spectrograms, the segment slices, the losses (rel 1e-5), K1-K3 under the
kernels' autograd Function with a swappable forward, the posterior encoder
and the training forward (ROADMAP's module bar: RMSE < 0.01, corr > 0.99),
the discriminators' outputs and feature maps, and the upstream D
checkpoint converter."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.models.discriminators import MultiPeriodDiscriminator as JaxMPD
from rvc_tpu.models.encoders import PosteriorEncoder as JaxPosterior
from rvc_tpu.models.synthesizer import build_synthesizer as jax_build
from rvc_tpu.train import losses as JL
from rvc_tpu.utils import weights as W
from rvc_tpu_torch.models.discriminators import PERIODS_V3, MultiPeriodDiscriminator
from rvc_tpu_torch.ops import commons as C
from rvc_tpu_torch.ops import stft as S
from rvc_tpu_torch.ops.kernels import KernelFunction
from rvc_tpu_torch.ops.kernels import attention as KA
from rvc_tpu_torch.ops.kernels import resblock as KR
from rvc_tpu_torch.train import losses as L
from rvc_tpu_torch.utils import weights as PW
# `rvc_tpu.ops` re-exports a function named `stft` over its module
JC = importlib.import_module("rvc_tpu.ops.commons")
JS = importlib.import_module("rvc_tpu.ops.stft")
from torch_port_helpers import (  # noqa: E402
    assert_parity,
    jax_draws,
    numpy_state,
    t,
    train_batch,
    train_configs,
    train_pair,
)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wave(seed, B=2, n=4000):
    return (0.3 * np.random.default_rng(seed).standard_normal((B, n))).astype(np.float32)


def test_training_spectrograms():
    y = _wave(0)
    ref = np.asarray(JS.spectrogram(jnp.asarray(y), 1024, 320, 1024))
    got = S.spectrogram(t(y), 1024, 320, 1024).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    ref = np.asarray(JS.mel_spectrogram(jnp.asarray(y), 1024, 80, 32000, 320, 1024, 0.0, None))
    got = S.mel_spectrogram(t(y), 1024, 80, 32000, 320, 1024, 0.0, None).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_slice_segments_given_the_same_ids():
    x = np.random.default_rng(1).standard_normal((3, 20, 4)).astype(np.float32)
    ids = np.array([0, 7, 19], np.int32)              # 19: past T - 5, clamped as lax does
    ref = np.asarray(JC.slice_segments(jnp.asarray(x), jnp.asarray(ids), 5))
    np.testing.assert_array_equal(C.slice_segments(t(x), t(ids), 5).numpy(), ref)
    ref = np.asarray(JC.slice_segments(jnp.asarray(x[..., 0]), jnp.asarray(ids), 5))
    np.testing.assert_array_equal(C.slice_segments(t(x[..., 0]), t(ids), 5).numpy(), ref)


def test_rand_slice_segments_draws_in_range():
    x = torch.randn(64, 30, 2)
    lengths = torch.randint(1, 31, (64,))
    seg, ids = C.rand_slice_segments(x, lengths, 8, torch.Generator().manual_seed(0))
    assert ((ids >= 0) & (ids <= torch.clamp(lengths - 8, min=0))).all()
    assert torch.equal(seg, C.slice_segments(x, ids, 8))
    assert ids.max() > 0


def test_losses_match_the_reference():
    rng = np.random.default_rng(2)
    dr = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
    dg = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
    fr = [[rng.standard_normal((2, 4, 3)).astype(np.float32) for _ in range(2)] for _ in range(2)]
    fg = [[rng.standard_normal((2, 4, 3)).astype(np.float32) for _ in range(2)] for _ in range(2)]
    z_p, logs_q, m_p = (rng.standard_normal((2, 6, 4)).astype(np.float32) for _ in range(3))
    logs_p = 6.0 * rng.standard_normal((2, 6, 4)).astype(np.float32)   # some past the clamp
    mask = (np.arange(6)[None, :] < np.array([6, 4])[:, None]).astype(np.float32)[:, :, None]
    a, b = _wave(3), _wave(4)
    j = lambda xs: [jnp.asarray(x) for x in xs]
    p = lambda xs: [t(x) for x in xs]
    pairs = [
        (L.discriminator_loss(p(dr), p(dg)), JL.discriminator_loss(j(dr), j(dg))),
        (L.generator_loss(p(dg)), JL.generator_loss(j(dg))),
        (L.feature_loss([p(f) for f in fr], [p(f) for f in fg]),
         JL.feature_loss([j(f) for f in fr], [j(f) for f in fg])),
        (L.kl_loss(*p((z_p, logs_q, m_p, logs_p, mask))),
         JL.kl_loss(*j((z_p, logs_q, m_p, logs_p, mask)))),
        (L.mel_l1_loss(t(a), t(b)), JL.mel_l1_loss(jnp.asarray(a), jnp.asarray(b))),
        (L.multi_scale_mel_loss(t(a), t(b), 32000),
         JL.multi_scale_mel_loss(jnp.asarray(a), jnp.asarray(b), 32000)),
    ]
    for got, ref in pairs:
        assert float(got) == pytest.approx(float(ref), rel=1e-5)


def _k1_inputs(C_=16, T=40):
    rng = np.random.default_rng(5)
    x = t(rng.standard_normal((2, T, C_)).astype(np.float32)).requires_grad_()
    ks, ds = (3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    ws = []
    for k in ks:
        for shape in ((3, k, C_, C_), (3, C_), (3, k, C_, C_), (3, C_)):
            ws.append(t((0.1 * rng.standard_normal(shape)).astype(np.float32)).requires_grad_())
    return x, ws, ks, ds


def test_k1_function_gives_every_weight_its_gradient():
    """K1 under `KernelFunction` with the bf16-emulating plain forward in place
    of the kernel: the forward is that emulation's, and x and each of the 12
    tensors of the flat weight tuple get the float32 plain stage's own
    gradient, in order."""
    x, ws, ks, ds = _k1_inputs()
    fwd = functools.partial(KR.resblock_group_reference, bf16_operands=True)
    out = KernelFunction.apply(lambda x, *w: fwd(x, w, ks, ds, 0.1),
                               lambda x, *w: KR.resblock_group_reference(x, w, ks, ds, 0.1),
                               x, *ws)
    torch.testing.assert_close(out, fwd(x, ws, ks, ds, 0.1), rtol=0, atol=0)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, [x, *ws], g)
    ref = torch.autograd.grad(KR.resblock_group_reference(x, ws, ks, ds), [x, *ws], g)
    assert len(got) == 13
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"input {i}")


def test_k2_function_gradients():
    x, ws, _, _ = _k1_inputs()
    w = ws[4:8]                                          # the k = 7 chain
    fwd = functools.partial(KR.resblock_chain_reference, bf16_operands=True)
    out = KernelFunction.apply(lambda *t: fwd(*t, 7, (1, 3, 5), 0.1),
                               lambda *t: KR.resblock_chain_reference(*t, 7, (1, 3, 5), 0.1),
                               x, *w)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, [x, *w], g)
    ref = torch.autograd.grad(KR.resblock_chain_reference(x, *w, 7), [x, *w], g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k3_function_gradients_with_ragged_keys():
    """K3 under `KernelFunction`: q, k, v and both rel-pos tables get the plain
    version's gradients; key_lens none. The garbage query rows past a
    length take a zero gradient, as the TextEncoder's x_mask gives them."""
    rng = np.random.default_rng(6)
    q, k, v = (t(rng.standard_normal((2, 2, 24, 16)).astype(np.float32)).requires_grad_()
               for _ in range(3))
    ek, ev = (t(rng.standard_normal((1, 21, 16)).astype(np.float32)).requires_grad_()
              for _ in range(2))
    lens = torch.tensor([24, 13])
    plain = lambda q, k, v, ek, ev, lens: KA.rel_attention_reference(q, k, v, ek, ev, 10, lens)
    out = KernelFunction.apply(plain, plain, q, k, v, ek, ev, lens)
    valid = (torch.arange(24)[None, :] < lens[:, None])[:, None, :, None].float()
    g = torch.randn_like(out) * valid
    got = torch.autograd.grad(out, [q, k, v, ek, ev], g)
    ref = torch.autograd.grad(KA.rel_attention_reference(q, k, v, ek, ev, 10, lens),
                              [q, k, v, ek, ev], g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (got[0] * (1 - valid)).abs().max() == 0


@pytest.fixture(scope="module")
def pair():
    return train_pair(0)


def test_posterior_encoder(pair):
    net_g, _, gp, _ = pair
    jcfg, cfg = train_configs()
    m = cfg.model
    rng = np.random.default_rng(7)
    spec = rng.standard_normal((2, 24, cfg.data.spec_channels)).astype(np.float32)
    lengths = np.array([24, 15], np.int32)
    g = rng.standard_normal((2, 1, m.gin_channels)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    enc = JaxPosterior(cfg.data.spec_channels, m.inter_channels, m.hidden_channels, 5, 1, 16,
                       gin_channels=m.gin_channels)
    ref = enc.apply({"params": gp["enc_q"]}, jnp.asarray(spec), jnp.asarray(lengths),
                    jnp.asarray(g), rng=key)
    eps = np.asarray(jax.random.normal(key, (2, 24, m.inter_channels)))
    with torch.no_grad():
        got = net_g.enc_q(t(spec), t(lengths), t(g), eps=t(eps))
    for name, a, b in zip(("z", "m_q", "logs_q", "y_mask"), got, ref):
        assert_parity(a.numpy(), np.asarray(b), name)


def test_training_forward(pair):
    """The Synthesizer's training forward with the JAX forward's own draws
    (eps, segment starts, the NSF source noise) handed across."""
    net_g, _, gp, _ = pair
    jcfg, cfg = train_configs()
    batch = train_batch(cfg, 8)
    key = jax.random.PRNGKey(11)
    rng_g, _ = jax.random.split(key)
    jnet = jax_build(jcfg)
    ref = jax.jit(lambda p, *a: jnet.apply({"params": p}, *a, rng=rng_g))(
        gp, *map(jnp.asarray, batch[:6]), jnp.asarray(batch[7]))
    draws = jax_draws(key, cfg, batch)
    with torch.no_grad():
        got = net_g(t(batch[0]), t(batch[1]), t(batch[2]).long(), t(batch[3]), t(batch[4]),
                    t(batch[5]), t(batch[7]).long(), **draws)
    np.testing.assert_array_equal(got.ids_slice.numpy(), np.asarray(ref.ids_slice))
    for name in got._fields:
        if name != "ids_slice":
            assert_parity(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), name)


@pytest.mark.parametrize("v3", [False, True], ids=["v2", "v3"])
def test_discriminator_outputs_and_feature_maps(v3):
    torch.manual_seed(9)
    port = MultiPeriodDiscriminator(PERIODS_V3, True) if v3 else MultiPeriodDiscriminator()
    params = W.convert_discriminator_state_dict(numpy_state(port))
    ref_net = JaxMPD(periods=PERIODS_V3, use_multi_resolution=True) if v3 else JaxMPD()
    y, y_hat = (w[:, :, None] for w in (_wave(10, n=1600), _wave(11, n=1600)))
    ref = jax.jit(ref_net.apply)({"params": params}, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = port(t(y), t(y_hat))
    n_disc = 1 + len(port.periods) + 3 * v3
    for outs, refs in zip(got[:2], ref[:2]):
        assert len(outs) == len(refs) == n_disc
        for a, b in zip(outs, refs):
            assert_parity(a.numpy(), np.asarray(b), "output")
    for maps, refs in zip(got[2:], ref[2:]):
        for fa, fb in zip(maps, refs):
            assert len(fa) == len(fb)
            for a, b in zip(fa, fb):
                assert a.shape == b.shape
                assert_parity(a.numpy(), np.asarray(b), "feature map")


@pytest.mark.parametrize("n_periods", [6, 8, 5], ids=["v1", "v2", "v3"])
def test_discriminator_pth_converter(n_periods):
    """An upstream-named D state dict under weight norm (weight_g /
    weight_v), built here, through the port's `discriminator_from_pth`
    against the reference's `convert_discriminator_state_dict`."""
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator as MPD

    periods = {6: (2, 3, 5, 7, 11, 17), 8: (2, 3, 5, 7, 11, 17, 23, 37), 5: PERIODS_V3}
    torch.manual_seed(n_periods)
    port = MPD(periods[n_periods], use_multi_resolution=n_periods == 5)
    rng = np.random.default_rng(n_periods)
    sd = {}
    for k, v in numpy_state(port).items():
        if k.endswith(".weight"):
            stem = k[: -len(".weight")]
            sd[stem + ".weight_v"] = v
            sd[stem + ".weight_g"] = rng.uniform(0.5, 1.5, (v.shape[0],) + (1,) * (v.ndim - 1)
                                                 ).astype(np.float32)
        else:
            sd[k] = v
    state = PW.discriminator_from_pth(sd)
    port.load_state_dict(state, strict=True)
    ref = W.flatten_tree(W.convert_discriminator_state_dict(sd))
    got = PW.discriminator_to_jax(state)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
    back = PW.discriminator_from_jax(W.unflatten_tree(ref))
    for k, v in state.items():
        torch.testing.assert_close(back[k], v, rtol=1e-6, atol=1e-7)


def test_refinegan_trains_after_converting():
    """RefineGAN's cached decimation taps, first made under inference mode
    by a conversion, still take part in a training backward."""
    from torch_port_helpers import synthesizers

    dec = synthesizers(vocoder="RefineGAN")[0].dec
    rng = np.random.default_rng(12)
    x = t(rng.standard_normal((1, 6, 16)).astype(np.float32))
    f0 = t(rng.uniform(100, 300, (1, 6)).astype(np.float32))
    g = t(rng.standard_normal((1, 1, 16)).astype(np.float32))
    with torch.inference_mode():
        dec(x, f0, g)
    loss = dec(x.requires_grad_(), f0, g).square().mean()
    grads = torch.autograd.grad(loss, [x, *dec.parameters()], allow_unused=True)
    assert torch.isfinite(grads[0]).all() and grads[0].abs().max() > 0


def test_recorded_calls_hold_no_graph(pair):
    """`record_calls` inside a training forward keeps detached copies: no
    recorded tensor carries an autograd graph across steps."""
    from rvc_tpu_torch.ops.kernels import record_calls

    net_g = pair[0]
    _, cfg = train_configs()
    batch = train_batch(cfg, 13)
    draws = jax_draws(jax.random.PRNGKey(1), cfg, batch)
    with record_calls() as calls:
        out = net_g(t(batch[0]), t(batch[1]), t(batch[2]).long(), t(batch[3]), t(batch[4]),
                    t(batch[5]), t(batch[7]).long(), **draws)
    assert out.wave.requires_grad
    names = {fn.__name__ for fn, _, _ in calls}
    assert names == {"resblock_group", "rel_attention"}
    tensors = [x for _, args, kw in calls for a in (*args, *kw.values())
               for x in (a if isinstance(a, tuple) else (a,)) if isinstance(x, torch.Tensor)]
    assert tensors and all(x.grad_fn is None and not x.requires_grad for x in tensors)
