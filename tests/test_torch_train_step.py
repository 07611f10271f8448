"""The port's GAN train step (`rvc_tpu_torch.train.train_step`) against the
JAX package's `make_train_step` at the JAX tests' tiny model
(`tests/unit/test_train_step.py`): the same parameters (the port's init,
carried over by the reference's converters), the same batch, and the JAX
step's own draws handed to the port's training forward. Bars: each loss to
rel 1e-4 (float32 on both sides; sums in another order); the optimizer
alone to 1e-6 against optax over three steps."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rvc_tpu.models.synthesizer import build_synthesizer as jax_build
from rvc_tpu.train import train_step as JT
from rvc_tpu_torch.train.optim import AdamW
from rvc_tpu_torch.train.train_step import Batch, TrainStep, make_optimizers
from rvc_tpu_torch.utils import profiling
from torch_port_helpers import (assert_nested, jax_draws, span_tree, t, train_batch,
                                train_configs, train_pair)

LOSSES = ("loss_g_total", "loss_d", "loss_mel", "loss_kl", "loss_adv", "loss_fm")
KEY = 5


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_step(jcfg, gp, dp, batch, adversarial=True, d_step=None):
    """One `make_train_step` step from (gp, dp): (new state, metrics)."""
    g_tx, d_tx = JT.make_optimizers(jcfg, 100)
    state = JT.TrainState(gp, dp, g_tx.init(gp), d_tx.init(dp), jnp.zeros((), jnp.int32))
    step = JT.make_train_step(jcfg, jax_build(jcfg), JT.build_discriminator(jcfg),
                              adversarial=adversarial)
    state, metrics = step(state, JT.Batch(*map(jnp.asarray, batch)), jax.random.PRNGKey(KEY))
    return state, {k: float(v) for k, v in metrics.items()}


def port_step(cfg, net_g, net_d, batch, draws, adversarial=True, freeze_encoder=False):
    g_opt, d_opt = make_optimizers(cfg, net_g, net_d, 100)
    step = TrainStep(cfg, net_g, net_d, g_opt, d_opt, adversarial=adversarial,
                     freeze_encoder=freeze_encoder)
    b = Batch(*(t(x) for x in batch))
    b = b._replace(pitch=b.pitch.long(), sid=b.sid.long())
    metrics = step(b, **draws)
    return step, {k: float(v) for k, v in metrics.items()}


def assert_losses(got, ref, keys=LOSSES):
    for k in keys:
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-6), (k, got[k], ref[k])


def test_adversarial_step_matches_make_train_step():
    jcfg, cfg = train_configs()
    net_g, net_d, gp, dp = train_pair(0)
    batch = train_batch(cfg, 0)
    _, ref = jax_step(jcfg, gp, dp, batch)
    _, got = port_step(cfg, net_g, net_d, batch, jax_draws(jax.random.PRNGKey(KEY), cfg, batch))
    assert_losses(got, ref)
    assert got["grad_norm_g"] == pytest.approx(ref["grad_norm_g"], rel=1e-3)


def test_warmup_step_matches_make_train_step():
    """Warmup mode: no adversarial and feature-matching terms, D still steps."""
    jcfg, cfg = train_configs()
    net_g, net_d, gp, dp = train_pair(1)
    batch = train_batch(cfg, 1)
    _, ref = jax_step(jcfg, gp, dp, batch, adversarial=False)
    _, got = port_step(cfg, net_g, net_d, batch, jax_draws(jax.random.PRNGKey(KEY), cfg, batch),
                       adversarial=False)
    assert got["loss_adv"] == got["loss_fm"] == 0.0
    assert_losses(got, ref)


def test_gated_d_step_leaves_d_untouched():
    """A D loss under d_loss_threshold skips the whole D update: params,
    both moments and the count stay bit-identical, while G still steps.
    With freeze_encoder, enc_p's gradients are zero, so its moments stay
    zero and only the decoupled decay moves it: p (1 - lr 0.01)."""
    _, cfg = train_configs(train_d_loss_threshold=1e9)
    net_g, net_d, _, _ = train_pair(2, train_d_loss_threshold=1e9)
    batch = train_batch(cfg, 2)
    d0 = {k: v.clone() for k, v in net_d.state_dict().items()}
    g0 = {k: v.clone() for k, v in net_g.state_dict().items()}
    step, got = port_step(cfg, net_g, net_d, batch, jax_draws(jax.random.PRNGKey(KEY), cfg, batch),
                          freeze_encoder=True)
    assert got["loss_d"] < 1e9
    for k, v in net_d.state_dict().items():
        assert torch.equal(v, d0[k]), k
    assert all(torch.count_nonzero(m) == 0 for m in step.d_opt.mu + step.d_opt.nu)
    assert int(step.d_opt.count) == 0 and int(step.g_opt.count) == 1
    assert any(not torch.equal(v, g0[k]) for k, v in net_g.state_dict().items())
    lr = cfg.train.learning_rate
    for (k, v), mu in zip(net_g.named_parameters(), step.g_opt.mu):
        if k.startswith("enc_p."):
            assert torch.count_nonzero(mu) == 0, k
            torch.testing.assert_close(v.detach(), g0[k] * (1 - lr * 0.01), rtol=1e-6,
                                       atol=0, msg=k)
            assert g0[k].abs().max() == 0 or not torch.equal(v.detach(), g0[k]), k


@pytest.mark.parametrize("use_bf16", [True, False])
def test_optimizer_matches_optax(use_bf16):
    """Three steps of the G optimizer alone on fixed gradients against the
    reference's optax chain: bf16 first moment (or float32), the staircase
    learning rate (steps_per_epoch 2, so the third step decays) and
    freeze_encoder's zero gradients, under which decoupled decay still
    shrinks the parameters. Bar: 1e-6 on params and moments."""
    jcfg, _ = train_configs(train_use_bf16=use_bf16, train_lr_decay=0.5)
    rng = np.random.default_rng(0)
    shapes = {"enc_p": (4, 3), "dec": (5,), "flow": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (0.0 if k == "enc_p" else 3.0) * rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    g_tx, _ = JT.make_optimizers(jcfg, steps_per_epoch=2)
    jp = jax.tree.map(jnp.asarray, params)
    st = g_tx.init(jp)
    update = jax.jit(g_tx.update)             # as inside the jitted train step
    keys = sorted(shapes)
    port = [torch.from_numpy(params[k].copy()) for k in keys]
    opt = AdamW(port, jcfg.train.learning_rate, 2, 0.5, *jcfg.train.betas, jcfg.train.eps,
                mu_dtype=torch.bfloat16 if use_bf16 else None)
    for g in grads:
        upd, st = update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g[k]) for k in keys])
    adam = st[1][0]
    assert int(opt.count) == int(adam.count) == 3
    for i, k in enumerate(keys):
        np.testing.assert_allclose(port[i].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(opt.mu[i].float().numpy(),
                                   np.asarray(adam.mu[k], np.float32), rtol=0, atol=1e-6)
        np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]), rtol=0, atol=1e-6)
    assert opt.mu[0].dtype == (torch.bfloat16 if use_bf16 else torch.float32)
    frozen = port[keys.index("enc_p")].numpy()
    assert (np.abs(frozen) < np.abs(params["enc_p"])).all()   # decayed while frozen
    np.testing.assert_allclose(frozen, np.asarray(jp["enc_p"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("d_steps", [1, 2])
def test_step_spans(monkeypatch, d_steps):
    """With RVC_TPU_TRACE=1 a step opens one train/step, its request id the
    step's number, over G's forward, backward and optim/adamw, then one
    train/d_update (with D's optim/adamw) per D update. No K1/K2 weight
    conversion: the kernels' plain versions run on the CPU."""
    monkeypatch.setenv("RVC_TPU_TRACE", "1")
    monkeypatch.setattr(profiling, "_GLOBAL", profiling.SpanTimer())
    _, cfg = train_configs(train_d_step_per_g_step=d_steps)
    net_g, net_d, _, _ = train_pair(3, train_d_step_per_g_step=d_steps)
    g_opt, d_opt = make_optimizers(cfg, net_g, net_d, 100)
    step = TrainStep(cfg, net_g, net_d, g_opt, d_opt)
    b = Batch(*(t(x) for x in train_batch(cfg, 3)))
    b = b._replace(pitch=b.pitch.long(), sid=b.sid.long())
    for _ in range(2):
        step(b, generator=torch.Generator().manual_seed(0))
    spans = profiling.global_tracer().spans()
    assert_nested(spans)
    assert span_tree(spans) == {
        "train/step": 2, "train/step > train/g_forward": 2, "train/step > train/g_backward": 2,
        "train/step > optim/adamw": 2, "train/step > train/d_update": 2 * d_steps,
        "train/step > train/d_update > optim/adamw": 2 * d_steps}
    assert [s.request for s in spans if s.name == "train/step"] == [0, 1]
    assert [s.name for s in spans if s.request == 1][:3] == [
        "train/g_forward", "train/g_backward", "optim/adamw"]
