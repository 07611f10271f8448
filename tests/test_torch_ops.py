"""The port's primitive ops against `rvc_tpu.ops` on the same inputs and
reference-layout weights (float32 both sides: atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.ops import commons as jax_commons
from rvc_tpu.ops import conv as jax_conv
from rvc_tpu.ops.gru import bigru as jax_bigru
from rvc_tpu_torch.ops import commons, conv
from rvc_tpu_torch.ops.gru import BiGRU


def _r(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.3


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(stride=1, padding=2, dilation=1, groups=1),
    dict(stride=40, padding=20, dilation=1, groups=1),   # an NSF noise conv
    dict(stride=1, padding=(3, 1), dilation=1, groups=1),
    dict(stride=1, padding=10, dilation=5, groups=1),
    dict(stride=1, padding=4, dilation=1, groups=4),
])
def test_conv1d(kw):
    K = 80 if kw["stride"] == 40 else 5
    cin = 1 if kw["stride"] == 40 else 8
    x, w, b = _r(2, 400, cin), _r(K, cin // kw["groups"], 12, seed=1), _r(12, seed=2)
    ref = jax_conv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    _close(conv.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), **kw), ref)


@pytest.mark.parametrize("u,k,pad,opad", [(12, 24, 6, 0), (2, 4, 1, 0), (3, 7, 2, 1)])
def test_conv_transpose1d(u, k, pad, opad):
    x, w, b = _r(1, 30, 6), _r(k, 6, 5, seed=1), _r(5, seed=2)
    ref = jax_conv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    stride=u, padding=pad, output_padding=opad)
    _close(conv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                 stride=u, padding=pad, output_padding=opad), ref)


def test_conv2d_and_transpose():
    x, w = _r(1, 16, 12, 4), _r(3, 3, 4, 6, seed=1)
    _close(conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1),
           jax_conv.conv2d(jnp.asarray(x), jnp.asarray(w), padding=1))
    wt = _r(3, 3, 4, 2, seed=3)
    _close(conv.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(wt), stride=2,
                                 padding=1, output_padding=1),
           jax_conv.conv_transpose2d(jnp.asarray(x), jnp.asarray(wt), stride=2, padding=1,
                                     output_padding=1))


def test_commons():
    lengths = np.array([5, 2, 0], np.int32)
    np.testing.assert_array_equal(
        commons.sequence_mask(torch.from_numpy(lengths), 6).numpy(),
        np.asarray(jax_commons.sequence_mask(jnp.asarray(lengths), 6)))
    a, b = _r(2, 7, 8), _r(2, 7, 8, seed=1)
    _close(commons.fused_add_tanh_sigmoid_multiply(torch.from_numpy(a), torch.from_numpy(b), 4),
           jax_commons.fused_add_tanh_sigmoid_multiply(jnp.asarray(a), jnp.asarray(b), 4))


@torch.no_grad()
def test_bigru_gate_order():
    """nn.GRU's [r; z; n] rows are the reference scan's (ops/gru.py:1-14)."""
    torch.manual_seed(0)
    m = BiGRU(12, 8)
    x = _r(2, 20, 12)
    sd = {k: v.numpy() for k, v in m.gru.state_dict().items()}
    fwd = {n: jnp.asarray(sd[f"{n}_l0"]) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    bwd = {n: jnp.asarray(sd[f"{n}_l0_reverse"])
           for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    _close(m(torch.from_numpy(x)), jax_bigru(jnp.asarray(x), fwd, bwd))
