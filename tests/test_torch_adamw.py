"""The optimizer's step on the CPU (`ops.kernels.adamw`, `train.optim`).

On CPU tensors `AdamW.step` takes the plain version and launches nothing.
Since the optimizer sanitizes the gradients itself, its step on raw
gradients (NaN, +-inf, values past 1e3) is held bit for bit against the
old sequence: `sanitize_grads`, then the old per-tensor step, copied below
as it was, and to 1e-6 against the JAX package's own sequence:
`rvc_tpu.train.train_step.sanitize_grads`, then its optax chain, gated as
its train step gates D. `ShardedAdamW` on one rank gives the same numbers
as `AdamW`; on a rank of four, its layout's rows address exactly its ZeRO-1
slices (`view_rows` against torch indexing), and its step is the old
per-tensor loop over the slices bit for bit. The card's kernel is held to
the plain version in `test_torch_adamw_cuda.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rvc_tpu.train import train_step as JT

from rvc_tpu_torch.ops.kernels import LAUNCHES
from rvc_tpu_torch.ops.kernels import adamw as K
from rvc_tpu_torch.parallel.mesh import Axis
from rvc_tpu_torch.parallel.train import ShardedAdamW
from rvc_tpu_torch.train.optim import AdamW
from torch_port_helpers import train_configs

LR, SPE, DECAY, B1, B2, EPS = 1e-3, 2, 0.5, 0.8, 0.99, 1e-9
SHAPES = [(4, 3, 5), (7,), (2, 2, 2), (33,), (1,)]


def old_step(params, grads, mu, nu, count, b1_mu, gate=None):
    """The train step's `sanitize_grads` and `AdamW.step` before the
    optimizer took in the sanitizing; returns the new count."""
    grads = K.sanitize_grads(grads)
    g_norm = torch.sqrt(sum(torch.sum(t.float() ** 2) for t in grads))
    keep = g_norm < 1.0
    new_count = count + 1
    p_ = torch.floor(count.float() / SPE)
    rate = torch.tensor(DECAY, dtype=torch.float32)
    lr = torch.where(count <= 0, torch.tensor(LR), LR * torch.pow(rate, p_))
    bc1 = 1.0 - torch.pow(torch.tensor(B1), new_count.float())
    bc2 = 1.0 - torch.pow(torch.tensor(B2), new_count.float())
    for p, g, m_, v_ in zip(params, grads, mu, nu):
        g = torch.where(keep, g, g / g_norm * 1.0)
        m = (1.0 - B1) * g + b1_mu * m_.float()
        v = (1.0 - B2) * g ** 2 + B2 * v_
        u = (m / bc1) / (torch.sqrt(v / bc2) + EPS) + 0.01 * p
        new = p + (-lr) * u
        if gate is None:
            p.copy_(new)
            m_.copy_(m)
            v_.copy_(v)
        else:
            p.copy_(torch.where(gate, new, p))
            m_.copy_(torch.where(gate, m.to(m_.dtype), m_))
            v_.copy_(torch.where(gate, v, v_))
    return new_count if gate is None else torch.where(gate, new_count, count)


def raw_grads(seed, scale, bad=True):
    """Gradients N(0, scale) with, where `bad`, a NaN, +inf, -inf and
    values past +-1e3 in the first tensors."""
    g = torch.Generator().manual_seed(seed)
    grads = [scale * torch.randn(s, generator=g) for s in SHAPES]
    if bad:
        grads[0].view(-1)[:5] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                              5e3, -2e4])
        grads[1][3] = float("nan")
    return grads


def fresh():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=g) for s in SHAPES]


@pytest.mark.parametrize("scale,bad", [(1e-3, False), (3.0, True)], ids=["under1", "over1"])
@pytest.mark.parametrize("gate", [None, True, False])
@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_step_equals_sanitize_then_old_step(mu_dtype, gate, scale, bad):
    """Three steps across a steps_per_epoch boundary (the third decays):
    parameters, both moments and the count equal the old sequence's bit
    for bit; the returned norm is the sanitized gradients' norm, under 1 (no
    clip) or over it; a False gate changes nothing."""
    params, ref = fresh(), fresh()
    opt = AdamW(params, LR, SPE, DECAY, B1, B2, EPS, mu_dtype=mu_dtype)
    mu = [torch.zeros_like(p, dtype=mu_dtype) for p in ref]
    nu = [torch.zeros_like(p) for p in ref]
    count = torch.zeros((), dtype=torch.int32)
    b1_mu = torch.tensor(B1, dtype=mu_dtype).item()
    before = LAUNCHES["adamw"]
    for k in range(3):
        grads = raw_grads(k, scale, bad)
        flag = None if gate is None else torch.tensor(gate)
        got = opt.step([g.clone() for g in grads], gate=flag)
        count = old_step(ref, grads, mu, nu, count, b1_mu, gate=flag)
        norm = K.global_norm(K.sanitize_grads(grads))
        assert torch.equal(got, norm)
        assert (float(norm) < 1.0) == (scale < 1.0)
        assert torch.equal(opt.count, count)
        for a, b in zip(params + opt.mu + opt.nu, ref + mu + nu):
            assert torch.equal(a, b)
    assert LAUNCHES["adamw"] == before          # the CPU launches nothing
    assert int(opt.count) == (0 if gate is False else 3)
    if gate is False:
        assert all(torch.equal(p, q) for p, q in zip(params, fresh()))


@pytest.mark.parametrize("gate", [None, True, False])
@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
def test_step_on_raw_grads_matches_sanitize_then_optax(use_bf16, gate):
    """Three steps on raw gradients (NaN, +-inf, values past 1e3) across a
    steps_per_epoch boundary against the JAX package: its `sanitize_grads`,
    then `make_optimizers`' chain (jitted, as in its train step), its update
    kept or dropped whole by the gate as its D update is. Bars: the norm to
    rel 1e-6 against optax.global_norm of the sanitized gradients (over 1:
    the clip acts); parameters and both moments to 1e-6; the count equal."""
    jcfg, _ = train_configs(train_use_bf16=use_bf16, train_lr_decay=0.5)
    g_tx, _ = JT.make_optimizers(jcfg, steps_per_epoch=SPE)
    update = jax.jit(g_tx.update)
    keys = [f"p{i}" for i in range(len(SHAPES))]
    port = fresh()
    # a copy: `jnp.asarray` of a host array may share its memory, and the port
    # updates `port` in place while JAX's asynchronous update may still read it
    jp = {k: jnp.array(p.numpy()) for k, p in zip(keys, port)}
    st = g_tx.init(jp)
    opt = AdamW(port, jcfg.train.learning_rate, SPE, 0.5, *jcfg.train.betas, jcfg.train.eps,
                mu_dtype=torch.bfloat16 if use_bf16 else None)
    flag = None if gate is None else torch.tensor(gate)
    for k in range(3):
        grads = raw_grads(k, 3.0)
        clean = JT.sanitize_grads({n: jnp.asarray(g.numpy()) for n, g in zip(keys, grads)})
        upd, new_st = update(clean, st, jp)
        new_jp = optax.apply_updates(jp, upd)
        if gate is False:
            new_jp, new_st = jax.tree.map(lambda n, o: jnp.where(False, n, o),
                                          (new_jp, new_st), (jp, st))
        jp, st = new_jp, new_st
        norm = opt.step([g.clone() for g in grads], gate=flag)
        want = float(optax.global_norm(clean))
        assert want > 1.0 and float(norm) == pytest.approx(want, rel=1e-6)
    adam = st[1][0]
    assert int(opt.count) == int(adam.count) == (0 if gate is False else 3)
    for i, k in enumerate(keys):
        np.testing.assert_allclose(port[i].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(opt.mu[i].float().numpy(),
                                   np.asarray(adam.mu[k], np.float32), rtol=0, atol=1e-6)
        np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]), rtol=0, atol=1e-6)
    assert opt.mu[0].dtype == (torch.bfloat16 if use_bf16 else torch.float32)
    if gate is False:
        assert all(torch.equal(p, q) for p, q in zip(port, fresh()))


def test_plain_version_is_the_wrapper_on_cpu():
    """`adamw` on a CPU layout returns `adamw_reference`'s norm and state."""
    h = K.Hyper(LR, SPE, DECAY, B1, B2, EPS, B1)
    a, b = fresh(), fresh()
    la = K.Layout(a, [torch.zeros_like(p) for p in a], [torch.zeros_like(p) for p in a])
    lb = K.Layout(b, [torch.zeros_like(p) for p in b], [torch.zeros_like(p) for p in b])
    ca, cb = torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32)
    grads = raw_grads(7, 3.0)
    assert torch.equal(K.adamw(la, grads, ca, h), K.adamw_reference(lb, grads, cb, h))
    assert int(ca) == int(cb) == 1
    for x, y in zip(la.params + la.mu + la.nu, lb.params + lb.mu + lb.nu):
        assert torch.equal(x, y)


@pytest.mark.parametrize("gate", [None, False])
def test_sharded_adamw_one_rank_equals_adamw(gate):
    """ZeRO's step on one rank (every slice whole, no collective) gives
    AdamW's numbers and norm bit for bit."""
    a, b = fresh(), fresh()
    opt = AdamW(a, LR, SPE, DECAY, B1, B2, EPS, mu_dtype=torch.bfloat16)
    zero = ShardedAdamW(b, LR, data=Axis(), model=Axis(), min_size=1, steps_per_epoch=SPE,
                        decay_rate=DECAY, b1=B1, b2=B2, eps=EPS, mu_dtype=torch.bfloat16)
    for k in range(3):
        grads = raw_grads(k, 3.0)
        flag = None if gate is None else torch.tensor(gate)
        assert torch.equal(opt.step(grads, gate=flag), zero.step(grads, gate=flag))
    assert torch.equal(opt.count, zero.count)
    for x, y in zip(a + opt.mu + opt.nu, b + zero.mu + zero.nu):
        assert torch.equal(x, y)


def test_state_dict_count_is_a_copy():
    """The count advances in place: a state dict taken before a step keeps
    its count, and a loaded count is the optimizer's own tensor."""
    params = fresh()
    opt = AdamW(params, LR, SPE, DECAY, B1, B2, EPS)
    opt.step(raw_grads(0, 1.0))
    state = opt.state_dict()
    count = opt.count
    opt.step(raw_grads(1, 1.0))
    assert int(state["count"]) == 1 and int(opt.count) == 2 and opt.count is count
    opt.load_state_dict(state)
    opt.step(raw_grads(2, 1.0))
    assert int(state["count"]) == 1 and int(opt.count) == 2


# (whole shape, the dimension ZeRO-1 over four ranks splits at min_size 16):
# the FFN's conv_2 and the phone embedding split along dim 1, conv_1 along
# dim 0, a row of odd length along dim 0 (slices off a 4-element boundary)
ZERO_SHAPES = [((8, 24, 3), 1), ((8, 24), 1), ((24, 8, 3), 0), ((12, 5), 0), ((7,), None),
               ((1,), None), ((2, 3), None)]


@pytest.mark.parametrize("index", range(4))
@pytest.mark.parametrize("shape,dim", [s for s in ZERO_SHAPES if s[1] is not None]
                         + [((4, 6, 8, 3), 2), ((16, 4), 0)], ids=str)
def test_view_rows_address_the_slice(shape, dim, index):
    """A narrow along `dim` of a contiguous tensor as the kernel's rows:
    element offset + r * row_stride + c (r < rows, c < row_len) of the
    whole is the slice's element r * row_len + c; rows, row_len and
    row_stride as prod(shape[:d]), n * prod(shape[d+1:]) and shape[d] *
    prod(shape[d+1:]), one row along dim 0."""
    whole = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    n = shape[dim] // 4
    view = whole.narrow(dim, index * n, n)
    r = K.view_rows(whole, view)
    inner = int(np.prod(shape[dim + 1:]))
    outer = int(np.prod(shape[:dim]))
    assert (r.rows, r.row_len) == ((1, outer * n * inner) if outer == 1 else (outer, n * inner))
    if outer > 1:
        assert r.row_stride == shape[dim] * inner
    assert r.offset == index * n * inner
    at = r.offset + (torch.arange(r.rows)[:, None] * r.row_stride
                     + torch.arange(r.row_len)[None, :])
    assert torch.equal(whole.reshape(-1)[at.reshape(-1)], view.reshape(-1))
    grad = torch.randn(shape)
    layout = K.Layout([whole], [torch.zeros(n * inner * outer)], [torch.zeros(n * inner * outer)],
                      [view])
    assert torch.equal(layout.grad_view(0, grad), grad.narrow(dim, index * n, n))


def test_view_rows_refuse_other_views():
    """A transposed view, a view of another tensor or one off its contiguous
    tensor has no rows of one stride: refused."""
    whole = torch.zeros(6, 8)
    for view in (whole.t(), whole[::2, ::2], torch.zeros(6, 8)[:, :4]):
        with pytest.raises(ValueError):
            K.view_rows(whole, view)
    with pytest.raises(ValueError):
        K.view_rows(whole.t(), whole.t()[:2])


@pytest.mark.parametrize("gate", [None, False])
@pytest.mark.parametrize("index", range(4))
def test_zero1_rank_step_is_the_loop_over_its_slices(index, gate):
    """ZeRO-1's layout on data index `index` of 4 (CPU): `adamw` over it,
    three steps from whole raw gradients, equals bit for bit the old
    sequence, `sanitize_grads`, the norm of the whole gradients, then
    `adamw_update` over the narrowed slices; nothing outside the rank's
    slices moves; a False gate changes nothing."""
    shapes = [s for s, _ in ZERO_SHAPES]
    g = torch.Generator().manual_seed(3)
    start = [torch.randn(s, generator=g) for s in shapes]
    params, ref = [p.clone() for p in start], [p.clone() for p in start]
    opt = ShardedAdamW(params, LR, data=Axis(4, index), model=Axis(), min_size=16,
                       steps_per_epoch=SPE, decay_rate=DECAY, b1=B1, b2=B2, eps=EPS,
                       mu_dtype=torch.bfloat16)
    assert opt.dims == [d for _, d in ZERO_SHAPES]

    def cut(i, t):
        d = opt.dims[i]
        return t if d is None else t.narrow(d, index * t.shape[d] // 4, t.shape[d] // 4)

    mu = [torch.zeros_like(cut(i, p), dtype=torch.bfloat16) for i, p in enumerate(ref)]
    nu = [torch.zeros_like(cut(i, p)) for i, p in enumerate(ref)]
    count = torch.zeros((), dtype=torch.int32)
    flag = None if gate is None else torch.tensor(gate)
    for k in range(3):
        grads = [3.0 * torch.randn(s, generator=g) for s in shapes]
        grads[0].view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -5e3])
        got = K.adamw(opt.layout(), [x.clone() for x in grads], opt.count, opt.hyper, flag)
        clean = K.sanitize_grads(grads)
        want = K.global_norm(clean)
        K.adamw_update([cut(i, p) for i, p in enumerate(ref)],
                       [cut(i, x) for i, x in enumerate(clean)], mu, nu, count, opt.hyper,
                       want, flag)
        assert torch.equal(got, want) and torch.equal(opt.count, count)
    for a, b in zip(params + opt.mu + opt.nu, ref + mu + nu):
        assert torch.equal(a, b)
    for i, (p, p0) in enumerate(zip(params, start)):
        outside = p0.clone()
        cut(i, outside).copy_(cut(i, p))
        assert torch.equal(p, outside)
        assert gate is not False or torch.equal(p, p0)
