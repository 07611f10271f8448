"""The AdamW kernel (`ops.kernels.adamw`, `csrc/adamw.cu`) against its plain
version on the card. Skips where there is no CUDA device:

    python -m pytest tests/test_torch_adamw_cuda.py -m cuda -q --noconftest

Shapes: every parameter of the 40 kHz G at small widths (1 text layer, a
64-channel decoder) and of the v2 D (no width to cut), as `make_optimizers`
hands them over. Gradients carry NaN, +-inf and values past 1e3, or are
small enough that the norm stays under 1.

Bars, each per tensor as ||fused - plain|| / ||plain|| (rel_l2): the
norm against the plain version's and against a float64 one within 1e-6
(only the order of the sums differs); parameters and both moments within
1e-6 against the plain per-tensor loop run on the card from the same state
and given the kernel's norm (so a last-bit difference of the norm cannot
flip a bf16 rounding of the first moment). The kernel rounds after every
operation as the eager ops do, so this holds to about the last bit.

ZeRO-1's ranks (`ShardedAdamW`, four data indices on one card, `_share`
left out: it is a collective): the same bars against the plain loop over
the same slices, the norm over the whole gradients, bit-identical on every
rank, as are the tensors every rank keeps whole."""

import json
from pathlib import Path

import pytest
import torch

from rvc_tpu_torch.ops.kernels import LAUNCHES
from rvc_tpu_torch.ops.kernels import adamw as K
from rvc_tpu_torch.utils.device import use_fp32_numerics

pytestmark = pytest.mark.cuda

CONFIG_40K = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "rvc_v2_40k.json"
SPE, DECAY = 2, 0.5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    use_fp32_numerics()
    return torch.device("cuda")


def config_40k(**small):
    from rvc_tpu_torch.configs import config_from_dict

    cfg = json.loads(CONFIG_40K.read_text())
    for key, value in small.items():
        cfg["model"][key] = value
    return config_from_dict(cfg)


def networks(cfg, dev):
    from rvc_tpu_torch.models.discriminators import build_discriminator
    from rvc_tpu_torch.models.synthesizer import build_synthesizer

    torch.manual_seed(0)
    with torch.device(dev):
        return build_synthesizer(cfg, training=True), build_discriminator(cfg)


@pytest.fixture(scope="module")
def shapes():
    """The small 40 kHz G's parameter shapes, then D's."""
    cfg = config_40k(n_layers=1, upsample_initial_channel=64)
    with torch.device("meta"):
        net_g, net_d = networks(cfg, "meta")
    return [tuple(p.shape) for net in (net_g, net_d) for p in net.parameters()]


def grads_for(shapes, dev, seed, over):
    """N(0, 1e-5) gradients (norm under 1), or N(0, 1) with NaN, +-inf and
    values past +-1e3 in every tenth tensor (norm over 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = [torch.randn(s, device=dev, generator=gen) * (1.0 if over else 1e-5)
             for s in shapes]
    for i, g in enumerate(grads):
        g = g.view(-1)
        g[:1] = float("nan")
        if over and i % 10 == 0 and g.numel() >= 4:
            g[1:4] = torch.tensor([float("inf"), -float("inf"), 3e3], device=dev)
    return grads


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def state_of(layout, count):
    return [t.clone() for t in layout.params + layout.mu + layout.nu] + [count.clone()]


@pytest.mark.parametrize("over", [False, True], ids=["under1", "over1"])
@pytest.mark.parametrize("gate", [None, True, False])
@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_fused_matches_plain(dev, shapes, mu_dtype, gate, over):
    """Three steps across a steps_per_epoch boundary: each step from the
    same state, the kernel against the plain loop given the kernel's norm;
    the count advances only where the gate allows; each step is one wrapper
    launch and bumps every written tensor's version."""
    gen = torch.Generator(device=dev).manual_seed(1)
    params = [torch.randn(s, device=dev, generator=gen) * 0.1 for s in shapes]
    mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    start = [p.clone() for p in params]
    layout = K.Layout(params, mu, nu)
    h = K.Hyper(1e-3, SPE, DECAY, 0.8, 0.99, 1e-9, torch.tensor(0.8, dtype=mu_dtype).item())
    count = torch.zeros((), dtype=torch.int32, device=dev)
    flag = None if gate is None else torch.tensor(gate, device=dev)
    for k in range(3):
        grads = grads_for(shapes, dev, 10 + k, over)
        plain = state_of(layout, count)
        versions = [t._version for t in layout.params + layout.mu + layout.nu + [count]]
        before = LAUNCHES["adamw"]
        norm = K.adamw(layout, grads, count, h, flag)
        assert LAUNCHES["adamw"] == before + 1
        assert all(t._version > v for t, v in
                   zip(layout.params + layout.mu + layout.nu + [count], versions))
        clean = K.sanitize_grads(grads)
        want = K.global_norm(clean)
        exact = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in clean))
        assert rel_l2(norm, want) < 1e-6 and rel_l2(norm, exact) < 1e-6
        assert (float(norm) < 1.0) == (not over)
        n = len(params)
        K.adamw_update(plain[:n], clean, plain[n:2 * n], plain[2 * n:3 * n], plain[-1], h,
                       norm, flag)
        got = state_of(layout, count)
        assert int(got[-1]) == int(plain[-1]) == (0 if gate is False else k + 1)
        for i, (a, b) in enumerate(zip(got[:-1], plain[:-1])):
            assert rel_l2(a, b) < 1e-6, (i % n, ("p", "mu", "nu")[i // n], rel_l2(a, b))
    if gate is False:
        assert all(torch.equal(p, q) for p, q in zip(layout.params, start))


def test_unaligned_and_tail_elements(dev):
    """A parameter and a gradient that start off a 16-byte boundary (the
    scalar path), sizes that are no multiple of 4 or of a chunk (the tails)
    and a non-contiguous gradient (copied): the plain loop's numbers."""
    params = [torch.randn(K.CHUNK + 5, device=dev),
              torch.randn(2 * K.CHUNK + 8, device=dev)[1:],
              torch.randn(64, 33, device=dev)]
    mu = [torch.zeros_like(p, dtype=torch.bfloat16) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    layout = K.Layout(params, mu, nu)
    h = K.Hyper(1e-3, SPE, DECAY, 0.8, 0.99, 1e-9, torch.tensor(0.8, dtype=torch.bfloat16).item())
    count = torch.zeros((), dtype=torch.int32, device=dev)
    grads = [torch.randn(K.CHUNK + 5, device=dev),
             torch.randn(2 * K.CHUNK + 10, device=dev)[3:],
             torch.randn(33, 64, device=dev).t()]
    assert not grads[2].is_contiguous()
    for _ in range(2):
        plain = state_of(layout, count)
        norm = K.adamw(layout, grads, count, h)
        assert rel_l2(norm, K.global_norm(grads)) < 1e-6
        K.adamw_update(plain[:3], grads, plain[3:6], plain[6:9], plain[-1], h, norm)
        for a, b in zip(state_of(layout, count), plain):
            assert rel_l2(a, b) < 1e-6


def test_step_does_not_synchronize(dev, shapes):
    """After the first step (the layout's tables and the library), a step
    makes no host synchronisation and no read-back."""
    from rvc_tpu_torch.train.optim import AdamW

    params = [torch.zeros(s, device=dev) for s in shapes]
    opt = AdamW(params, 1e-3, SPE, DECAY, mu_dtype=torch.bfloat16)
    opt.step(grads_for(shapes, dev, 0, True))
    grads = grads_for(shapes, dev, 1, True)
    gate = torch.tensor(True, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step(grads, gate=gate)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(opt.count) == 2


def test_all_40k_tensors_take_the_fused_path(dev):
    """The benchmark's 40 kHz G (423 tensors) and D (110) through
    `make_optimizers` and `TrainStep`'s optimizers: one launch each, every
    tensor laid out and updated, bf16 first moments, the norm the sanitized
    gradients' norm."""
    from rvc_tpu_torch.train.train_step import make_optimizers

    cfg = config_40k()
    net_g, net_d = networks(cfg, dev)
    g_opt, d_opt = make_optimizers(cfg, net_g, net_d)
    for opt, n in ((g_opt, 423), (d_opt, 110)):
        before = [p.detach().clone() for p in opt.params]
        grads = grads_for([tuple(p.shape) for p in opt.params], dev, n, True)
        launches = LAUNCHES["adamw"]
        norm = opt.step(grads)
        assert LAUNCHES["adamw"] == launches + 1
        assert len(opt.params) == n and int(opt.count) == 1
        assert all(m.dtype == torch.bfloat16 for m in opt.mu)
        assert all(not torch.equal(p, q) for p, q in zip(opt.params, before))
        assert rel_l2(norm, K.global_norm(K.sanitize_grads(grads))) < 1e-6


# G-like tensors as ZeRO-1 over four ranks cuts them (min_size 1 << 16),
# with the dimension it splits: the FFN's conv_2 and the phone embedding
# along dim 1 (strided slices), conv_1 along dim 0, a row of odd length
# along dim 0 (slices off a 16-byte boundary), small tensors kept whole
ZERO_SHAPES = [((192, 768, 3), 1), ((192, 768), 1), ((768, 192, 3), 0), ((36, 4097), 0),
               ((192,), None), ((33,), None), ((1,), None), ((5, 3), None)]


def zero_rank(params, index, mu_dtype, dev):
    """`ShardedAdamW` of data index `index` of 4 over copies of `params`,
    its all-gather left out."""
    from rvc_tpu_torch.parallel.mesh import Axis
    from rvc_tpu_torch.parallel.train import ShardedAdamW

    opt = ShardedAdamW([p.clone() for p in params], 1e-3, data=Axis(4, index), model=Axis(),
                       steps_per_epoch=SPE, decay_rate=DECAY, mu_dtype=mu_dtype)
    opt._share = lambda: None
    return opt


@pytest.mark.parametrize("over", [False, True], ids=["under1", "over1"])
@pytest.mark.parametrize("gate", [None, False])
@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_zero1_slices_match_plain(dev, mu_dtype, gate, over):
    """Three steps of each of four ranks' `ShardedAdamW.step` from the same
    whole gradients: one kernel call a step; the norm the whole sanitized
    gradients' (1e-6) and equal bit for bit on every rank; each rank's
    slices, moments and count against the plain loop over the same slices
    given the kernel's norm (1e-6); nothing outside the rank's slices moves;
    the tensors every rank keeps whole equal bit for bit on every rank; a
    False gate changes nothing."""
    shapes = [s for s, _ in ZERO_SHAPES]
    gen = torch.Generator(device=dev).manual_seed(2)
    start = [torch.randn(s, device=dev, generator=gen) * 0.1 for s in shapes]
    ranks = [zero_rank(start, k, mu_dtype, dev) for k in range(4)]
    assert ranks[0].dims == [d for _, d in ZERO_SHAPES]
    flag = None if gate is None else torch.tensor(gate, device=dev)
    for step in range(3):
        grads = grads_for(shapes, dev, 20 + step, over)
        clean = K.sanitize_grads(grads)
        exact = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in clean))
        norms = []
        for opt in ranks:
            cut = [opt._local(i, t) for i, t in enumerate(opt.params)]
            plain = [t.clone() for t in cut + opt.mu + opt.nu] + [opt.count.clone()]
            before = [p.clone() for p in opt.params]
            versions = [p._version for p in opt.params]
            launches = LAUNCHES["adamw"]
            norm = opt.step(grads, flag)
            assert LAUNCHES["adamw"] == launches + 1
            assert all(p._version > v for p, v in zip(opt.params, versions))
            assert rel_l2(norm, K.global_norm(clean)) < 1e-6 and rel_l2(norm, exact) < 1e-6
            assert (float(norm) < 1.0) == (not over)
            norms.append(norm)
            n = len(cut)
            K.adamw_update(plain[:n], [opt._local(i, g) for i, g in enumerate(clean)],
                           plain[n:2 * n], plain[2 * n:3 * n], plain[-1], opt.hyper, norm, flag)
            assert int(opt.count) == int(plain[-1]) == (0 if gate is False else step + 1)
            got = cut + opt.mu + opt.nu
            for i, (a, b) in enumerate(zip(got, plain[:-1])):
                assert rel_l2(a, b) < 1e-6, (opt.data.index, i % n, ("p", "mu", "nu")[i // n])
            for i, (p, p0) in enumerate(zip(opt.params, before)):
                outside = p0.clone()
                opt._local(i, outside).copy_(opt._local(i, p))
                assert torch.equal(p, outside), (opt.data.index, i)
        assert all(torch.equal(x, norms[0]) for x in norms[1:])
    for i, (_, d) in enumerate(ZERO_SHAPES):
        if d is None:
            assert all(torch.equal(opt.params[i], ranks[0].params[i]) for opt in ranks[1:])
        if gate is False:
            assert all(torch.equal(opt.params[i], start[i]) for opt in ranks)


def test_zero1_strided_slices_of_any_row_length(dev):
    """Dim-1 slices whose rows are no multiple of 4 (row_len 3 x 5 = 15, off
    a 16-byte boundary: element by element) and whose rows are (row_len
    20, aligned: four at a time) give the plain loop's numbers over the
    slice, and nothing outside it moves."""
    shapes = [(64, 20, 3), (64, 20, 4)]
    gen = torch.Generator(device=dev).manual_seed(4)
    params = [torch.randn(s, device=dev, generator=gen) for s in shapes]
    views = [p.narrow(1, 5, 5) for p in params]
    mu = [torch.zeros_like(v, dtype=torch.bfloat16) for v in views]
    nu = [torch.zeros_like(v) for v in views]
    layout = K.Layout(params, mu, nu, views)
    assert [r.row_len for r in layout.rows] == [15, 20]
    assert layout.update_chunks.tolist() == [[0, 0], [1, 0]]      # over the views
    h = K.Hyper(1e-3, SPE, DECAY, 0.8, 0.99, 1e-9, torch.tensor(0.8, dtype=torch.bfloat16).item())
    count = torch.zeros((), dtype=torch.int32, device=dev)
    for k in range(2):
        grads = grads_for(shapes, dev, 30 + k, True)
        clean = K.sanitize_grads(grads)
        plain = [t.clone() for t in views + mu + nu] + [count.clone()]
        before = [p.clone() for p in params]
        norm = K.adamw(layout, grads, count, h)
        K.adamw_update(plain[:2], [g.narrow(1, 5, 5) for g in clean], plain[2:4], plain[4:6],
                       plain[-1], h, norm)
        for a, b in zip(views + mu + nu, plain[:-1]):
            assert rel_l2(a, b) < 1e-6
        for p, p0 in zip(params, before):
            assert torch.equal(torch.cat([p[:, :5], p[:, 10:]], 1),
                               torch.cat([p0[:, :5], p0[:, 10:]], 1))


def test_given_norm_is_taken(dev, shapes):
    """With `norm` given (tensor parallelism's collective norm), pass 1
    reads no gradient: the step returns that norm, clips by it and matches
    the plain loop given it."""
    gen = torch.Generator(device=dev).manual_seed(5)
    params = [torch.randn(s, device=dev, generator=gen) * 0.1 for s in shapes]
    layout = K.Layout(params, [torch.zeros_like(p, dtype=torch.bfloat16) for p in params],
                      [torch.zeros_like(p) for p in params])
    h = K.Hyper(1e-3, SPE, DECAY, 0.8, 0.99, 1e-9, torch.tensor(0.8, dtype=torch.bfloat16).item())
    count = torch.zeros((), dtype=torch.int32, device=dev)
    given = torch.tensor(2.5, device=dev)
    grads = grads_for(shapes, dev, 40, True)
    n = len(params)
    plain = state_of(layout, count)
    norm = K.adamw(layout, grads, count, h, norm=given)
    assert torch.equal(norm, given)
    K.adamw_update(plain[:n], K.sanitize_grads(grads), plain[n:2 * n], plain[2 * n:3 * n],
                   plain[-1], h, given)
    for a, b in zip(state_of(layout, count), plain):
        assert rel_l2(a, b) < 1e-6
