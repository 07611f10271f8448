"""The benchmark's generators repeat by seed."""

import numpy as np
import torch

from portbench import signals, weights
from portbench.reference import nets
from portbench.tests import helpers

VOICE = helpers.run.load_json(helpers.run.PKG / "traffic" / "song_noindex.json")["voice"]


def test_voice_repeats_by_seed():
    a = signals.voice(2.0, VOICE, 2 ** 31 + 5, "cpu")
    b = signals.voice(2.0, VOICE, 2 ** 31 + 5, "cpu")
    c = signals.voice(2.0, VOICE, 2 ** 31 + 6, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (32000,) and torch.isfinite(a).all()


def test_lengths_are_one_set_in_seeded_orders():
    rule = {"dist": "lognormal", "median": 200, "sigma": 0.3, "clip": [120, 300], "count": 12}
    a, b = signals.lengths(rule, 7), signals.lengths(rule, 8)
    assert a == signals.lengths(rule, 7)
    assert sorted(a) == sorted(b) and a != b
    assert min(a) >= 120 and max(a) <= 300


def test_weights_repeat_by_seed():
    m = nets.build("rmvpe")
    a, b = weights.make(m, 3, "cpu", 1), weights.make(m, 3, "cpu", 1)
    c = weights.make(m, 4, "cpu", 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cnn.weight"], c["cnn.weight"])


def test_training_pool_repeats_by_seed():
    p = helpers.small("rvc_v2_40k.train")
    pools = []
    for seed in (11, 11):
        d = p["driver"].Driver(p["config"], p["traffic"], seed, torch.device("cpu"))
        d.make_pool()
        pools.append((d.pool, d.draws))
    (pa, da), (pb, db) = pools
    for x, y in zip(pa, pb):
        assert all(torch.equal(x[k], y[k]) for k in x)
    for x, y in zip(da, db):
        assert all(torch.equal(s, t) for s, t in zip(x, y))
    lens = np.concatenate([b["lengths"].numpy() for b in pa])
    assert lens.max() == p["traffic"]["frames"] and lens.min() >= p["traffic"]["short_frames"][0]
