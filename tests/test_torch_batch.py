"""Batched and long-form conversion: the port's `BatchConverter` against the
JAX `BatchConverter` on a one-device mesh, with the same small models
(`torch_port_helpers`) and source noise off on both sides. Bar: the same
shapes, waveform corr > 0.995 per row; rows do not mix within a batch.
The compute policy is float32 (RVC_TPU_BF16=0) but in the bf16 case of
`test_convert_batch_matches_jax`, which sets it to 1 on both sides."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rvc_tpu.parallel.infer import BatchConverter as JaxBatchConverter
from rvc_tpu.parallel.mesh import make_mesh
from rvc_tpu_torch.ops.kernels import record_calls
from rvc_tpu_torch.parallel import BatchConverter
from rvc_tpu_torch.pipelines.offline import Pipeline
from torch_port_helpers import huberts, rmvpes, synthesizers

SR = 32000


@pytest.fixture(autouse=True)
def no_source_noise(monkeypatch):
    """The JAX programs read these when they first trace."""
    monkeypatch.setenv("RVC_TPU_SOURCE_NOISE", "0")
    monkeypatch.setenv("RVC_TPU_F16_OUT", "0")
    monkeypatch.setenv("RVC_TPU_BF16", "0")


def _converters():
    """(JAX BatchConverter, port BatchConverter) over the same weights; the
    JAX one takes the small RMVPE through its facade before it builds (and
    reads RVC_TPU_BF16 then)."""
    port_s, jax_s, s_params = synthesizers()
    port_h, jax_h, h_params = huberts()
    port_r, jax_r, r_vars = rmvpes()
    cfg = SimpleNamespace(data=SimpleNamespace(sample_rate=SR))
    jax_rvc = SimpleNamespace(
        hubert=jax_h, synthesizer=jax_s, cfg=cfg,
        pipeline=SimpleNamespace(synth_variables={"params": s_params},
                                 hubert_variables={"params": h_params}))
    ref = JaxBatchConverter(jax_rvc, make_mesh(n_data=1, n_model=1))
    ref._rmvpe = SimpleNamespace(model=jax_r, variables=r_vars)
    port_rvc = SimpleNamespace(pipeline=Pipeline(SR, port_s, port_h, port_r),
                               cfg=cfg, device=torch.device("cpu"))
    return ref, BatchConverter(port_rvc)


@pytest.fixture(scope="module")
def converters():
    return _converters()


def _chirp(seconds, f_start, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    phase = 2 * np.pi * (f_start * t + 60 * t * t)
    return (0.5 * np.sin(phase) + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _assert_rows(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    for i, (g, r) in enumerate(zip(got, ref)):
        corr = np.corrcoef(g, r)[0, 1]
        assert corr > 0.995, f"row {i}: waveform corr {corr:.6f}"


@pytest.mark.parametrize("policy", ["0", "1"], ids=["float32", "bf16"])
def test_convert_batch_matches_jax(converters, monkeypatch, policy):
    """B = 3 rows of different pitch; T = 14,000 is padded to 14,080. Under
    RVC_TPU_BF16=1 a JAX converter built under it, and the port's bf16
    copies."""
    ref_bc, port_bc = converters
    if policy == "1":
        monkeypatch.setenv("RVC_TPU_BF16", "1")
        ref_bc, port_bc = _converters()
    batch = np.stack([_chirp(0.875, f, seed=i) for i, f in enumerate((110.0, 180.0, 260.0))])
    kw = dict(sids=np.array([0, 1, 1]), pitch_shift=2.0, protect=0.33)
    ref = np.asarray(ref_bc.convert_batch(batch, **kw))
    got = port_bc.convert_batch(batch, **kw)
    assert got.shape == (3, 14080 * SR // 16000)
    _assert_rows(got, ref)
    assert (port_bc.rvc.pipeline._bf16 is not None) == (policy == "1")


def test_rows_do_not_mix(converters):
    """A row converted inside a batch of 3 equals it converted alone."""
    _, port_bc = converters
    batch = np.stack([_chirp(0.6, f, seed=i) for i, f in enumerate((120.0, 200.0, 300.0))])
    together = port_bc.convert_batch(batch, np.array([1, 0, 1]))
    alone = port_bc.convert_batch(batch[1:2], np.array([0]))
    np.testing.assert_allclose(together[1], alone[0], atol=1e-5, rtol=0)


def test_convert_long_batch_matches_jax(converters):
    """3 utterances in 0.5 s windows with 0.1 s of context, 2 windows a
    dispatch: 3 + 1 + 1 windows, so the last group is padded."""
    ref_bc, port_bc = converters
    utts = [_chirp(s, f, seed=10 + i) for i, (s, f) in enumerate(((1.2, 130.0), (0.3, 220.0),
                                                                  (0.45, 170.0)))]
    kw = dict(sids=[1, 0, 1], chunk_seconds=0.5, pad_seconds=0.1, batch_size=2)
    ref = ref_bc.convert_long_batch(utts, **kw)
    with record_calls() as calls:
        got = port_bc.convert_long_batch(utts, **kw)
    assert [fn.__name__ for fn, _, _ in calls].count("log_mel") == 3   # one per dispatch
    assert all(args[0].shape[0] == 2 for fn, args, _ in calls if fn.__name__ == "log_mel")
    for u, g, r in zip(utts, got, ref):
        assert g.shape == r.shape == (len(u) * SR // 16000,)
        corr = np.corrcoef(g, np.asarray(r))[0, 1]
        assert corr > 0.995, f"waveform corr {corr:.6f}"
