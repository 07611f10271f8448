"""The bf16 compute policy (RVC_TPU_BF16, RVC_TPU_BF16_F0) of the port
against the JAX package's under the same variables, on the CPU, at small
widths (`torch_port_helpers`).

The JAX side casts its parameter trees to bf16 (`_cast_float_tree`) and
feeds bf16 activations; the port runs its bf16 copies
(`Pipeline.models`, `models.synthesizer.bf16_copy`). Both round at other
places (a bf16 matmul's bias add, the attention's scores), so a module is
held at ROADMAP's per-module bar (RMSE < 0.01, corr > 0.99) and a pipeline
at the waveform corr of the float32 parity tests (> 0.995). The port's bf16
against its own float32 at the reference's bar
(`tests/unit/test_fused_pipeline.py:109-128`: waveform corr > 0.999,
spectrogram corr > 0.99). Source noise and the JAX side's f16 transfers
are off."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu import retrieval as JR
from rvc_tpu.models.encoders import TextEncoder as JaxTextEncoder
from rvc_tpu.models.flow import ResidualCouplingBlock as JaxFlow
from rvc_tpu.ops.pallas.attention import fused_rel_attention
from rvc_tpu.ops.stft import log_mel_spectrogram
from rvc_tpu.pipelines.offline import Pipeline as JaxPipeline
from rvc_tpu.pipelines.offline import _cast_float_tree
from rvc_tpu.pitch import PitchExtractor
from rvc_tpu_torch import retrieval as PR
from rvc_tpu_torch.models.rmvpe import RMVPE
from rvc_tpu_torch.models.synthesizer import bf16_copy
from rvc_tpu_torch.monitoring.voice_metrics import spectrogram_correlation
from rvc_tpu_torch.pipelines.offline import Pipeline
from rvc_tpu_torch.utils.device import bf16_f0, compute_dtype
from torch_port_helpers import SMALL_SYNTH, assert_parity, huberts, rmvpes, synthesizers, t

SR = 32000
UPS_GAIN = 20.0   # see torch_port_helpers.synthesizers
M = SMALL_SYNTH.model
BF16 = jnp.bfloat16


@pytest.fixture(autouse=True)
def reference_env(monkeypatch):
    """Noise off and float32 transfers on the JAX side (read when its
    programs are built); the policy unset unless a test sets it."""
    monkeypatch.setenv("RVC_TPU_SOURCE_NOISE", "0")
    monkeypatch.setenv("RVC_TPU_F16_IN", "0")
    monkeypatch.setenv("RVC_TPU_F16_OUT", "0")
    monkeypatch.delenv("RVC_TPU_BF16", raising=False)
    monkeypatch.delenv("RVC_TPU_BF16_F0", raising=False)


def _f(x) -> np.ndarray:
    """A bf16 tensor or array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _clip(seconds=0.9, seed=0, f_start=140.0):
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * 16000)) / 16000
    phase = 2 * np.pi * (f_start * tt + 60 * tt * tt)
    return (0.5 * np.sin(phase) + 0.01 * rng.standard_normal(len(tt))).astype(np.float32)


def test_policy_defaults_and_overrides(monkeypatch):
    """Unset: bf16 on a CUDA device, float32 on the CPU; 0 / 1 override;
    RVC_TPU_BF16_F0 off unless 1."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert compute_dtype(cuda) == torch.bfloat16 and compute_dtype(cpu) == torch.float32
    monkeypatch.setenv("RVC_TPU_BF16", "0")
    assert compute_dtype(cuda) == compute_dtype(cpu) == torch.float32
    monkeypatch.setenv("RVC_TPU_BF16", "1")
    assert compute_dtype(cuda) == compute_dtype(cpu) == torch.bfloat16
    assert not bf16_f0()
    monkeypatch.setenv("RVC_TPU_BF16_F0", "1")
    assert bf16_f0()


@torch.no_grad()
def test_hubert_bf16_matches_jax():
    """The bf16 copy on bf16 audio against `hubert.apply` on the cast tree
    and bf16 audio."""
    port, jnet, params = huberts()
    audio = (0.3 * np.random.default_rng(5).standard_normal((1, 8000))).astype(np.float32)
    ref = jnet.apply(_cast_float_tree({"params": params}, BF16),
                     jnp.asarray(audio).astype(BF16), output_hidden_states=True)
    pipe = Pipeline(SR, synthesizers()[0], port, rmvpes()[0])
    got = pipe.models(torch.bfloat16)[0](t(audio).bfloat16())
    assert got.dtype == torch.bfloat16 and ref.dtype == BF16 and got.shape == ref.shape
    assert_parity(_f(got), _f(ref), "hubert bf16")


def _pallas_attention(q, k, v, ek, ev, window_size, attn_mask=None, key_mask=None):
    """The JAX encoder's attention through the TPU kernel in interpret mode."""
    lens = key_mask.astype(jnp.float32).sum(-1).astype(jnp.int32)
    return fused_rel_attention(q, k, v, ek, ev, window_size, lens, interpret=True)


@torch.no_grad()
def test_enc_p_and_flow_bf16_match_jax(monkeypatch):
    """enc_p (K3's plain version on bf16 rows) and the reverse flow of the
    bf16 copy against the JAX modules on the cast tree, K3 through
    `fused_rel_attention(..., interpret=True)`; ragged lengths."""
    import rvc_tpu.models.encoders as JE

    monkeypatch.setattr(JE, "relative_attention", _pallas_attention)
    port, _, params = synthesizers()
    p16 = _cast_float_tree(params, BF16)
    copy = bf16_copy(port)
    rng = np.random.default_rng(0)
    B, T = 2, 24
    lengths = np.array([T, 17], np.int32)
    phone = rng.standard_normal((B, T, M.text_enc_hidden_dim)).astype(np.float32)
    pitch = rng.integers(1, 256, (B, T)).astype(np.int32)
    enc = JaxTextEncoder(M.inter_channels, M.hidden_channels, M.filter_channels,
                         M.n_heads, M.n_layers, M.kernel_size,
                         embedding_dim=M.text_enc_hidden_dim)
    ref = enc.apply({"params": p16["enc_p"]}, jnp.asarray(phone).astype(BF16),
                    jnp.asarray(pitch), jnp.asarray(lengths))
    got = copy.enc_p(t(phone).bfloat16(), t(pitch).long(), t(lengths))
    for name, g, r in zip(("m_p", "logs_p", "x_mask"), got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == BF16, name
        assert_parity(_f(g), _f(r), f"enc_p bf16 {name}")

    x = rng.standard_normal((B, T, M.inter_channels)).astype(np.float32)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)[:, :, None]
    g = rng.standard_normal((B, 1, M.gin_channels)).astype(np.float32)
    flow = JaxFlow(M.inter_channels, M.hidden_channels, 5, 1, 3, gin_channels=M.gin_channels)
    ref = flow.apply({"params": p16["flow"]}, *(jnp.asarray(a).astype(BF16) for a in (x, mask)),
                     g=jnp.asarray(g).astype(BF16), reverse=True)
    got = copy.flow(t(x).bfloat16(), t(mask).bfloat16(), t(g).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_parity(_f(got), _f(ref), "flow bf16")


@torch.no_grad()
def test_policy_moves_the_port_as_it_moves_the_reference():
    """`Synthesizer.infer` of the bf16 copy against the float32 model moves
    the waveform as the reference's parameter cast (`_cast_float_tree`,
    bf16 features) moves its own on the same weights: the two bf16-vs-float32
    corrs within 1e-4 of each other, and the port's bf16 against the
    reference's bf16 corr > 0.9999. Most of the move is the decoder's
    rounded parameters, which both apply (`noise_convs` first)."""
    from rvc_tpu_torch.pipelines.offline import coarse_f0

    port, jnet, params = synthesizers(ups_gain=UPS_GAIN)
    T = 60
    rng = np.random.default_rng(3)
    phone = rng.standard_normal((1, T, M.text_enc_hidden_dim)).astype(np.float32)
    f0 = (150 + 50 * np.sin(np.arange(T) / 8)).astype(np.float32)[None]
    f0[:, 20:26] = 0.0
    args = (np.array([T], np.int32), coarse_f0(f0), f0, np.array([1], np.int32))

    @jax.jit
    def jax_infer_jit(tree, ph):
        return jnet.apply({"params": tree}, ph, *map(jnp.asarray, args), rng=None,
                          method=jnet.infer)[0]

    def jax_infer(tree, dtype):
        return _f(jax_infer_jit(tree, jnp.asarray(phone).astype(dtype))).ravel()

    def port_infer(model, dtype):
        a = [t(x) for x in args]
        out, _ = model.infer(t(phone).to(dtype), a[0].long(), a[1].long(), a[2], a[3].long())
        return _f(out).ravel()

    j32, j16 = jax_infer(params, jnp.float32), jax_infer(_cast_float_tree(params, BF16), BF16)
    p32, p16 = port_infer(port, torch.float32), port_infer(bf16_copy(port), torch.bfloat16)
    moved_ref, moved = np.corrcoef(j16, j32)[0, 1], np.corrcoef(p16, p32)[0, 1]
    assert moved < 1.0 and abs(moved - moved_ref) < 1e-4, (moved, moved_ref)
    assert np.corrcoef(p16, j16)[0, 1] > 0.9999


def test_decoder_params_rounded_and_float32_unchanged(monkeypatch):
    """The bf16 copy's decoder is float32 on parameters rounded through
    bf16 (biases too), its other parts bf16; the float32 model is not
    touched, so a float32 conversion after a bf16 one is bit-equal to one
    before it."""
    port = synthesizers(ups_gain=UPS_GAIN)[0]
    pipe = Pipeline(SR, port, huberts()[0], rmvpes()[0])
    state = {k: v.clone() for k, v in port.state_dict().items()}
    clip = _clip()
    monkeypatch.setenv("RVC_TPU_BF16", "0")
    before = pipe.pipeline(clip, sid=1)
    monkeypatch.setenv("RVC_TPU_BF16", "1")
    pipe.pipeline(clip, sid=1)
    copy = pipe.models(torch.bfloat16)[1]
    for name, p in copy.dec.named_parameters():
        orig = dict(port.dec.named_parameters())[name]
        assert p.dtype == torch.float32, name
        assert torch.equal(p, orig.to(torch.bfloat16).float()), name
    assert any(n.endswith("bias") for n, _ in copy.dec.named_parameters())
    for part in (copy.emb_g, copy.enc_p, copy.flow):
        assert all(p.dtype == torch.bfloat16 for p in part.parameters())
    assert all(torch.equal(v, state[k]) for k, v in port.state_dict().items())
    monkeypatch.setenv("RVC_TPU_BF16", "0")
    np.testing.assert_array_equal(pipe.pipeline(clip, sid=1), before)


def _pipelines(ups_gain: float = UPS_GAIN):
    port_s, jax_s, s_params = synthesizers(ups_gain=ups_gain)
    port_h, jax_h, h_params = huberts()
    port_r, jax_r, r_vars = rmvpes()
    pitch = PitchExtractor("rmvpe", model=SimpleNamespace(model=jax_r, variables=r_vars))
    ref = JaxPipeline(tgt_sr=SR, synthesizer=jax_s, synth_variables={"params": s_params},
                      hubert=jax_h, hubert_variables={"params": h_params},
                      pitch_extractor=pitch)
    return ref, Pipeline(SR, port_s, port_h, port_r)


def _indexes():
    """(JAX index, port index) over the small HuBERT's features of chirps
    near the test clip's pitch."""
    port_h = huberts()[0]
    with torch.inference_mode():
        feats = np.concatenate([port_h(torch.from_numpy(_clip(1.0, seed=s, f_start=140 + 10 * s))
                                       [None])[0].numpy() for s in range(1, 7)])
    ref = JR.build_index(feats, seed=0)
    return ref, PR.IVFFlatIndex(centroids=ref.centroids.copy(), vectors=ref.vectors.copy(),
                                list_ids=ref.list_ids.copy(), nprobe=ref.nprobe)


@pytest.mark.parametrize("with_index", [False, True], ids=["no-index", "index"])
def test_fused_pipeline_bf16_matches_jax(monkeypatch, with_index):
    """RVC_TPU_BF16=1 on both sides, the fused RMVPE path (index_rate 0.75
    and protect 0.33 with an index): waveform corr > 0.995. The port's bf16
    against its float32: waveform corr > 0.999, spectrogram corr > 0.99."""
    monkeypatch.setenv("RVC_TPU_BF16", "1")
    ref_pipe, port_pipe = _pipelines()
    jax_index, port_index = _indexes() if with_index else (None, None)
    kw = dict(sid=1, index_rate=0.75, protect=0.33)
    clip = _clip()
    ref = ref_pipe.pipeline(clip, f0_method="rmvpe", index=jax_index, **kw)
    got = port_pipe.pipeline(clip, index=port_index, **kw)
    assert got.shape == ref.shape == (int(0.9 * SR),)
    corr = np.corrcoef(got, ref)[0, 1]
    assert corr > 0.995, f"bf16 against JAX bf16: waveform corr {corr:.6f}"
    assert port_pipe._bf16 is not None
    monkeypatch.setenv("RVC_TPU_BF16", "0")
    f32 = port_pipe.pipeline(clip, index=port_index, **kw)
    corr, spec = np.corrcoef(got, f32)[0, 1], spectrogram_correlation(f32, got)
    assert corr > 0.999 and spec > 0.99, f"bf16 against float32: corr {corr}, spec {spec}"


@torch.no_grad()
def test_bf16_f0_program_matches_jax(monkeypatch):
    """RVC_TPU_BF16_F0=1: the f0 program's salience (float32 log-mel, the
    padded mel in bf16 through the U-Net trunk, the head float32) against
    the JAX f0 program's under the knob, RMSE < 0.01, corr > 0.99; its f0
    against `_build_f0_program`'s, voiced on the same frames and within 1
    cent on them."""
    monkeypatch.setenv("RVC_TPU_BF16_F0", "1")
    ref_pipe, port_pipe = _pipelines()
    port_r, jax_r, r_vars = rmvpes()
    audio = np.pad(_clip(1.0, seed=3), (0, 15360 * 2 - 16000), mode="reflect")[None]

    # the JAX f0 program's salience, step by step as `_build_f0_program`
    mel = log_mel_spectrogram(jnp.asarray(audio), 1024, 128, 16000, 160, 1024,
                              fmin=30, fmax=8000, htk=True)
    n = mel.shape[1]
    melp = jnp.pad(mel, ((0, 0), (0, 32 * ((n - 1) // 32 + 1) - n), (0, 0)), mode="reflect")
    ref_hidden = jax.jit(jax_r.apply)(r_vars, melp.astype(BF16))[:, :n]
    rm = RMVPE(port_r)
    got_hidden = rm.mel2hidden(rm.mel(t(audio)), torch.bfloat16)
    assert got_hidden.dtype == torch.float32 and ref_hidden.dtype == jnp.float32
    assert_parity(got_hidden.numpy(), np.asarray(ref_hidden), "salience, bf16 trunk")

    ref_pipe._rmvpe_model = jax_r
    ref = np.asarray(ref_pipe._build_f0_program()(r_vars, jnp.asarray(audio), jnp.float32(0.0),
                                                   jnp.float32(0.0)))
    got = port_pipe.f0(t(audio), 0.0, 0.0, torch.bfloat16).numpy()
    voiced = (got > 0) & (ref > 0)
    assert np.array_equal(got > 0, ref > 0) and voiced.mean() > 0.5
    cents = 1200 * np.abs(np.log2(got[voiced] / ref[voiced]))
    assert cents.max() < 1.0, f"max |cents| {cents.max()}"


@torch.no_grad()
def test_staged_path_unchanged_under_bf16(monkeypatch):
    """The staged path (`voice_conversion`, here pm pitch) ignores the
    policy, as the reference's `_hubert_jit` / `_infer_jit`: bit-equal
    under RVC_TPU_BF16=1 and 0, and no bf16 copy is made."""
    pipe = _pipelines()[1]
    clip = _clip()
    out = {}
    for v in ("1", "0"):
        monkeypatch.setenv("RVC_TPU_BF16", v)
        out[v] = pipe.pipeline(clip, sid=1, f0_method="pm")
    np.testing.assert_array_equal(out["1"], out["0"])
    assert pipe._bf16 is None


@torch.no_grad()
def test_refresh_drops_copies_made_from_old_weights(monkeypatch):
    """Under RVC_TPU_BF16=1 the pipeline converts on bf16 copies made at its
    first bf16 conversion; after the float32 synthesizer's weights change in
    place it keeps converting with the old ones (bit-equal to the first
    output) until `refresh`, after which it equals a fresh pipeline on the
    new weights. The float32 path follows the change without it (the
    ResBlocks' kept weights are keyed on the parameters' versions)."""
    monkeypatch.setenv("RVC_TPU_BF16", "1")
    port_s, port_h, port_r = synthesizers(ups_gain=UPS_GAIN)[0], huberts()[0], rmvpes()[0]
    pipe = Pipeline(SR, port_s, port_h, port_r)
    clip = _clip()
    first = pipe.pipeline(clip, sid=1)
    monkeypatch.setenv("RVC_TPU_BF16", "0")
    f32_first = pipe.pipeline(clip, sid=1)
    for p in list(port_s.dec.resblocks.parameters()) + list(port_s.enc_p.parameters()):
        p.mul_(1.25)
    f32_after = pipe.pipeline(clip, sid=1)
    assert not np.array_equal(f32_after, f32_first)
    np.testing.assert_array_equal(f32_after, Pipeline(SR, port_s, port_h, port_r)
                                  .pipeline(clip, sid=1))
    monkeypatch.setenv("RVC_TPU_BF16", "1")
    np.testing.assert_array_equal(pipe.pipeline(clip, sid=1), first)
    pipe.refresh()
    assert pipe._bf16 is None
    fresh = Pipeline(SR, port_s, port_h, port_r).pipeline(clip, sid=1)
    got = pipe.pipeline(clip, sid=1)
    assert not np.array_equal(got, first)
    np.testing.assert_array_equal(got, fresh)
