"""Training's host copies, feature extraction, the trainer's checkpoints and
export, and the `preprocess` / `extract` / `train` / `index` subcommands of
the port, on the CPU, against the JAX package where it has the same piece.

Bars: the preprocessing copies (slicer, preprocessor, dataset builder)
equal to `rvc_tpu`'s bit for bit; features on two 1 s clips against
`rvc_tpu`'s extractor with the same small HuBERT and RMVPE (f0 rtol 1e-4
on frames voiced on both, the same voicing, ROADMAP's module bar for the
features, spectrogram atol 1e-4); a JAX-written checkpoint resumes with
equal parameters; a port-trained `.pth` converts in both packages at
waveform corr > 0.995 (noise off, the decoder's upsampling scaled by 20
as in `torch_port_helpers.synthesizers`)."""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rvc_tpu import api as jax_api
from rvc_tpu.models.hubert import HubertConfig as JaxHubertConfig
from rvc_tpu.models.hubert import HubertModel as JaxHubert
from rvc_tpu.models.rmvpe import E2E as JaxE2E
from rvc_tpu.models.rmvpe import RMVPE as JaxRMVPE
from rvc_tpu.models.synthesizer import build_synthesizer as jax_build
from rvc_tpu.pipelines.offline import Pipeline as JaxPipeline
from rvc_tpu.pitch import PitchExtractor as JaxPitchExtractor
from rvc_tpu.preprocess import AudioPreprocessor as JaxPreprocessor
from rvc_tpu.preprocess import DatasetBuilder as JaxBuilder
from rvc_tpu.preprocess import FeatureExtractor as JaxFeatures
from rvc_tpu.preprocess import Slicer as JaxSlicer
from rvc_tpu.utils import weights as W
from rvc_tpu_torch import api as port_api
from rvc_tpu_torch.cli import main
from rvc_tpu_torch.configs import get_config as port_get_config
from rvc_tpu_torch.models.hubert import HubertConfig, HubertModel
from rvc_tpu_torch.models.rmvpe import RMVPE
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.monitoring import NullTracker
from rvc_tpu_torch.pipelines.offline import Pipeline
from rvc_tpu_torch.pitch import PitchExtractor
from rvc_tpu_torch.preprocess import AudioPreprocessor, DatasetBuilder, FeatureExtractor, Slicer
from rvc_tpu_torch.train.data import DataLoader, RVCDataset
from rvc_tpu_torch.train.trainer import RVCTrainer
from rvc_tpu_torch.utils import audio as audio_utils
from torch_port_helpers import (
    SMALL_RMVPE,
    SMALL_SYNTH_ARGS,
    assert_parity,
    numpy_state,
    rmvpes,
    train_configs,
    train_pair,
)

# a narrow v2 model: HuBERT's 768-wide features, the rate's own STFT sizes
V2_ARGS = {k: v for k, v in SMALL_SYNTH_ARGS.items()
           if k not in ("model_text_enc_hidden_dim", "data_filter_length")}
# HuBERT 768 wide (a v2 model's features) but one narrow layer
WIDE_HUBERT = dict(hidden_size=768, num_hidden_layers=1, num_attention_heads=4,
                   intermediate_size=64, conv_dim=32, classifier_proj_size=768)
TINY_TRAIN = json.dumps({"model_spk_embed_dim": 2, "model_n_layers": 1,
                         "model_upsample_initial_channel": 64, "train_segment_size": 3840})


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_embedders(tmp_path, monkeypatch):
    """No contentvec on disk: HuBERT is the seeded random init. The test's
    files (checkpoints of hundreds of MB) go when it ends."""
    monkeypatch.setenv("RVC_TPU_MODELS_DIR", str(tmp_path / "models"))
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def small_discriminator(monkeypatch):
    """The trainer's D cut to S and one period (13.9 M parameters, not the
    v2 D's 71.4 M) where the test saves checkpoints and no D is compared."""
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from rvc_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "build_discriminator",
                        lambda cfg: MultiPeriodDiscriminator(periods=(2,)))


def _utterance(seconds, sr, f0, seed, gaps=()):
    """A harmonic tone with noise, silent over the (start, end) gaps in s."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t))) / sr
    y = 0.4 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.01 * rng.standard_normal(len(t))
    for a, b in gaps:
        y[int(a * sr): int(b * sr)] = 1e-4 * rng.standard_normal(int(b * sr) - int(a * sr))
    return y.astype(np.float32)


def _dataset(root, sr=32000, seconds=5.0):
    """Two speakers (folders 0 and 1), one recording each, with a silence."""
    for sid, f0 in ((0, 140.0), (1, 210.0)):
        (root / str(sid)).mkdir(parents=True)
        audio_utils.save_wav(str(root / str(sid) / f"take{sid}.wav"),
                             _utterance(seconds, sr, f0, sid, gaps=((2.0, 2.6),)), sr)
    return root


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_slicer_equals_jax():
    y = _utterance(6.0, 32000, 150.0, 3, gaps=((1.0, 1.8), (3.5, 4.4)))
    kw = dict(sr=32000, threshold=-42, min_length=1500, min_interval=400, hop_size=15,
              max_sil_kept=500)
    got, ref = Slicer(**kw).slice(y), JaxSlicer(**kw).slice(y)
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cut", ["Automatic", "Simple", "Skip"])
def test_preprocess_outputs_equal_jax(tmp_path, cut):
    data = _dataset(tmp_path / "data")
    n_port = AudioPreprocessor(str(tmp_path / "port"), 32000).process_directory(str(data), cut)
    n_jax = JaxPreprocessor(str(tmp_path / "jax"), 32000).process_directory(str(data), cut)
    assert n_port == n_jax > 0
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") and len(files) == 2 * n_port
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def _small_extractors(exp_port, exp_jax, cfg_port, cfg_jax):
    """(port, JAX) FeatureExtractor with the same small HuBERT and RMVPE."""
    torch.manual_seed(1)
    hubert = HubertModel(HubertConfig(**WIDE_HUBERT)).eval()
    h_params = W.convert_hubert_state_dict(numpy_state(hubert))
    port_r, jax_r, r_vars = rmvpes()
    port = FeatureExtractor(exp_port, cfg_port, hubert=hubert, device="cpu",
                            pitch=PitchExtractor("rmvpe", rmvpe=RMVPE(port_r)))
    ref = JaxFeatures(exp_jax, cfg_jax, hubert=JaxHubert(JaxHubertConfig(**WIDE_HUBERT)),
                      hubert_variables={"params": h_params}, f0_method="pm")
    jax_rmvpe = JaxRMVPE(params=r_vars["params"], batch_stats=r_vars["batch_stats"])
    jax_rmvpe.model = JaxE2E(**SMALL_RMVPE)           # read when its jit traces
    ref.pitch = JaxPitchExtractor("rmvpe", model=jax_rmvpe)
    return port, ref


def _write_segments(exp, names_audio, sr):
    for d in ("sliced_audios", "sliced_audios_16k"):
        os.makedirs(os.path.join(exp, d), exist_ok=True)
    for name, a in names_audio:
        audio_utils.save_wav(os.path.join(exp, "sliced_audios", name), a, sr, "FLOAT")
        audio_utils.save_wav(os.path.join(exp, "sliced_audios_16k", name),
                             audio_utils.resample(a, sr, 16000), 16000, "FLOAT")


def test_feature_extractor_and_dataset_builder_against_jax(tmp_path):
    """Two 1 s clips of one length: one batched call each of HuBERT, RMVPE
    and the spectrogram; then the dataset rows, filelists and mute rows."""
    jcfg, cfg = train_configs()
    sr = cfg.data.sample_rate
    clips = [(f"{sid}_0_0.wav", _utterance(1.0, sr, f0, sid))
             for sid, f0 in ((0, 150.0), (1, 230.0))]
    exp_port, exp_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    for exp in (exp_port, exp_jax):
        _write_segments(exp, clips, sr)
    port, ref = _small_extractors(exp_port, exp_jax, cfg, jcfg)
    assert port.process_all(batch_size=8) == ref.process_all(batch_size=8) == 2
    for name, _ in clips:
        stem = name[:-4] + ".npy"
        load = lambda exp, d: np.load(os.path.join(exp, d, stem))
        f0, f0_ref = load(exp_port, "f0_voiced"), load(exp_jax, "f0_voiced")
        assert f0.shape == f0_ref.shape and (f0 > 0).any()
        np.testing.assert_array_equal(f0 > 0, f0_ref > 0)
        np.testing.assert_allclose(f0, f0_ref, rtol=1e-4)
        np.testing.assert_array_equal(load(exp_port, "f0"), load(exp_jax, "f0"))
        assert_parity(load(exp_port, "features"), load(exp_jax, "features"), "features")
        np.testing.assert_allclose(load(exp_port, "spec"), load(exp_jax, "spec"), atol=1e-4)

    rel = lambda rows, exp: [{k: (os.path.relpath(v, exp) if isinstance(v, str) else v)
                              for k, v in r.items()} for r in rows]
    builders = DatasetBuilder(exp_port, min_frames=50), JaxBuilder(exp_jax, min_frames=50)
    (tr, va), (tr_ref, va_ref) = (b.build() for b in builders)
    assert rel(tr, exp_port) == rel(tr_ref, exp_jax) and rel(va, exp_port) == rel(va_ref, exp_jax)
    mutes = builders[0].add_mutes(cfg, 2, feature_extractor=port)
    mutes_ref = builders[1].add_mutes(jcfg, 2, feature_extractor=ref)
    assert rel(mutes, exp_port) == rel(mutes_ref, exp_jax) and len(mutes) == 4
    for f in ("mute.wav", "mute_16k.wav"):
        assert ((tmp_path / "port" / "mute" / f).read_bytes()
                == (tmp_path / "jax" / "mute" / f).read_bytes())
    for b, exp, rows in ((builders[0], exp_port, tr + mutes), (builders[1], exp_jax, tr_ref)):
        b.write_filelist(os.path.join(exp, "list.txt"), rows)
    assert [rel([r], exp_port)[0] for r in DatasetBuilder.read_filelist(
        os.path.join(exp_port, "list.txt"))][:len(tr)] == rel(
        JaxBuilder.read_filelist(os.path.join(exp_jax, "list.txt")), exp_jax)


def test_cli_preprocess_extract_train_index(tmp_path, capsys, small_discriminator):
    """The subcommands end to end on the CPU: full-size random HuBERT and
    RMVPE features, the JAX tests' tiny model for 1 epoch, the exported
    model and its index loading into `RVC`."""
    data = _dataset(tmp_path / "data", seconds=3.0)
    logs = str(tmp_path / "logs")
    common = ["--model_name", "m", "--logs_dir", logs]
    main(["preprocess", *common, "--dataset_path", str(data), "--sample_rate", "32000",
          "--cpu_cores", "1"])
    main(["extract", *common, "--sample_rate", "32000", "--device", "cpu", "--gpu", "0"])
    exp = os.path.join(logs, "m")
    info = json.load(open(os.path.join(exp, "model_info.json")))
    assert info["speakers_id"] == 2 and info["n_train"] >= 4
    main(["train", *common, "--sample_rate", "32000", "--total_epoch", "1", "--batch_size", "2",
          "--save_every_epoch", "1", "--config_overrides", TINY_TRAIN, "--device", "cpu",
          "--pretrained", "--gpu", "0"])
    out = capsys.readouterr()
    assert "training from scratch" in out.err
    summary = json.loads(out.out.strip().splitlines()[-1])
    assert summary["epochs_run"] == 1 and np.isfinite(summary["best_loss"])
    log = [json.loads(x) for x in open(os.path.join(exp, "ckpt", "train_log.jsonl"))]
    assert log[0]["batches"] >= 1 and all(np.isfinite(v) for k, v in log[0].items()
                                          if k.startswith("loss"))
    for f in ("last_G.safetensors", "last_D.safetensors", "last_opt.pt", "last_state.json",
              "epoch_0001_G.safetensors"):
        assert os.path.exists(os.path.join(exp, "ckpt", f)), f
    main(["index", *common, "--device", "cpu"])
    rvc = port_api.RVC(model_path=summary["model"], index_path=os.path.join(exp, "m.index"),
                       device="cpu")
    assert rvc.index.d == 768 and rvc.cfg.model.n_layers == 1


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """G and D written by the JAX package's `save_params` (its trainer's
    checkpoint format) with the state JSON: the port's trainer resumes
    them with equal parameters, epoch and step; the port's own save reads
    back in the JAX package as the same trees."""
    jcfg, cfg = train_configs()
    _, _, gp, dp = train_pair(6)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    W.save_params(gp, str(ckpt / "e5_G.safetensors"))
    W.save_params(dp, str(ckpt / "e5_D.safetensors"))
    (ckpt / "e5_state.json").write_text(json.dumps({"epoch": 5, "step": 40, "best_loss": 3.0}))
    loader = DataLoader(RVCDataset([], cfg.data.hop_length), 2)
    tr = RVCTrainer(cfg, loader, checkpoint_dir=str(ckpt), seed=7, tracker=NullTracker(),
                    device="cpu")
    tr.resume("e5")
    assert (tr.epoch, tr.step, tr.best_loss) == (5, 40, 3.0)
    for tree, net in ((gp, tr.net_g), (dp, tr.net_d)):
        ref = W.flatten_tree(tree)
        got = (W.flatten_tree(W.convert_synthesizer_state_dict(numpy_state(net)))
               if net is tr.net_g else
               W.flatten_tree(W.convert_discriminator_state_dict(numpy_state(net))))
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    tr.save_checkpoint("port")
    for suffix, tree in (("G", gp), ("D", dp)):
        back = W.flatten_tree(W.load_params(str(ckpt / f"port_{suffix}.safetensors")))
        ref = W.flatten_tree(tree)
        assert sorted(back) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


class _FakeDataset(RVCDataset):
    """In-memory rows (the JAX trainer test's), phone features 768 wide."""

    def __init__(self, n, T, cfg, seed=0):
        self.rows = [{"n_frames": T, "sid": i % 2} for i in range(n)]
        self.hop_length = cfg.data.hop_length
        rng = np.random.default_rng(seed)
        t = np.arange(T * self.hop_length) / cfg.data.sample_rate
        self._items = [dict(
            phone=rng.standard_normal((T, 768)).astype(np.float32),
            pitch=rng.integers(1, 255, T).astype(np.int64),
            pitchf=np.full(T, 180.0, np.float32),
            spec=np.abs(rng.standard_normal((T, cfg.data.spec_channels))).astype(np.float32),
            wave=(0.3 * np.sin(2 * np.pi * 180.0 * t)).astype(np.float32),
            sid=i % 2, length=T) for i in range(n)]

    def __getitem__(self, i):
        return self._items[i]


def test_exported_pth_converts_in_both_packages(tmp_path, small_discriminator):
    """Two steps of the port's trainer on a narrow v2 model, exported as an
    upstream `.pth`; each package loads it with its own loader and converts
    the same clip through its pipeline (the same small HuBERT and RMVPE)."""
    cfg = port_get_config(32000, **V2_ARGS)
    loader = DataLoader(_FakeDataset(4, 60, cfg), 2, drop_last=True)
    tr = RVCTrainer(cfg, loader, checkpoint_dir=str(tmp_path / "ckpt"), seed=3,
                    tracker=NullTracker(), device="cpu")
    with torch.no_grad():
        for up in tr.net_g.dec.ups:
            up.weight.mul_(20.0)
    assert tr.train_epoch()["batches"] == 2
    path = tr.export_inference_model(str(tmp_path / "voice.pth"))

    torch.manual_seed(1)
    hubert = HubertModel(HubertConfig(**WIDE_HUBERT)).eval()
    h_params = W.convert_hubert_state_dict(numpy_state(hubert))
    port_r, jax_r, r_vars = rmvpes()
    pcfg, state = port_api._load_model(path, None)
    synth = build_synthesizer(pcfg).eval()
    synth.load_state_dict(state, strict=True)
    port = Pipeline(32000, synth, hubert, port_r)
    jcfg, j_params = jax_api.RVC._load_model(object.__new__(jax_api.RVC), path, None, 0)
    ref = JaxPipeline(
        tgt_sr=32000, synthesizer=jax_build(jcfg), synth_variables={"params": j_params},
        hubert=JaxHubert(JaxHubertConfig(**WIDE_HUBERT)), hubert_variables={"params": h_params},
        pitch_extractor=JaxPitchExtractor(
            "rmvpe", model=SimpleNamespace(model=jax_r, variables=r_vars)))
    clip = _utterance(1.0, 16000, 170.0, 9)
    os.environ["RVC_TPU_SOURCE_NOISE"] = "0"
    try:
        got = port.pipeline(clip, sid=1)
        want = ref.pipeline(clip, sid=1)
    finally:
        del os.environ["RVC_TPU_SOURCE_NOISE"]
    assert got.shape == want.shape and np.isfinite(got).all()
    corr = np.corrcoef(got, want)[0, 1]
    assert corr > 0.995, corr


class _Preempting(_FakeDataset):
    """Sends the process SIGTERM when its first row loads (mid-epoch)."""

    def __getitem__(self, i):
        import signal

        if not getattr(self, "_sent", False):
            self._sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        return super().__getitem__(i)


def test_trainer_saving_options_preemption_and_pretrain_coverage(tmp_path,
                                                                small_discriminator):
    """save_only_latest, save_every_weights and cache_data_on_device over
    two epochs; a SIGTERM mid-epoch stops after that epoch with a
    checkpoint that resumes at the next; a pretrain of another vocoder
    fails the per-module coverage check."""
    cfg = port_get_config(32000, **V2_ARGS)
    ckpt = tmp_path / "ckpt"
    tr = RVCTrainer(cfg, DataLoader(_FakeDataset(2, 60, cfg), 2), checkpoint_dir=str(ckpt),
                    seed=1, save_only_latest=True, save_every_weights=True,
                    cache_data_on_device=True, model_name="v", device="cpu")
    result = tr.train(epochs=2, save_every=1)
    assert result["epochs_run"] == 2 and not result["preempted"]
    files = set(os.listdir(ckpt))
    assert {"latest_G.safetensors", "latest_opt.pt", "last_G.safetensors",
            "v_1e.safetensors", "v_2e.safetensors", "v_2e.json"} <= files
    assert not any(f.startswith("epoch_") for f in files)

    tr2 = RVCTrainer(cfg, DataLoader(_Preempting(2, 60, cfg), 2),
                     checkpoint_dir=str(tmp_path / "p"), seed=1, tracker=NullTracker(),
                     device="cpu")
    result = tr2.train(epochs=3, save_every=10)
    assert result["preempted"] and result["epochs_run"] == 1
    tr3 = RVCTrainer(cfg, DataLoader(_FakeDataset(2, 60, cfg), 2),
                     checkpoint_dir=str(tmp_path / "p"), seed=2, tracker=NullTracker(),
                     device="cpu")
    tr3.resume("preempt_epoch_0000")
    assert tr3.epoch == 1 and tr3.step == 1

    mrf = port_get_config(32000, **V2_ARGS, model_vocoder="MRF HiFi-GAN")
    other = RVCTrainer(mrf, DataLoader(_FakeDataset(2, 60, mrf), 2),
                       checkpoint_dir=str(tmp_path / "m"), seed=1, tracker=NullTracker(),
                       device="cpu")
    other.save_checkpoint("mrf")
    with pytest.raises(ValueError, match="generator 'dec'"):
        tr.load_pretrained(str(tmp_path / "m" / "mrf_G.safetensors"))
    tr.load_pretrained(d_path=str(tmp_path / "m" / "mrf_D.safetensors"))   # the same v2 D
