"""The trainer (counterpart of `rvc_tpu/train/trainer.py`).

The epoch loop over the bucketed loader, warmup (non-adversarial) epochs,
pretrained G/D loading with a per-module coverage check, checkpoint save
and resume, the overtraining stop, best / latest / per-epoch checkpoints,
JSONL and tracker logging, eval audio at save epochs, a SIGTERM stop after
the epoch, and the inference export (enc_q stripped).

Checkpoints: G and D parameters as `.safetensors` under `rvc_tpu`'s flat
parameter paths (`{name}_G.safetensors`, `{name}_D.safetensors`; enc_q
included), so either package resumes the other's, with
`{name}_state.json` (epoch, step, best loss, config). The optimizer state
is the port's own file, `{name}_opt.pt` (`torch.save`; `rvc_tpu` keeps
its own in orbax), in one format for any number of ranks: whole moments.

With a mesh (the process group's ranks, `parallel.mesh.make_mesh(n_model=
...)`), each rank trains on its data index's rows of every global step
(`parallel.train.DataParallelTrainStep`) with ZeRO-1 moments
(`ShardedAdamW`); with n_model > 1 G and D are laid out over the model
axis by the reference's rules at `tp_min_size` (`parallel.tp.
shard_modules`), each rank holding its shards. The ranks of a data group
are broadcast from its first before the first step and after a load or
resume. Rank 0 alone writes the log, the tracker, the checkpoints, the
eval audio and the export; every rank enters each save and export (the
moments and the shards are gathered whole) and renders the eval audio
under tensor parallelism. The epoch's metrics are the global batch's, so
"best" saves and the overtraining stop agree on every rank, and the
SIGTERM stop is all-reduced.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from rvc_tpu_torch.configs import RVCConfig, config_to_dict
from rvc_tpu_torch.models.discriminators import build_discriminator
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.monitoring.tracker import NullTracker, RollingMean, create_tracker
from rvc_tpu_torch.ops.stft import mel_spectrogram
from rvc_tpu_torch.parallel import tp
from rvc_tpu_torch.parallel.mesh import MIN_SIZE, Axis, Mesh
from rvc_tpu_torch.parallel.train import (DataParallelTrainStep, ShardedAdamW,
                                          broadcast_modules)
from rvc_tpu_torch.train.data import DataLoader
from rvc_tpu_torch.train.overtraining import OvertrainingDetector
from rvc_tpu_torch.train.optim import AdamW
from rvc_tpu_torch.train.train_step import Batch, TrainStep, make_optimizers
from rvc_tpu_torch.utils import weights as W
from rvc_tpu_torch.utils.audio import save_wav
from rvc_tpu_torch.utils.device import resolve_device, use_fp32_numerics

LOG_EVERY_STEPS = 5   # tracker cadence of the rolling means


def _merge(dst: dict, src: dict, what: str, path: str) -> None:
    """Copy each tensor of src whose key and shape dst has into dst; raise
    when fewer than half of src's tensors match: such weights belong to
    another architecture or vocoder, and training would start from the
    random init while the user believes they are finetuning."""
    matched = 0
    for k, v in src.items():
        if k in dst and tuple(dst[k].shape) == tuple(v.shape):
            dst[k] = v.to(dst[k].dtype)
            matched += 1
    if src and matched < len(src) // 2:
        raise ValueError(f"pretrained {what} {path!r} matched only {matched}/{len(src)} "
                         f"tensors of this model: wrong architecture/vocoder for these "
                         f"weights (pass matching pretrains or drop the flag)")


class RVCTrainer:
    """device: None trains on the card (and raises when there is none);
    "cpu" runs the kernels' plain versions on the host. mesh: the process
    group's ranks (one a card) as a (data, model) mesh, each calling with
    its own loader (`DataLoader(num_hosts, host_id)` by data index) and
    device; tp_min_size: the sharding rules' min_size (the reference's
    1 << 16)."""

    def __init__(self, cfg: RVCConfig, train_loader: DataLoader,
                 checkpoint_dir: str = "checkpoints",
                 seed: int = 1234, use_overtraining_detector: bool = False,
                 overtraining_threshold: int = 50, overtraining_patience: int = 10,
                 freeze_encoder: bool = False, save_only_latest: bool = False,
                 save_every_weights: bool = False, cache_data_on_device: bool = False,
                 model_name: str = "model", tracker=None, use_aim: bool = False, *,
                 mesh: Optional[Mesh] = None, device=None, tp_min_size: int = MIN_SIZE):
        self.device = resolve_device(device)
        use_fp32_numerics()
        if mesh is not None and not (dist.is_initialized()
                                     and mesh.size == dist.get_world_size()):
            raise ValueError(f"a mesh of {mesh.size} ranks needs a process group of as many "
                             f"(`parallel.distributed.initialize`)")
        self.mesh = mesh
        self._is_main = mesh is None or dist.get_rank() == 0
        self._synced = mesh is None
        self.data_axis, self.model_axis = Axis(), Axis()
        if mesh is not None:
            from rvc_tpu_torch.parallel.distributed import rank_axes

            self.data_axis, self.model_axis = rank_axes(mesh)
        self.cfg = cfg
        self.train_loader = train_loader
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)
        self._steps_per_epoch = max(len(train_loader), 1)
        # init on the host from the seed, so every device gets the same weights
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net_g = build_synthesizer(cfg, training=True)
            net_d = build_discriminator(cfg)
        self.tp_kinds: Dict[str, str] = {}     # the sharded parameters: "pair" / "gathered"
        if self.model_axis.size > 1:
            self.tp_kinds = tp.shard_modules(net_g, net_d, self.model_axis, tp_min_size)
        self.net_g, self.net_d = net_g.to(self.device), net_d.to(self.device)
        self.g_opt, self.d_opt = make_optimizers(
            cfg, self.net_g, self.net_d, self._steps_per_epoch,
            optimizer=AdamW if mesh is None else functools.partial(
                ShardedAdamW, data=self.data_axis, model=self.model_axis,
                min_size=tp_min_size))
        # every draw of a step (the posterior's eps, the segment starts, the
        # decoder's noise) comes from this generator, on the device
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.freeze_encoder = freeze_encoder
        self._steps = {}
        self.detector = (OvertrainingDetector(threshold=overtraining_threshold,
                                              patience=overtraining_patience)
                         if use_overtraining_detector else None)
        self.eval_batch: Optional[Batch] = None  # set to render reference audio
        self.epoch = 0
        self.step = 0
        self.best_loss = float("inf")
        self._log_path = os.path.join(checkpoint_dir, "train_log.jsonl")
        self.save_only_latest = save_only_latest
        self.save_every_weights = save_every_weights
        self.cache_data_on_device = cache_data_on_device
        self.model_name = model_name
        self._device_batches = None
        self.tracker = tracker or (create_tracker(checkpoint_dir, model_name, use_aim=use_aim)
                                   if self._is_main else NullTracker())
        self.tracker.log_params(config_to_dict(cfg))
        self._rolling = RollingMean(50)
        self._preempt = False

    # ------------------------------------------------------------------
    def step_fn(self, adversarial: bool) -> TrainStep:
        """The step; with a mesh the ranks of each data group are made equal
        first where a load may have parted them."""
        if not self._synced:
            if self.data_axis.size > 1:
                broadcast_modules(self.net_g, self.net_d, group=self.data_axis.group,
                                  src=self.mesh.members[self.model_axis.index])
            self._synced = True
        if adversarial not in self._steps:
            kw = ({} if self.mesh is None
                  else dict(data=self.data_axis, model=self.model_axis))
            cls = TrainStep if self.mesh is None else DataParallelTrainStep
            self._steps[adversarial] = cls(
                self.cfg, self.net_g, self.net_d, self.g_opt, self.d_opt,
                adversarial=adversarial, freeze_encoder=self.freeze_encoder, **kw)
        return self._steps[adversarial]

    def whole_state(self, net: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """The network's whole state dict (under tensor parallelism gathered
        over the model group: every rank of it calls)."""
        if self.model_axis.size > 1:
            return tp.gather_state_dict(net, self.model_axis)
        return net.state_dict()

    def _load_whole(self, net: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
        if self.model_axis.size > 1:
            tp.scatter_state_dict(net, state, self.model_axis)
        else:
            net.load_state_dict(state)

    @torch.inference_mode()
    def render_eval_audio(self, name: Optional[str] = None) -> Optional[str]:
        """The eval batch through the current generator (no noise) to a wav,
        logged with its log-mel image to the tracker (rank 0; under tensor
        parallelism every rank runs the generator)."""
        if self.eval_batch is None or not (self._is_main or self.model_axis.size > 1):
            return None
        b = self.eval_batch.to(self.device)
        wave, _ = self.net_g.infer(b.phone, b.phone_lengths, b.pitch, b.pitchf, b.sid)
        if not self._is_main:
            return None
        audio = wave[0, :, 0].float().cpu().numpy()
        sr = self.cfg.data.sample_rate
        path = os.path.join(self.checkpoint_dir, f"{name or f'epoch_{self.epoch:04d}'}_eval.wav")
        save_wav(path, audio, sr)
        self.tracker.log_audio("eval/audio", audio, sr, self.step)
        d = self.cfg.data
        mel = mel_spectrogram(torch.from_numpy(audio)[None], d.filter_length, d.n_mel_channels,
                              sr, d.hop_length, d.win_length, d.mel_fmin, d.mel_fmax)[0]
        self.tracker.log_spectrogram("eval/mel", mel.numpy(), self.step)
        return path

    # ------------------------------------------------------------------
    def load_pretrained(self, g_path: Optional[str] = None,
                        d_path: Optional[str] = None) -> None:
        """Load G and / or D from an upstream `.pth` or a native
        `.safetensors` over the current weights (tensors the file lacks keep
        theirs). The coverage check runs per generator module: a
        wrong-vocoder pretrain still matches enc_p and the flow."""
        if g_path and os.path.exists(g_path):
            if g_path.endswith(".safetensors"):
                src = W.synthesizer_from_jax(W.load_params(g_path), enc_q=True)
            else:
                src = W.synthesizer_from_pth(W.load_torch_checkpoint(g_path), enc_q=True)
            state = self.whole_state(self.net_g)
            for module in sorted({k.split(".")[0] for k in src}):
                _merge(state, {k: v for k, v in src.items() if k.split(".")[0] == module},
                       f"generator {module!r}", g_path)
            self._load_whole(self.net_g, state)
        if d_path and os.path.exists(d_path):
            if d_path.endswith(".safetensors"):
                src = W.discriminator_from_jax(W.load_params(d_path))
            else:
                src = W.discriminator_from_pth(W.load_torch_checkpoint(d_path))
            state = self.whole_state(self.net_d)
            _merge(state, src, "discriminator", d_path)
            self._load_whole(self.net_d, state)
        self._synced = self.mesh is None

    def save_checkpoint(self, name: Optional[str] = None, full_state: bool = True) -> str:
        """G and D as `.safetensors` in `rvc_tpu`'s paths, the state JSON,
        and with full_state the optimizers' moments and counts. With a mesh
        every rank calls it (the moments are gathered); rank 0 writes."""
        name = name or f"epoch_{self.epoch:04d}"
        gp = os.path.join(self.checkpoint_dir, f"{name}_G.safetensors")
        opt = ({"g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict()}
               if full_state else None)
        g_state, d_state = self.whole_state(self.net_g), self.whole_state(self.net_d)
        if not self._is_main:
            return gp
        W.save_params(W.synthesizer_to_jax(g_state), gp)
        W.save_params(W.discriminator_to_jax(d_state),
                      os.path.join(self.checkpoint_dir, f"{name}_D.safetensors"))
        if opt is not None:
            torch.save(opt, os.path.join(self.checkpoint_dir, f"{name}_opt.pt"))
        meta = dict(epoch=self.epoch, step=self.step, best_loss=self.best_loss,
                    config=config_to_dict(self.cfg))
        with open(os.path.join(self.checkpoint_dir, f"{name}_state.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return gp

    def resume(self, name: str) -> None:
        """Parameters (from either package), epoch, step and best loss, and
        the port's optimizer state when the checkpoint has it (with a mesh,
        each rank keeps its slices)."""
        root = os.path.join(self.checkpoint_dir, name)
        self.load_pretrained(root + "_G.safetensors", root + "_D.safetensors")
        if os.path.exists(root + "_state.json"):
            with open(root + "_state.json") as f:
                meta = json.load(f)
            self.epoch = meta.get("epoch", 0)
            self.step = meta.get("step", 0)
            self.best_loss = meta.get("best_loss", float("inf"))
        if os.path.exists(root + "_opt.pt"):
            state = torch.load(root + "_opt.pt", map_location="cpu", weights_only=True)
            self.g_opt.load_state_dict(state["g_opt"])
            self.d_opt.load_state_dict(state["d_opt"])

    def export_inference_model(self, path: str) -> str:
        """The inference weights, enc_q stripped: a `.pth` path writes the
        upstream inference checkpoint (`export_pth`), any other the native
        `.safetensors` with its `.json` config. Every rank calls it (the
        shards are gathered); rank 0 writes."""
        state = self.whole_state(self.net_g)
        if not self._is_main:
            return path
        state = {k: v for k, v in state.items() if not k.startswith("enc_q.")}
        if path.endswith(".pth"):
            return W.export_pth(state, self.cfg, path, pitch_guidance=self.cfg.model.use_f0,
                                name=self.model_name)
        W.save_params(W.synthesizer_to_jax(state), path, config=config_to_dict(self.cfg))
        return path

    # ------------------------------------------------------------------
    def _batches(self):
        """The epoch's batches on the device; with cache_data_on_device the
        first epoch's stay there and later epochs only permute them."""
        if not self.cache_data_on_device:
            self.train_loader.set_epoch(self.epoch)
            for b in self.train_loader:
                yield b.to(self.device, non_blocking=True)
            return
        if self._device_batches is None:
            self.train_loader.set_epoch(0)
            self._device_batches = [b.to(self.device) for b in self.train_loader]
        for i in np.random.default_rng(self.epoch).permutation(len(self._device_batches)):
            yield self._device_batches[i]

    def train_epoch(self, adversarial: bool = True) -> dict:
        """One epoch; returns the metrics' means and the batch count."""
        step_fn = self.step_fn(adversarial)
        agg, n = {}, 0
        for batch in self._batches():
            metrics = step_fn(batch, self.generator)
            self.step += 1
            n += 1
            host = {k: float(v) for k, v in metrics.items()}
            for k, v in host.items():
                agg[k] = agg.get(k, 0.0) + v
            smoothed = self._rolling.update(host)
            if n % LOG_EVERY_STEPS == 0 and self._is_main:
                self.tracker.log_metrics(smoothed, self.step)
        return {k: v / max(n, 1) for k, v in agg.items()} | {"batches": n}

    def _install_preempt_handler(self):
        """SIGTERM asks for a graceful stop: finish the epoch, checkpoint,
        return. Returns the previous handler (None where none can be
        installed, as in a thread other than the main one)."""
        import signal

        self._preempt = False

        def handler(signum, frame):
            self._preempt = True

        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None

    def _preempt_requested(self) -> bool:
        """The SIGTERM flag of any rank: the signal may reach one rank only,
        and a stop on that rank alone would hang the others in the next
        step's collectives."""
        if self.mesh is None:
            return self._preempt
        flag = torch.tensor(int(self._preempt), device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag)

    def train(self, epochs: int, save_every: int = 10,
              warmup_epochs: Optional[int] = None) -> dict:
        warmup = self.cfg.train.warmup_epochs if warmup_epochs is None else warmup_epochs
        history = []
        prev_handler = self._install_preempt_handler()
        try:
            self._train_epochs(epochs, warmup, save_every, history)
        finally:
            if prev_handler is not None:
                import signal

                signal.signal(signal.SIGTERM, prev_handler)
        self.save_checkpoint("last")
        self.tracker.close()
        return {"epochs_run": len(history), "history": history,
                "best_loss": self.best_loss, "preempted": self._preempt}

    def _train_epochs(self, epochs: int, warmup: int, save_every: int, history: list) -> None:
        for _ in range(epochs):
            t0 = time.time()
            adversarial = self.epoch >= warmup
            metrics = self.train_epoch(adversarial)
            metrics |= {"epoch": self.epoch, "adversarial": adversarial,
                        "seconds": round(time.time() - t0, 2)}
            history.append(metrics)
            if self._is_main:
                with open(self._log_path, "a") as f:
                    f.write(json.dumps(metrics) + "\n")
                self.tracker.log_metrics({k: v for k, v in metrics.items()
                                          if isinstance(v, (int, float)) and np.isfinite(v)},
                                         self.step, context={"subset": "epoch"})
            g_total = metrics.get("loss_g_total", float("inf"))
            if g_total < self.best_loss:
                self.best_loss = g_total
                self.save_checkpoint("best")
            if self.detector is not None and self.detector.update(self.epoch, g_total):
                self.save_checkpoint()
                break
            if self._preempt_requested():
                # the epoch counts as done, as on the regular save path:
                # a resume continues with the next one
                self._preempt = True
                done = self.epoch
                self.epoch += 1
                self.save_checkpoint(f"preempt_epoch_{done:04d}")
                if self._is_main:
                    print(f"preemption requested: checkpointed after epoch {done}, stopping "
                          f"(resume with trainer.resume('preempt_epoch_{done:04d}'))")
                break
            self.epoch += 1
            if self.epoch % save_every == 0:
                self.save_checkpoint("latest" if self.save_only_latest else None)
                if self.save_every_weights:
                    self.export_inference_model(os.path.join(
                        self.checkpoint_dir, f"{self.model_name}_{self.epoch}e.safetensors"))
                self.render_eval_audio()
