"""Command line of the port (counterpart of `rvc_tpu/cli.py`): the `infer`,
`batch_infer`, `serve`, `preprocess`, `extract`, `train`, `index`,
`audio_analyzer`, `convert`, `model_information`, `model_blender` and
`tensorboard` subcommands, with the reference's flag names and defaults,
plus `--device`.

    python -m rvc_tpu_torch.cli infer --input_path in.wav --output_path out.wav \\
        --model_path model.pth --index_path model.index

runs on the card; `--device cpu` runs the kernels' plain PyTorch versions
on the host. `--f0_method` takes rmvpe, crepe, crepe-tiny, fcpe, dio, pm,
harvest or hybrid[a+b+...]; `--f0_file` (one f0 per 10 ms frame, read with
`np.loadtxt`) replaces the extraction. `--split_audio`, `--clean_audio`,
`--formant_shifting` and `--post_process` (with the ten effects' flags) run
on the host around the conversion; `--export_format` MP3, FLAC, OGG or M4A
writes through soundfile or the ffmpeg binary and fails when neither can.

    python -m rvc_tpu_torch.cli serve --model_path model.pth --protocol tcp

streams 48 kHz audio through the model block by block (`realtime/`): the
length-prefixed float32 TCP protocol with one engine per connection, or
(`--protocol ws`, the default, with the `websockets` package) the
reference's ws-audio client protocol, with `--webui` the browser client.

    python -m rvc_tpu_torch.cli preprocess --model_name m --dataset_path data/
    python -m rvc_tpu_torch.cli extract --model_name m
    python -m rvc_tpu_torch.cli train --model_name m --total_epoch 300

make a voice model from a folder of recordings (speaker ids from numbered
subfolders) under `logs/m/`: sliced audio, then HuBERT features, RMVPE f0
and spectrograms on the card, then GAN training; `train` ends with
`logs/m/m.safetensors` (+ `.json`) for `infer`, and `--index_algorithm`
also builds `logs/m/m.index` (as `index` does). On a machine with several
cards `train` starts one rank a card itself (data parallel, ZeRO-1
moments); across machines run one process a card with `--coordinator
host:port --num_hosts N --host_id i` (`--batch_size` is each data index's).
`--mesh_model N` lays the ranks out as a (ranks / N, N) mesh: each group of
N ranks shares its rows and holds one model's tensor-parallel shards (the
reference's rules); with `--device cpu` and no coordinator `train` starts
N gloo ranks on the host.

    python -m rvc_tpu_torch.cli model_information --model_path m.pth
    python -m rvc_tpu_torch.cli model_blender --pth_path_1 a.pth --pth_path_2 b.pth
    python -m rvc_tpu_torch.cli convert --pth_path m.pth
    python -m rvc_tpu_torch.cli audio_analyzer --input_path in.wav
    python -m rvc_tpu_torch.cli tensorboard --logs_path logs

are host tools (`tools/model_tools.py`, `tools/plot_logs.py`): a model's
metadata, a blend of two models, an upstream `.pth` as `.safetensors`, an
audio file's levels and spectrum, and the training curves (tensorboard
where it is installed, else PNG plots of the JSONL logs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the post-processing effects (`realtime.fx.build_fx_chain`): on / off, then
# the values with their defaults
_FX_FLAGS = ("reverb", "pitch_shift", "limiter", "gain", "distortion", "chorus", "bitcrush",
             "clipping", "compressor", "delay")
_FX_VALUES = (
    ("pitch_shift_semitones", 0.0),
    ("reverb_room_size", 0.5), ("reverb_damping", 0.5),
    ("reverb_wet_level", 0.33), ("reverb_dry_level", 0.4),
    ("reverb_width", 1.0), ("reverb_freeze_mode", 0.0),
    ("limiter_threshold", -6.0), ("limiter_release", 50.0),
    ("gain_db", 0.0), ("distortion_gain", 25.0),
    ("chorus_rate", 1.0), ("chorus_depth", 0.25), ("chorus_delay", 7.0),
    ("chorus_feedback", 0.0), ("chorus_mix", 0.5),
    ("bitcrush_bit_depth", 8.0), ("clipping_threshold", 0.0),
    ("compressor_threshold", 0.0), ("compressor_ratio", 1.0),
    ("compressor_attack", 1.0), ("compressor_release", 100.0),
    ("delay_seconds", 0.5), ("delay_feedback", 0.0), ("delay_mix", 0.5),
)
_FX_KEYS = _FX_FLAGS + tuple(k for k, _ in _FX_VALUES)
_EMBEDDERS = ("contentvec", "chinese-hubert-base", "japanese-hubert-base", "korean-hubert-base",
              "custom")
_DEVICE_HELP = "'cpu' runs the plain PyTorch path on the host (default: the CUDA card)"


def _f0_method(value: str) -> str:
    """A pitch method, hybrid[a+b+...] included (`rvc_tpu/cli.py`'s type)."""
    from rvc_tpu_torch.pitch import PitchExtractor

    if value in PitchExtractor.METHODS or (value.startswith("hybrid[") and value.endswith("]")):
        return value
    raise argparse.ArgumentTypeError(
        f"invalid f0 method {value!r}: choose from {PitchExtractor.METHODS} or hybrid[a+b]")


def _add_infer_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--model_path", "--pth_path", dest="model_path", required=True)
    p.add_argument("--index_path", default=None)
    p.add_argument("--pitch", type=float, default=0)
    p.add_argument("--f0_method", default="rmvpe", type=_f0_method)
    p.add_argument("--index_rate", type=float, default=0.75)
    p.add_argument("--volume_envelope", type=float, default=1.0)
    p.add_argument("--protect", type=float, default=0.5)
    p.add_argument("--f0_autotune", action="store_true")
    p.add_argument("--f0_autotune_strength", type=float, default=1.0)
    p.add_argument("--f0_file", default=None,
                   help="text file with one f0 value per frame (overrides extraction)")
    p.add_argument("--proposed_pitch", action="store_true")
    p.add_argument("--proposed_pitch_threshold", type=float, default=155.0)
    p.add_argument("--sid", type=int, default=0)
    p.add_argument("--hubert_path", default=None)
    p.add_argument("--embedder_model", default="contentvec",
                   choices=_EMBEDDERS)
    p.add_argument("--embedder_model_custom", default=None,
                   help="checkpoint path when --embedder_model custom")
    p.add_argument("--hop_length", type=int, default=160,
                   help="crepe analysis hop in 16 kHz samples")
    p.add_argument("--split_audio", action="store_true")
    p.add_argument("--clean_audio", action="store_true")
    p.add_argument("--clean_strength", type=float, default=0.5)
    p.add_argument("--export_format", default="WAV",
                   choices=["WAV", "MP3", "FLAC", "OGG", "M4A"])
    p.add_argument("--formant_shifting", action="store_true")
    p.add_argument("--formant_qfrency", type=float, default=1.0)
    p.add_argument("--formant_timbre", type=float, default=1.0)
    p.add_argument("--post_process", action="store_true")
    for flag in _FX_FLAGS:
        p.add_argument(f"--{flag}", action="store_true")
    for flag, d in _FX_VALUES:
        p.add_argument(f"--{flag}", type=float, default=d)
    p.add_argument("--device", default=None, help=_DEVICE_HELP)


def _infer_kwargs(args: argparse.Namespace) -> dict:
    input_f0 = None
    if args.f0_file:
        import numpy as np

        input_f0 = np.loadtxt(args.f0_file, dtype=np.float32).ravel()
    return dict(sid=args.sid, pitch=args.pitch, f0_method=args.f0_method,
                index_rate=args.index_rate, volume_envelope=args.volume_envelope,
                protect=args.protect, f0_autotune=args.f0_autotune,
                f0_autotune_strength=args.f0_autotune_strength, input_f0=input_f0,
                proposed_pitch=args.proposed_pitch,
                proposed_pitch_threshold=args.proposed_pitch_threshold,
                split_audio=args.split_audio, clean_audio=args.clean_audio,
                clean_strength=args.clean_strength, formant_shifting=args.formant_shifting,
                formant_qfrency=args.formant_qfrency, formant_timbre=args.formant_timbre,
                post_process=args.post_process, export_format=args.export_format,
                f0_hop_length=args.hop_length, **{k: getattr(args, k) for k in _FX_KEYS})


def _load_rvc(args: argparse.Namespace):
    from rvc_tpu_torch.api import RVC

    return RVC(model_path=args.model_path, hubert_path=args.hubert_path,
               index_path=args.index_path, embedder_model=args.embedder_model,
               embedder_model_custom=args.embedder_model_custom, device=args.device)


def cmd_infer(args: argparse.Namespace) -> None:
    out = _load_rvc(args).infer_file(args.input_path, args.output_path, **_infer_kwargs(args))
    print(f"wrote {out}")


def cmd_batch_infer(args: argparse.Namespace) -> None:
    rvc = _load_rvc(args)
    os.makedirs(args.output_folder, exist_ok=True)
    exts = (".wav", ".flac", ".mp3", ".ogg")
    files = [f for f in sorted(os.listdir(args.input_folder)) if f.lower().endswith(exts)]
    for f in files:
        out = os.path.join(args.output_folder, os.path.splitext(f)[0] + "_output.wav")
        out = rvc.infer_file(os.path.join(args.input_folder, f), out, **_infer_kwargs(args))
        print(f"wrote {out}")
    print(f"{len(files)} files converted")


def cmd_serve(args: argparse.Namespace) -> None:
    """Start a realtime conversion server (`rvc_tpu/cli.py:466-507`)."""
    import asyncio

    rvc = _load_rvc(args)
    if args.protocol == "ws":
        from rvc_tpu_torch.realtime.server import RealtimeWebSocketServer

        server = RealtimeWebSocketServer(rvc=rvc, host=args.host, port=args.port)
        if args.webui:
            # browser client app: mic -> ws -> playback with session controls
            from rvc_tpu_torch.realtime.webui import WebUIServer

            ui = WebUIServer(host=args.host, port=args.webui_port,
                             ws_url=f"ws://{args.host}:{args.port}")
            ui.serve_in_thread()
            print(f"web client on http://{args.host}:{args.webui_port}")
    else:
        from rvc_tpu_torch.realtime.core import VoiceChanger
        from rvc_tpu_torch.realtime.server import RealtimeSocketServer

        # per-connection engines: SOLA/pitch state is per-stream, so a
        # shared VoiceChanger would corrupt concurrent TCP clients
        def vc_factory():
            return VoiceChanger(rvc, read_chunk_size=args.chunk_size,
                                f0_method=args.f0_method, sid=args.sid)

        server = RealtimeSocketServer(vc_factory=vc_factory, host=args.host, port=args.port)
    def listening(host: str, port: int) -> None:
        # printed once the socket listens: a client that reads this line can connect
        print(f"serving {args.protocol} on {host}:{port} (ctrl-c to stop)", flush=True)

    try:
        asyncio.run(server.serve(on_listening=listening))
    except KeyboardInterrupt:
        print("stopped")


def _add_serve_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_path", required=True)
    p.add_argument("--index_path", default=None)
    p.add_argument("--hubert_path", default=None)
    p.add_argument("--embedder_model", default="contentvec",
                   choices=_EMBEDDERS)
    p.add_argument("--embedder_model_custom", default=None)
    p.add_argument("--protocol", default="ws", choices=["ws", "tcp"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6006)
    p.add_argument("--chunk_size", type=int, default=192,
                   help="TCP protocol block size (x128 samples @48 kHz)")
    p.add_argument("--f0_method", default="rmvpe", type=_f0_method)
    p.add_argument("--sid", type=int, default=0)
    p.add_argument("--webui", action="store_true",
                   help="also serve the browser client app (ws protocol)")
    p.add_argument("--webui_port", type=int, default=6007)
    p.add_argument("--device", default=None, help=_DEVICE_HELP)


def cmd_preprocess(args: argparse.Namespace) -> None:
    from rvc_tpu_torch.preprocess import AudioPreprocessor

    exp_dir = os.path.join(args.logs_dir, args.model_name)
    os.makedirs(exp_dir, exist_ok=True)
    n = AudioPreprocessor(exp_dir, args.sample_rate).process_directory(
        args.dataset_path, args.cut_preprocess, cpu_cores=args.cpu_cores,
        process_effects=args.process_effects, chunk_len=args.chunk_len,
        overlap_len=args.overlap_len, noise_reduction=args.noise_reduction,
        noise_reduction_strength=args.noise_reduction_strength)
    print(f"{n} segments written to {exp_dir}")


def cmd_extract(args: argparse.Namespace) -> None:
    """Features of every sliced segment, the filelists (with the mute rows)
    and model_info.json (`rvc_tpu/cli.py:cmd_extract`)."""
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.preprocess import DatasetBuilder, FeatureExtractor
    from rvc_tpu_torch.utils.embedders import resolve_embedder

    exp_dir = os.path.join(args.logs_dir, args.model_name)
    cfg = get_config(args.sample_rate)
    hubert_path = args.hubert_path or resolve_embedder(args.embedder_model,
                                                       args.embedder_model_custom)
    fe = FeatureExtractor(exp_dir, cfg, f0_method=args.f0_method,
                          f0_hop_length=args.hop_length, hubert_path=hubert_path,
                          device=args.device)
    n = fe.process_all(batch_size=args.batch_size, cpu_cores=args.cpu_cores)
    builder = DatasetBuilder(exp_dir)
    train_rows, val_rows = builder.build()
    if args.include_mutes > 0:
        train_rows = train_rows + builder.add_mutes(cfg, args.include_mutes,
                                                    feature_extractor=fe)
    builder.write_filelist(os.path.join(exp_dir, "filelist_train.txt"), train_rows)
    builder.write_filelist(os.path.join(exp_dir, "filelist_val.txt"), val_rows)
    sids = sorted({r["sid"] for r in train_rows + val_rows})
    with open(os.path.join(exp_dir, "model_info.json"), "w") as f:
        json.dump({"speakers_id": len(sids) or 1, "sample_rate": args.sample_rate,
                   "f0_method": args.f0_method,
                   "embedder_model": args.embedder_model if not args.hubert_path else "custom",
                   "embedder_model_custom": args.hubert_path or args.embedder_model_custom,
                   "n_train": len(train_rows), "n_val": len(val_rows)}, f, indent=2)
    print(f"{n} segments extracted; {len(train_rows)} train / {len(val_rows)} val")


def _default_pretrains(args: argparse.Namespace):
    """The stock pretrains for --pretrained under models/pretraineds; with
    either missing, a warning and (None, None): training from scratch."""
    from rvc_tpu_torch.utils.embedders import models_dir

    family = ("refinegan" if args.vocoder == "RefineGAN"
              else "titan" if args.pretrain == "titan" else "hifi-gan")
    srk = f"{args.sample_rate // 1000}k"
    root = os.path.join(models_dir(), "pretraineds", family)
    g, d = os.path.join(root, f"f0G{srk}.pth"), os.path.join(root, f"f0D{srk}.pth")
    missing = [p for p in (g, d) if not os.path.exists(p)]
    if missing:
        print(f"warning: --pretrained requested but {missing} not found; training from "
              f"scratch", file=sys.stderr)
        return None, None
    return g, d


def _spawns_ranks(args: argparse.Namespace) -> int:
    """The ranks `train` starts itself where no coordinator is given (flag
    or environment): one a card where the card's run sees several, or
    --mesh_model gloo ranks on the host under --device cpu; else 0."""
    import torch
    import torch.distributed as dist

    from rvc_tpu_torch.utils.device import resolve_device

    given = (args.coordinator or args.num_hosts or os.environ.get("COORDINATOR_ADDRESS")
             or os.environ.get("MASTER_ADDR"))
    if given or dist.is_initialized():
        return 0
    if resolve_device(args.device).type != "cuda":
        return args.mesh_model if args.mesh_model > 1 else 0
    n = torch.cuda.device_count()
    if n % args.mesh_model:
        raise SystemExit(f"--mesh_model {args.mesh_model} needs a multiple of "
                         f"{args.mesh_model} ranks, one a card; this machine has {n} card(s)")
    return n if n > 1 else 0


def cmd_train(args: argparse.Namespace) -> None:
    """Train on the experiment's filelist and export the inference model
    (`rvc_tpu/cli.py:cmd_train`): on one card, on one rank a card of this
    machine, or as rank --host_id of --num_hosts joined at --coordinator;
    --mesh_model N: on a (ranks / N, N) mesh, tensor-parallel over N."""
    import torch.distributed as dist

    from rvc_tpu_torch.parallel import distributed

    ranks = _spawns_ranks(args)
    if ranks:
        from rvc_tpu_torch.parallel.train import cli_train, spawn

        spawn(cli_train, ranks, (args,), device=args.device)
        return
    joins = not dist.is_initialized()
    info = distributed.initialize(args.coordinator, args.num_hosts, args.host_id,
                                  device=args.device)
    try:
        _train(args, info)
    finally:
        if joins and dist.is_initialized():
            dist.destroy_process_group()


def _train(args: argparse.Namespace, info: dict) -> None:
    """`train` on this process's rank (of one, without a process group)."""
    import numpy as np
    import torch.distributed as dist

    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.parallel import distributed
    from rvc_tpu_torch.preprocess import DatasetBuilder
    from rvc_tpu_torch.train.data import DataLoader, RVCDataset
    from rvc_tpu_torch.train.trainer import RVCTrainer
    from rvc_tpu_torch.utils.device import resolve_device

    if args.mesh_model > 1 and not dist.is_initialized():
        raise SystemExit(f"--mesh_model {args.mesh_model} needs {args.mesh_model} ranks or a "
                         f"multiple: a --coordinator, several cards, or --device cpu")
    shard = distributed.host_shard_info(args.mesh_model)
    mesh = distributed.global_mesh(args.mesh_model) if dist.is_initialized() else None
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    if main_rank and mesh is not None:
        print(f"distributed: {info}; mesh={mesh.shape}; hosts={shard['num_hosts']}")
    device = resolve_device(args.device)
    exp_dir = os.path.join(args.logs_dir, args.model_name)
    overrides = json.loads(args.config_overrides) if args.config_overrides else {}
    cfg = get_config(args.sample_rate, train_batch_size=args.batch_size,
                     train_warmup_epochs=args.warmup_epochs,
                     train_d_step_per_g_step=args.d_step_per_g_step,
                     model_vocoder=args.vocoder, model_checkpointing=args.checkpointing,
                     **overrides)
    rows = DatasetBuilder.read_filelist(os.path.join(exp_dir, "filelist_train.txt"))
    for r in rows:  # n_frames for the buckets
        if "spec" in r and os.path.exists(r["spec"]):
            r["n_frames"] = int(np.load(r["spec"], mmap_mode="r").shape[0])
    batch_size = args.batch_size
    if args.auto_batch_size:
        from rvc_tpu_torch.train.overtraining import calculate_recommended_batch_size

        minutes = (sum(r.get("n_frames", 0) for r in rows)
                   * cfg.data.hop_length / cfg.data.sample_rate / 60.0)
        batch_size = calculate_recommended_batch_size(minutes)
        print(f"auto batch size: {batch_size} ({minutes:.1f} min of audio)")
    ckpt_dir = os.path.join(exp_dir, "ckpt")
    if args.cleanup and main_rank and os.path.isdir(ckpt_dir):
        import shutil

        shutil.rmtree(ckpt_dir)
    if mesh is not None:
        dist.barrier()
    loader = DataLoader(RVCDataset(rows, cfg.data.hop_length), batch_size,
                        num_hosts=shard["num_hosts"], host_id=shard["host_id"],
                        shuffle=not args.no_shuffle)
    trainer = RVCTrainer(cfg, loader, checkpoint_dir=ckpt_dir,
                         use_overtraining_detector=args.overtraining_detector,
                         overtraining_threshold=args.overtraining_threshold,
                         overtraining_patience=args.overtraining_patience,
                         save_only_latest=args.save_only_latest,
                         save_every_weights=args.save_every_weights,
                         cache_data_on_device=args.cache_data_in_gpu,
                         model_name=args.model_name, use_aim=args.use_aim, mesh=mesh,
                         device=device)
    g_path, d_path = args.g_pretrained_path, args.d_pretrained_path
    if args.custom_pretrained and not (g_path or d_path):
        raise SystemExit("--custom_pretrained requires --g_pretrained_path/--d_pretrained_path")
    if args.pretrained and not (g_path or d_path):
        g_path, d_path = _default_pretrains(args)
    if g_path or d_path:
        trainer.load_pretrained(g_path, d_path)
    result = trainer.train(args.total_epoch, save_every=args.save_every_epoch)
    # every rank calls it (the shards are gathered whole); rank 0 writes
    final = trainer.export_inference_model(os.path.join(exp_dir, f"{args.model_name}.safetensors"))
    if main_rank:
        if args.index_algorithm:
            try:
                cmd_index(args)
            except SystemExit as e:  # no features: the trained model stands
                print(f"warning: post-training index build failed ({e}); run `index` by "
                      f"hand", file=sys.stderr)
    print(json.dumps({"epochs_run": result["epochs_run"], "best_loss": result["best_loss"],
                      "model": final if main_rank else None, "host": shard["host_id"],
                      "rank": dist.get_rank() if dist.is_initialized() else 0}))


def cmd_index(args: argparse.Namespace) -> None:
    """The retrieval index of the experiment's features, as a FAISS file
    (`rvc_tpu/cli.py:cmd_index`): above 200,000 vectors (or with KMeans)
    first compressed to at most 10,000 k-means centroids."""
    import numpy as np

    from rvc_tpu_torch.retrieval import build_index, write_faiss_index
    from rvc_tpu_torch.retrieval.ivf import kmeans_fit

    exp_dir = os.path.join(args.logs_dir, args.model_name)
    feat_dir = os.path.join(exp_dir, "features")
    feats = [np.load(os.path.join(feat_dir, f))
             for f in sorted(os.listdir(feat_dir)) if f.endswith(".npy")]
    if not feats:
        raise SystemExit("no features found; run extract first")
    all_feats = np.concatenate(feats, axis=0)
    rng = np.random.default_rng(0)
    rng.shuffle(all_feats)
    algo = args.index_algorithm or "Auto"
    if (algo == "KMeans" or (algo == "Auto" and len(all_feats) > 200_000)) \
            and len(all_feats) > 256:
        k = min(10_000, len(all_feats) // 4)
        init = all_feats[rng.choice(len(all_feats), k, replace=False)]
        all_feats = kmeans_fit(all_feats, init, k, device=args.device)
    idx = build_index(all_feats, device=args.device)
    out = os.path.join(exp_dir, f"{args.model_name}.index")
    write_faiss_index(idx, out)
    print(f"wrote {out} ({idx.ntotal} vectors, {idx.nlist} lists)")


def _add_train_args(sub) -> None:
    """preprocess, extract, train and index: `rvc_tpu/cli.py:570-675`'s flags
    and defaults (the distributed ones included), --device added."""
    p = sub.add_parser("preprocess")
    p.add_argument("--model_name", required=True)
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--sample_rate", type=int, default=48000, choices=[32000, 40000, 48000])
    p.add_argument("--cut_preprocess", default="Automatic",
                   choices=["Skip", "Simple", "Automatic"])
    p.add_argument("--process_effects", action="store_true", default=True)
    p.add_argument("--chunk_len", type=float, default=3.0)
    p.add_argument("--overlap_len", type=float, default=0.3)
    p.add_argument("--cpu_cores", type=int, default=os.cpu_count() or 1,
                   help="file-level preprocessing workers")
    p.add_argument("--noise_reduction", action="store_true")
    p.add_argument("--noise_reduction_strength", type=float, default=0.7)
    p.add_argument("--logs_dir", default="logs")
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("extract")
    p.add_argument("--model_name", required=True)
    p.add_argument("--sample_rate", type=int, default=48000)
    p.add_argument("--f0_method", default="rmvpe", type=_f0_method)
    p.add_argument("--hop_length", type=int, default=160,
                   help="crepe analysis hop in 16 kHz samples")
    p.add_argument("--batch_size", type=int, default=8,
                   help="same-length segments batched per device call")
    p.add_argument("--cpu_cores", type=int, default=None,
                   help="parallel host-side audio decode workers")
    p.add_argument("--include_mutes", type=int, default=2,
                   help="mute samples appended per speaker (0 disables)")
    p.add_argument("--hubert_path", default=None)
    p.add_argument("--embedder_model", default="contentvec", choices=_EMBEDDERS)
    p.add_argument("--embedder_model_custom", default=None)
    p.add_argument("--gpu", default=None,
                   help="accepted for the reference CLI's sake and ignored (--device)")
    p.add_argument("--logs_dir", default="logs")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("train")
    p.add_argument("--model_name", required=True)
    p.add_argument("--sample_rate", type=int, default=48000)
    p.add_argument("--total_epoch", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--save_every_epoch", type=int, default=10)
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--g_pretrained_path", default=None)
    p.add_argument("--d_pretrained_path", default=None)
    p.add_argument("--pretrained", action="store_true",
                   help="load the stock pretrains matching --vocoder/--sample_rate from "
                        "models/pretraineds")
    p.add_argument("--custom_pretrained", action="store_true",
                   help="use --g_pretrained_path/--d_pretrained_path")
    p.add_argument("--pretrain", default="base", choices=["base", "titan"],
                   help="pretrain family for --pretrained")
    p.add_argument("--cleanup", action="store_true",
                   help="delete stale checkpoints in the experiment dir before training")
    p.add_argument("--index_algorithm", default=None, choices=["Auto", "Faiss", "KMeans"],
                   help="also build the retrieval index after training")
    p.add_argument("--auto_batch_size", action="store_true",
                   help="pick the batch size from dataset length")
    p.add_argument("--gpu", default=None,
                   help="accepted for the reference CLI's sake and ignored: --device picks "
                        "the device, and train takes every visible card (CUDA_VISIBLE_DEVICES "
                        "limits them)")
    p.add_argument("--overtraining_detector", action="store_true")
    p.add_argument("--overtraining_threshold", type=int, default=50)
    p.add_argument("--overtraining_patience", type=int, default=10)
    p.add_argument("--logs_dir", default="logs")
    p.add_argument("--save_only_latest", action="store_true")
    p.add_argument("--save_every_weights", action="store_true")
    p.add_argument("--cache_data_in_gpu", action="store_true",
                   help="keep collated batches device-resident across epochs")
    p.add_argument("--d_step_per_g_step", type=int, default=1)
    p.add_argument("--vocoder", default="HiFi-GAN",
                   choices=["HiFi-GAN", "MRF HiFi-GAN", "RefineGAN"])
    p.add_argument("--checkpointing", action="store_true",
                   help="recompute the decoder in the backward pass (activation checkpointing)")
    p.add_argument("--use_aim", action="store_true",
                   help="track with Aim (raises if aim is not installed)")
    # one rank a card; without --coordinator, one rank for each visible card
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (or a tcp:// / file:// URL) for multi-process "
                        "training")
    p.add_argument("--num_hosts", type=int, default=None,
                   help="ranks in all (one process a card)")
    p.add_argument("--host_id", type=int, default=None, help="this process's rank")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel axis size (the data axis gets the rest of the ranks)")
    p.add_argument("--config_overrides", default=None,
                   help='JSON dict of get_config kwargs, e.g. \'{"model_n_layers": 2}\'')
    p.add_argument("--no_shuffle", action="store_true",
                   help="deterministic batch order (debug/repro runs)")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("index")
    p.add_argument("--model_name", required=True)
    p.add_argument("--logs_dir", default="logs")
    p.add_argument("--index_algorithm", default="Auto", choices=["Auto", "Faiss", "KMeans"])
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    p.set_defaults(fn=cmd_index)


def cmd_tensorboard(args: argparse.Namespace) -> None:
    """tensorboard on the logs directory where it is installed; otherwise
    the JSONL tracker curves plotted to PNGs (`rvc_tpu/cli.py:182-209`)."""
    import glob
    import subprocess

    try:
        import tensorboard  # noqa: F401

        subprocess.run([sys.executable, "-m", "tensorboard.main", "--logdir", args.logs_path],
                       check=True)
        return
    except (ImportError, OSError, subprocess.CalledProcessError) as e:
        print(f"tensorboard unavailable ({e.__class__.__name__}); falling back to JSONL "
              f"curve plots", file=sys.stderr)
    from rvc_tpu_torch.tools.plot_logs import plot

    logs = sorted(glob.glob(os.path.join(args.logs_path, "**", "*.jsonl"), recursive=True))
    if os.path.isfile(args.logs_path):
        logs = [args.logs_path]
    if not logs:
        print(f"no tensorboard and no .jsonl tracker logs under {args.logs_path!r}",
              file=sys.stderr)
        sys.exit(2)
    for log in logs:
        print(plot(log, args.out_path))


def cmd_audio_analyzer(args: argparse.Namespace) -> None:
    from rvc_tpu_torch.tools.model_tools import analyze_audio

    print(json.dumps(analyze_audio(args.input_path, args.plot_path), indent=2))


def cmd_convert(args: argparse.Namespace) -> None:
    from rvc_tpu_torch.tools.model_tools import convert_model

    print(f"wrote {convert_model(args.pth_path, args.output_path)}")


def cmd_model_information(args: argparse.Namespace) -> None:
    from rvc_tpu_torch.tools.model_tools import model_information

    print(json.dumps(model_information(args.model_path), indent=2, default=str))


def cmd_model_blender(args: argparse.Namespace) -> None:
    from rvc_tpu_torch.tools.model_tools import blend_models

    print(f"wrote {blend_models(args.pth_path_1, args.pth_path_2, args.ratio, args.output_path)}")


def _add_tool_args(sub) -> None:
    """The host tools: `rvc_tpu/cli.py:547-568, 717-723`'s flags and defaults."""
    p = sub.add_parser("audio_analyzer")
    p.add_argument("--input_path", required=True)
    p.add_argument("--plot_path", default="logs/audio_analysis.png",
                   help="3-panel analysis figure output (empty string disables)")
    p.set_defaults(fn=cmd_audio_analyzer)

    p = sub.add_parser("convert")
    p.add_argument("--pth_path", required=True)
    p.add_argument("--output_path", default=None)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("model_information")
    p.add_argument("--model_path", required=True)
    p.set_defaults(fn=cmd_model_information)

    p = sub.add_parser("model_blender")
    p.add_argument("--pth_path_1", required=True)
    p.add_argument("--pth_path_2", required=True)
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--output_path", default="blended.safetensors")
    p.set_defaults(fn=cmd_model_blender)

    p = sub.add_parser("tensorboard",
                       help="launch tensorboard on the logs dir, or render the JSONL tracker "
                            "curves to a PNG when tensorboard is unavailable")
    p.add_argument("--logs_path", default="logs")
    p.add_argument("--out_path", default=None)
    p.set_defaults(fn=cmd_tensorboard)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("rvc-tpu-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("infer")
    _add_infer_args(p)
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("batch_infer")
    _add_infer_args(p)
    # folders in place of the single paths
    for a in p._actions:
        if a.dest in ("input_path", "output_path"):
            a.required = False
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.set_defaults(fn=cmd_batch_infer)

    p = sub.add_parser("serve", help="realtime conversion server (ws-audio or TCP protocol)")
    _add_serve_args(p)
    p.set_defaults(fn=cmd_serve)
    _add_train_args(sub)
    _add_tool_args(sub)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
