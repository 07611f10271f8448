"""Command line of the port (counterpart of `rvc_tpu/cli.py`): the `infer`
and `batch_infer` subcommands, with the reference's flag names and
defaults, plus `--device`.

    python -m rvc_tpu_torch.cli infer --input_path in.wav --output_path out.wav \\
        --model_path model.pth --index_path model.index

runs on the card; `--device cpu` runs the kernels' plain PyTorch versions
on the host. `--f0_method` takes rmvpe, crepe, crepe-tiny, fcpe, dio, pm,
harvest or hybrid[a+b+...]; `--f0_file` (one f0 per 10 ms frame, read with
`np.loadtxt`) replaces the extraction. Flags of paths that are not ported
yet (splitting, cleaning, formants, the effects, non-WAV export) fail when
set away from their defaults.
"""

from __future__ import annotations

import argparse
import os

# flags of paths not ported yet -> where ROADMAP lists them; each must stay
# at its default
_NOT_PORTED = {
    "split_audio": "§2.9", "clean_audio": "§2.9", "clean_strength": "§2.9",
    "export_format": "§2.9", "formant_shifting": "§2.9", "formant_qfrency": "§2.9",
    "formant_timbre": "§2.9", "post_process": "§2.9",
}
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
_NOT_PORTED.update({k: "§2.9" for k in _FX_FLAGS})
_NOT_PORTED.update({k: "§2.9" for k, _ in _FX_VALUES})


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
                   choices=["contentvec", "chinese-hubert-base", "japanese-hubert-base",
                            "korean-hubert-base", "custom"])
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
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path on the host "
                        "(default: the CUDA card)")


def _check_ported(parser: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    for dest, where in _NOT_PORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            parser.error(f"--{dest} is not ported to rvc_tpu_torch yet (ROADMAP {where}); "
                         "leave it at its default")


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
                f0_hop_length=args.hop_length)


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
        rvc.infer_file(os.path.join(args.input_folder, f), out, **_infer_kwargs(args))
        print(f"wrote {out}")
    print(f"{len(files)} files converted")


def main(argv=None) -> None:
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

    args = parser.parse_args(argv)
    _check_ported(sub.choices[args.command], args)
    args.fn(args)


if __name__ == "__main__":
    main()
