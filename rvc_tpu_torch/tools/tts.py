"""TTS front end: edge-tts synthesis piped into voice conversion (a host
copy of `rvc_tpu/tools/tts.py`; upstream `rvc*/lib/tools/tts.py` and its
`tts_voices.json`).

`synthesize` speaks a text with a Microsoft Edge neural voice through the
`edge_tts` package (which needs a network); `tts_and_convert` converts the
result with an `RVC`. `list_voices` asks edge-tts where it is installed,
else a voice list file, else the built-in catalog of 322 voices
(`tts_catalog.json`, a copy of the reference's).
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

FALLBACK_VOICES = [
    "en-US-AriaNeural", "en-US-GuyNeural", "en-US-JennyNeural",
    "en-GB-LibbyNeural", "en-GB-RyanNeural", "en-AU-NatashaNeural",
    "es-ES-ElviraNeural", "es-MX-DaliaNeural", "fr-FR-DeniseNeural",
    "de-DE-KatjaNeural", "it-IT-ElsaNeural", "pt-BR-FranciscaNeural",
    "ja-JP-NanamiNeural", "ko-KR-SunHiNeural", "zh-CN-XiaoxiaoNeural",
    "ru-RU-SvetlanaNeural", "hi-IN-SwaraNeural", "ar-SA-ZariyahNeural",
]


def builtin_catalog() -> List[str]:
    """The full Edge neural voice catalog (322 voices / 142 locales —
    the public Azure TTS voice list the reference ships verbatim as
    `rvc/lib/tools/tts_voices.json`), stored compactly as
    {locale: ["Name:G", ...]} and expanded to ShortNames here."""
    import json
    import os

    p = os.path.join(os.path.dirname(__file__), "tts_catalog.json")
    try:
        with open(p) as f:
            compact = json.load(f)
    except Exception:
        return list(FALLBACK_VOICES)
    return sorted(f"{loc}-{entry.split(':')[0]}Neural"
                  for loc, entries in compact.items() for entry in entries)


def list_voices(catalog_path: Optional[str] = None) -> List[str]:
    """Full catalog from edge-tts when installed; otherwise a local
    `tts_voices.json` (the reference ships one with 800+ entries — drop
    it next to the models dir or point RVC_TPU_TTS_VOICES at it); else
    the built-in fallback set."""
    try:
        import edge_tts

        async def q():
            return await edge_tts.list_voices()

        voices = asyncio.run(q())
        return sorted(v["ShortName"] for v in voices)
    except Exception:
        pass
    import json
    import os

    for p in (catalog_path, os.environ.get("RVC_TPU_TTS_VOICES"),
              os.path.join("models", "tts_voices.json")):
        if p and os.path.exists(p):
            try:
                with open(p) as f:
                    data = json.load(f)
                if isinstance(data, list):
                    names = [v.get("ShortName", v) if isinstance(v, dict)
                             else str(v) for v in data]
                    return sorted(names)
            except Exception:
                continue
    return builtin_catalog()


def synthesize(text: str, voice: str = "en-US-AriaNeural",
               rate: int = 0, output_path: str = "tts_output.wav") -> str:
    """Text -> wav via edge-tts (network required)."""
    import edge_tts

    async def run():
        tts = edge_tts.Communicate(text, voice, rate=f"{rate:+d}%")
        await tts.save(output_path)

    asyncio.run(run())
    return output_path


def tts_and_convert(rvc, text: str, voice: str, output_path: str,
                    rate: int = 0, tts_wav: str = "tts_output.wav",
                    **infer_kwargs) -> str:
    synthesize(text, voice, rate, tts_wav)
    return rvc.infer_file(tts_wav, output_path, **infer_kwargs)
