"""Model and prerequisite downloader (a host copy of
`rvc_tpu/tools/download.py`; upstream `rvc*/lib/tools/model_download.py`
and `rvc_mlx/lib/tools/prerequisites_download.py:6-60`).

`download_model` fetches a voice model from Hugging Face, Google Drive
(the gdown confirm-token flow, the real filename from Content-Disposition)
or any direct link, and extracts zips in place; `download_prerequisites`
fetches the asset catalog (HiFi-GAN f0G/f0D pretrains at 32/40/48k, the
TITAN and RefineGAN pretrains, the rmvpe / fcpe predictors, the contentvec
and language HuBERT embedders) into `models/`. Without a network each
fetch fails with a RuntimeError that names the file to place by hand.
"""

from __future__ import annotations

import os
import re
import sys
import urllib.request
import zipfile
from typing import Optional

HF_BASE = "https://huggingface.co/IAHispano/Applio/resolve/main/Resources"

# remote folder -> file list (reference `prerequisites_download.py:10-50`)
PREREQUISITES = {
    "predictors": ["rmvpe.pt", "fcpe.pt"],
    "embedders/contentvec": ["pytorch_model.bin", "config.json"],
    "pretrained_v2": [f"{k}{sr}.pth" for sr in ("32k", "40k", "48k")
                      for k in ("f0G", "f0D")],
    "titan": [f"{k}{sr}.pth" for sr in ("32k", "40k", "48k")
              for k in ("f0G", "f0D")],
    "refinegan": ["f0G32k.pth", "f0D32k.pth"],
    # language-specialized content encoders (reference `rvc_cli.py:
    # 765-775` embedder_model choices; HuBERT-base layout)
    "embedders/chinese-hubert-base": ["pytorch_model.bin", "config.json"],
    "embedders/japanese-hubert-base": ["pytorch_model.bin", "config.json"],
    "embedders/korean-hubert-base": ["pytorch_model.bin", "config.json"],
}

# remote folder -> local layout (mirrors `folder_mapping_list`)
FOLDER_MAPPING = {
    "predictors": "predictors",
    "embedders/contentvec": "embedders/contentvec",
    "pretrained_v2": "pretraineds/hifi-gan",
    "titan": "pretraineds/titan",
    "refinegan": "pretraineds/refinegan",
    "embedders/chinese-hubert-base": "embedders/chinese-hubert-base",
    "embedders/japanese-hubert-base": "embedders/japanese-hubert-base",
    "embedders/korean-hubert-base": "embedders/korean-hubert-base",
}


def _fetch(url: str, dest: str) -> str:
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    try:
        req = urllib.request.Request(url, headers={"User-Agent": "rvc-tpu"})
        with urllib.request.urlopen(req) as r, open(dest, "wb") as f:
            while chunk := r.read(1 << 20):
                f.write(chunk)
    except Exception as e:
        raise RuntimeError(
            f"download failed ({e}); this environment may be air-gapped — "
            f"place the file manually at {dest}") from e
    return dest


def gdrive_file_id(url: str) -> Optional[str]:
    """Extract a Google Drive file id from any of its link shapes."""
    for pat in (r"drive\.google\.com/file/d/([\w-]+)",
                r"drive\.google\.com/uc\?.*id=([\w-]+)",
                r"drive\.google\.com/open\?.*id=([\w-]+)",
                r"docs\.google\.com/uc\?.*id=([\w-]+)"):
        m = re.search(pat, url)
        if m:
            return m.group(1)
    return None


def _disposition_filename(headers) -> Optional[str]:
    cd = headers.get("Content-Disposition", "") or ""
    m = re.search(r"filename\*=UTF-8''([^;]+)", cd) or \
        re.search(r'filename="?([^";]+)"?', cd)
    if m:
        from urllib.parse import unquote

        name = os.path.basename(unquote(m.group(1)).strip())
        return name or None
    return None


def download_gdrive(file_id: str, dest: str) -> str:
    """gdown-equivalent Google Drive fetch: follow the virus-scan
    confirm flow for large files (`rvc_mlx/lib/tools/model_download.py:
    37-126` vendors gdown for the same purpose).

    `dest` may be a DIRECTORY — the real filename then comes from the
    Content-Disposition header (models shared on Drive are .pth/.zip/
    .index; a made-up extension would leave them unloadable). Streams
    to disk in 1 MB chunks (checkpoints run to GBs — never buffer the
    body in memory). Returns the written path.
    """
    import http.cookiejar

    jar = http.cookiejar.CookieJar()
    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(jar))
    opener.addheaders = [("User-Agent", "rvc-tpu")]
    url = f"https://drive.google.com/uc?export=download&id={file_id}"

    def stream_to_dest(r) -> str:
        out = dest
        if os.path.isdir(dest) or dest.endswith(os.sep):
            name = _disposition_filename(r.headers) or f"gdrive_{file_id}"
            out = os.path.join(dest, name)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "wb") as f:
            while chunk := r.read(1 << 20):
                f.write(chunk)
        return out

    try:
        with opener.open(url) as r:
            ctype = r.headers.get("Content-Type", "")
            if "text/html" not in ctype:
                return stream_to_dest(r)
            html = r.read().decode("utf-8", "replace")
        # large files: resubmit the confirm form on drive.usercontent
        m = re.search(r'action="([^"]+)"', html)
        fields = dict(re.findall(
            r'name="([^"]+)"\s+value="([^"]*)"', html))
        if not (m and fields):
            raise RuntimeError("Google Drive did not serve the file "
                               "(quota exceeded or permission denied)")
        from urllib.parse import urlencode

        with opener.open(f"{m.group(1)}?{urlencode(fields)}") as r2:
            return stream_to_dest(r2)
    except RuntimeError:
        raise
    except Exception as e:
        raise RuntimeError(
            f"Google Drive download failed ({e}); this environment may be "
            f"air-gapped — place the file manually at {dest}") from e


def normalize_link(link: str) -> str:
    """Rewrite share-page URLs to direct-download form (HF blob ->
    resolve, the reference does the same in `model_download.py:163+`)."""
    if "huggingface.co" in link and "/blob/" in link:
        link = link.replace("/blob/", "/resolve/")
    return link.split("?download")[0]


def download_model(link: str, output_dir: str = "models") -> str:
    """Fetch a voice model from HF / Google Drive / any direct link;
    zips are extracted in place."""
    os.makedirs(output_dir, exist_ok=True)
    fid = gdrive_file_id(link)
    if fid:
        # real filename comes from the response headers
        dest = download_gdrive(fid, output_dir + os.sep)
    else:
        link = normalize_link(link)
        name = link.rstrip("/").split("/")[-1].split("?")[0] or "model.zip"
        dest = os.path.join(output_dir, name)
        _fetch(link, dest)
    if zipfile.is_zipfile(dest):
        with zipfile.ZipFile(dest) as z:
            z.extractall(output_dir)
    return dest


def download_prerequisites(pretraineds: bool = False, models: bool = True,
                           titan: bool = False, refinegan: bool = False,
                           embedders: bool = False,
                           base_dir: str = "models") -> None:
    folders = []
    if models:
        folders += ["predictors", "embedders/contentvec"]
    if pretraineds:
        folders += ["pretrained_v2"]
    if titan:
        folders += ["titan"]
    if refinegan:
        folders += ["refinegan"]
    if embedders:
        folders += ["embedders/chinese-hubert-base",
                    "embedders/japanese-hubert-base",
                    "embedders/korean-hubert-base"]
    for folder in folders:
        for f in PREREQUISITES[folder]:
            dest = os.path.join(base_dir, FOLDER_MAPPING[folder], f)
            if os.path.exists(dest):
                print(f"exists: {dest}")
                continue
            url = f"{HF_BASE}/{folder}/{f}"
            print(f"fetching {url}")
            _fetch(url, dest)
