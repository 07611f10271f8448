"""`rvc_tpu_torch.tools.download` against `rvc_tpu.tools.download` on the
same stubs: the link parsers over one table of links, `download_model`
over links served from memory (a direct zip, a Hugging Face blob page, a
Drive file served at once, a Drive confirm form, a Drive quota page), and
`download_prerequisites` under each flag. Nothing goes to the network:
`urllib.request.urlopen` and `build_opener` are stubbed for both packages
at once."""

import io
import os
import zipfile
from urllib.parse import urlencode

import numpy as np
import pytest

from rvc_tpu.tools import download as J
from rvc_tpu_torch.tools import download as P

LINKS = [
    "https://drive.google.com/file/d/1AbC-d_9/view?usp=sharing",
    "https://drive.google.com/uc?export=download&id=XyZ_12",
    "https://drive.google.com/open?id=OpEn-1",
    "https://docs.google.com/uc?id=DoCs9&export=download",
    "https://huggingface.co/user/repo/blob/main/voice.pth?download=true",
    "https://huggingface.co/user/repo/resolve/main/voice.zip",
    "https://example.org/models/voice.zip?download=1",
    "https://example.org/models/",
]
DISPOSITIONS = [
    'attachment; filename="voice.pth"',
    "attachment; filename*=UTF-8''big%20model.zip",
    "attachment; filename=plain.index; size=3",
    'attachment; filename="../../etc/passwd"',
    "inline",
    "",
]


@pytest.mark.parametrize("link", LINKS)
def test_link_parsers_equal_reference(link):
    assert P.gdrive_file_id(link) == J.gdrive_file_id(link)
    assert P.normalize_link(link) == J.normalize_link(link)


@pytest.mark.parametrize("disposition", DISPOSITIONS)
def test_disposition_filename_equals_reference(disposition):
    headers = {"Content-Disposition": disposition}
    assert P._disposition_filename(headers) == J._disposition_filename(headers)


class _Response(io.BytesIO):
    def __init__(self, body: bytes, headers: dict):
        super().__init__(body)
        self.headers = headers


class _Web:
    """Serves `pages` {url: (body, headers)} to `urlopen` and to openers
    from `build_opener`; records each URL asked for with its User-Agent."""

    def __init__(self, pages: dict):
        self.pages = pages
        self.asked = []

    def _serve(self, url: str, agent: str) -> _Response:
        self.asked.append((url, agent))
        if url not in self.pages:
            raise OSError(f"no route to {url}")
        body, headers = self.pages[url]
        return _Response(body, headers)

    def urlopen(self, req):
        return self._serve(req.full_url, req.get_header("User-agent"))

    def build_opener(self, *handlers):
        web = self

        class Opener:
            addheaders = []

            def open(self, url):
                return web._serve(url, dict(self.addheaders).get("User-Agent"))
        return Opener()


def _zip(files: dict) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
    return buf.getvalue()


_RNG = np.random.default_rng(0)
PTH, INDEX = _RNG.bytes(3000), _RNG.bytes(2000)
OCTET = {"Content-Type": "application/octet-stream"}
UC = "https://drive.google.com/uc?export=download&id="
FORM = ('<form id="download-form" action="https://drive.usercontent.google.com/download" '
        'method="get"><input type="hidden" name="id" value="BIG1">'
        '<input type="hidden" name="confirm" value="t">'
        '<input type="hidden" name="uuid" value="u-1"></form>')
CASES = {
    "direct-zip": ("https://example.org/m/voice.zip", {
        "https://example.org/m/voice.zip": (_zip({"voice.pth": PTH, "voice.index": INDEX}),
                                            OCTET)}),
    "hf-blob": ("https://huggingface.co/u/r/blob/main/voice.pth?download=true", {
        "https://huggingface.co/u/r/resolve/main/voice.pth": (PTH, OCTET)}),
    "drive-direct": ("https://drive.google.com/file/d/SMALL1/view?usp=sharing", {
        UC + "SMALL1": (PTH, {**OCTET, "Content-Disposition": 'attachment; filename="m.pth"'})}),
    "drive-confirm": ("https://drive.google.com/open?id=BIG1", {
        UC + "BIG1": (FORM.encode(), {"Content-Type": "text/html; charset=utf-8"}),
        "https://drive.usercontent.google.com/download?" + urlencode(
            {"id": "BIG1", "confirm": "t", "uuid": "u-1"}): (
            _zip({"sub/voice.pth": PTH, "voice.index": INDEX}),
            {**OCTET, "Content-Disposition": "attachment; filename*=UTF-8''big%20voice.zip"})}),
}


def _tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _download(monkeypatch, module, web, link, out_dir):
    import urllib.request

    monkeypatch.setattr(urllib.request, "urlopen", web.urlopen)
    monkeypatch.setattr(urllib.request, "build_opener", web.build_opener)
    return module.download_model(link, str(out_dir))


@pytest.mark.parametrize("case", CASES)
def test_download_model_writes_what_reference_writes(monkeypatch, tmp_path, case):
    """The same files at the same relative paths with the same bytes, the
    same returned path, the same URLs asked for with the same User-Agent."""
    link, pages = CASES[case]
    runs = []
    for name, module in (("jax", J), ("port", P)):
        web = _Web(pages)
        got = _download(monkeypatch, module, web, link, tmp_path / name)
        runs.append((os.path.relpath(got, tmp_path / name), _tree(tmp_path / name), web.asked))
    assert runs[0] == runs[1]
    path, tree, asked = runs[1]
    assert tree[path] and all(agent == "rvc-tpu" for _, agent in asked)
    if case in ("direct-zip", "drive-confirm"):          # extracted in place
        assert INDEX in tree.values() and PTH in tree.values() and len(tree) == 3


def test_download_model_refuses_a_drive_quota_page(monkeypatch, tmp_path):
    pages = {UC + "GONE": (b"<html>Quota exceeded</html>", {"Content-Type": "text/html"})}
    for module in (J, P):
        with pytest.raises(RuntimeError, match="quota exceeded or permission denied"):
            _download(monkeypatch, module, _Web(pages),
                      "https://drive.google.com/file/d/GONE/view", tmp_path / module.__name__)


def test_fetch_failure_names_the_file_to_place(monkeypatch, tmp_path):
    """Without a network: the reference's "may be air-gapped" RuntimeError."""
    for module in (J, P):
        with pytest.raises(RuntimeError, match="air-gapped .* place the file manually"):
            _download(monkeypatch, module, _Web({}), "https://example.org/x.pth",
                      tmp_path / module.__name__)


@pytest.mark.parametrize("flags", [
    dict(), dict(pretraineds=True, models=False), dict(titan=True, models=False),
    dict(refinegan=True, models=False), dict(embedders=True, models=False),
], ids=["models", "pretraineds", "titan", "refinegan", "embedders"])
def test_download_prerequisites_equals_reference(monkeypatch, tmp_path, capsys, flags):
    """Each flag: the same URLs fetched into the same paths; a second run
    fetches nothing and prints "exists:" for every file."""
    import urllib.request

    runs = []
    for name, module in (("jax", J), ("port", P)):
        urls = [f"{module.HF_BASE}/{folder}/{f}" for folder in module.PREREQUISITES
                for f in module.PREREQUISITES[folder]]
        web = _Web({u: (u.encode(), OCTET) for u in urls})
        monkeypatch.setattr(urllib.request, "urlopen", web.urlopen)
        base = tmp_path / name
        module.download_prerequisites(base_dir=str(base), **flags)
        first = capsys.readouterr().out.replace(str(base), "<base>")
        asked = list(web.asked)
        module.download_prerequisites(base_dir=str(base), **flags)
        again = capsys.readouterr().out.replace(str(base), "<base>")
        runs.append((first, asked, _tree(base), again, web.asked == asked))
    assert runs[0] == runs[1]
    first, asked, tree, again, nothing_more = runs[1]
    assert asked and len(tree) == len(asked) and nothing_more
    assert again.count("exists: ") == len(tree) and "fetching" not in again
