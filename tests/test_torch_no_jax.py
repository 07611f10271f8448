"""The port imports neither JAX nor Flax nor anything of `rvc_tpu`."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "rvc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "rvc_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_out():
    code = ("import sys, rvc_tpu_torch.api, rvc_tpu_torch.cli, rvc_tpu_torch.retrieval, "
            "rvc_tpu_torch.ops.kernels.melspec, rvc_tpu_torch.ops.kernels.attention, "
            "rvc_tpu_torch.ops.kernels.resblock, rvc_tpu_torch.pitch, "
            "rvc_tpu_torch.models.crepe, rvc_tpu_torch.models.fcpe\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax') or m.startswith('rvc_tpu.') or m == 'rvc_tpu']\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
