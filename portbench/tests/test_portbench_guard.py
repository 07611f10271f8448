"""The import check compares top-level module names whole."""

import pytest

from portbench import guard


@pytest.mark.parametrize("name,bad", [
    ("rvc_tpu_torch", False), ("rvc_tpu_torch.models.hubert", False), ("jaxtyping", False),
    ("rvc_tpu", True), ("rvc_tpu.models", True), ("jax", True), ("jax.numpy", True),
    ("jaxlib.xla_client", True), ("flax.linen", True)])
def test_forbidden(name, bad):
    assert bool(guard.forbidden([name])) == bad


def test_benchmark_and_entries_load_nothing_forbidden():
    import subprocess
    import sys

    code = ("import portbench.run, portbench.calibrate, portbench.trace, "
            "portbench.drivers.song, portbench.drivers.longform, portbench.drivers.train, "
            "rvc_tpu_torch.api, rvc_tpu_torch.parallel.infer, rvc_tpu_torch.train.train_step, "
            "rvc_tpu_torch.models.discriminators; "
            "from portbench import guard; print(guard.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(guard.__file__).rsplit("/portbench/", 1)[0], check=True)
    assert out.stdout.strip() == "[]"
