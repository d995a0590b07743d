"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port.  Top-level names are compared whole, since the
port's name begins with the JAX package's."""
import glob
import os
import subprocess
import sys

import pytest

from pvg_bench import drive, spec
from pvg_bench.run import forbidden_modules

HARNESS = ["pvg_bench.run", "pvg_bench.drive", "pvg_bench.readers", "pvg_bench.control",
           "pvg_bench.counts", "pvg_bench.trace", "pvg_bench.spec"]
# The port's modules that the drivers load.
PORT = ["playablevideogeneration_tpu_torch.training.trainer",
        "playablevideogeneration_tpu_torch.inference.play_session",
        "playablevideogeneration_tpu_torch.data.video_dataset",
        "playablevideogeneration_tpu_torch.data.transforms",
        "playablevideogeneration_tpu_torch.models.caddy",
        "playablevideogeneration_tpu_torch.models.vgg"]


# Every module of the references, and every driver file, whatever later
# changes add.
REFERENCES = sorted(f"pvg_bench.reference.{os.path.basename(p)[:-3]}"
                    for p in glob.glob(os.path.join(spec.PACKAGE, "reference", "*.py"))
                    if not p.endswith("__init__.py"))
DRIVER_FILES = sorted(os.path.basename(p)[:-3]
                      for p in glob.glob(os.path.join(drive.DRIVER_DIR, "*.py")))


def _loaded_after(modules, extra=""):
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules) + extra +
            "print(' '.join(sorted({n.split('.', 1)[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True)
    return set(out.stdout.split())


def test_forbidden_names_compare_whole():
    assert forbidden_modules(["playablevideogeneration_tpu_torch.models.caddy"]) == []
    assert forbidden_modules(["playablevideogeneration_tpu.models"]) == [
        "playablevideogeneration_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "optax"]) == [
        "flax", "jax", "jaxlib", "optax"]


def test_harness_and_port_load_no_jax():
    readers = "".join(
        f"from pvg_bench.readers import load_reader; load_reader({m['name']!r})\n"
        for m in spec.benchmark()["per_layer"])
    loaded = _loaded_after(HARNESS + PORT, readers)
    assert "playablevideogeneration_tpu_torch" in loaded
    assert forbidden_modules(loaded) == []


@pytest.mark.parametrize("module", REFERENCES)
def test_reference_loads_nothing_of_the_port(module):
    loaded = _loaded_after([module])
    assert forbidden_modules(loaded) == []
    assert "playablevideogeneration_tpu_torch" not in loaded


def test_driver_files_load_no_jax():
    loaded = _loaded_after(["pvg_bench.drive"], "".join(
        f"from pvg_bench.drive import load_driver; load_driver({name!r})\n"
        for name in DRIVER_FILES))
    assert forbidden_modules(loaded) == []
