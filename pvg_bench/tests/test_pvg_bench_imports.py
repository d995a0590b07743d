"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port.  Top-level names are compared whole, since the
port's name begins with the JAX package's."""
import subprocess
import sys

from pvg_bench import spec
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


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(["pvg_bench.reference.model", "pvg_bench.reference.train",
                            "pvg_bench.reference.data"])
    assert forbidden_modules(loaded) == []
    assert "playablevideogeneration_tpu_torch" not in loaded
