"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs and the same numpy weights; the
JAX package runs on the CPU backend, the port on ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playablevideogeneration_tpu.models import action as jax_action
from playablevideogeneration_tpu.models import caddy as jax_caddy
from playablevideogeneration_tpu_torch.models import action as port_action
from playablevideogeneration_tpu_torch.models import caddy as port_caddy
from playablevideogeneration_tpu_torch.models.gumbel import gumbel_softmax


@pytest.fixture(scope="module", autouse=True)
def single_threaded_torch():
    """One intra-op thread for PyTorch while a module that imports this
    fixture runs: the suite runs in several processes at once, and their
    thread pools, each as wide as the machine, contend for its cores
    (the port's tests took three times as long with them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_variables(tree: Mapping, seed: int) -> dict:
    """A numpy tree shaped like the JAX variables ``tree`` (arrays or
    ``ShapeDtypeStruct``s), filled from ``seed``: conv kernels
    LeCun-normal, BN scales in [0.5, 1.5], biases, BN means and initial
    LSTM states N(0, 0.1^2), BN variances in [0.5, 2], centroids N(0, 1).
    The statistics are far from (0, 1), so BatchNorm does real work."""
    rng = np.random.default_rng(seed)

    def fill(name, shape):
        if name == "kernel":
            return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape)
        if name in ("bias", "mean") or name.startswith("initial_"):
            return rng.normal(size=shape) * 0.1
        if name == "centroids":
            return rng.normal(size=shape)
        raise KeyError(name)

    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping)
                else fill(k, tuple(v.shape)).astype(np.float32)
                for k, v in sorted(node.items())}

    return walk(tree)


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> contiguous NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    """NCHW torch tensor -> NHWC numpy."""
    return x.detach().permute(0, 2, 3, 1).float().numpy()


class Noise:
    """Numpy noise in call order: the k-th draw since ``reset`` is the same
    in both packages."""

    def __init__(self):
        self.calls = 0

    def reset(self):
        self.calls = 0

    def draw(self, shape, kind):
        rng = np.random.default_rng(1000 + self.calls)
        self.calls += 1
        if kind == "normal":
            return rng.normal(size=shape).astype(np.float32)
        return rng.gumbel(size=shape).astype(np.float32)


NOISE = Noise()


def _jax_reparameterized(key, mean, variance):
    return jnp.asarray(NOISE.draw(mean.shape, "normal"), mean.dtype) * jnp.sqrt(variance) + mean


def _jax_gumbel(key, log_probs, temperature, hard=False):
    g = jnp.asarray(NOISE.draw(log_probs.shape, "gumbel"), log_probs.dtype)
    soft = jax.nn.softmax((log_probs + g) / temperature, axis=-1)
    if hard:
        y_hard = jax.nn.one_hot(jnp.argmax(soft, axis=-1), soft.shape[-1], dtype=soft.dtype)
        return soft + jax.lax.stop_gradient(y_hard - soft)
    return soft


def _port_reparameterized(generator, mean, variance):
    noise = torch.from_numpy(NOISE.draw(tuple(mean.shape), "normal")).to(mean.device)
    return noise * torch.sqrt(variance) + mean


def _port_gumbel(generator, log_probs, temperature, hard=False):
    noise = torch.from_numpy(NOISE.draw(tuple(log_probs.shape), "gumbel")).to(log_probs.device)
    return gumbel_softmax(log_probs, noise, temperature, hard)


@contextlib.contextmanager
def patched_noise() -> Iterator[None]:
    """Within the block, the action networks' reparameterised samples and
    the Gumbel noise of both packages draw from ``NOISE``.  A jitted JAX
    program draws its noise while it is traced, so reset ``NOISE`` before
    tracing it and before each port call that must see the same noise."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_action, "reparameterized_sample", _jax_reparameterized)
        mp.setattr(jax_caddy, "gumbel_softmax_sample", _jax_gumbel)
        mp.setattr(port_action, "reparameterized_sample", _port_reparameterized)
        mp.setattr(port_caddy, "gumbel_softmax_sample", _port_gumbel)
        yield


# ModelOutput fields that hold images, NHWC in JAX and NCHW in the port.
IMAGE_FIELDS = {"reconstructed_observations", "multiresolution_reconstructed_observations",
                "reconstructed_states", "states", "hidden_states", "attention",
                "reconstructed_attention", "reconstructed_hidden_states"}


def to_port_layout(name: str, value) -> np.ndarray:
    """A JAX ``ModelOutput`` field's value in the port's layout."""
    value = np.asarray(value)
    return value.transpose(0, 1, 4, 2, 3) if name in IMAGE_FIELDS else value


# --------------------------------------------------------------------- #
# The metric backbones (FID Inception, FVD I3D)                         #
# --------------------------------------------------------------------- #


def assert_tap_close(got: np.ndarray, want: np.ndarray, name: str) -> None:
    """``tests/test_backbone_parity.py``'s tolerance across backends."""
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    assert np.isfinite(scale) and scale > 1e-3, name
    np.testing.assert_allclose(got, want, atol=2e-3 * max(scale, 0.1), rtol=5e-3, err_msg=name)


def jax_taps(model, variables, x):
    """The JAX model's output and its ``Mixed_*`` blocks' outputs."""
    out, state = model.apply(variables, x, capture_intermediates=lambda mdl, method: (
        method == "__call__" and mdl.name is not None and mdl.name.startswith("Mixed")))
    taps = {name: np.asarray(v["__call__"][0]) for name, v in state["intermediates"].items()}
    return np.asarray(out), taps


def port_taps(model, x: torch.Tensor, channels_last):
    """The port model's output and its ``Mixed_*`` children's outputs, in
    the JAX layout (``channels_last`` moves dim 1 last)."""
    taps, hooks = {}, []
    for name, child in model.named_children():
        if name.startswith("Mixed"):
            hooks.append(child.register_forward_hook(
                lambda m, i, o, name=name: taps.__setitem__(name, channels_last(o))))
    with torch.no_grad():
        out = model(x).numpy()
    for hook in hooks:
        hook.remove()
    return out, taps


def shapes_by_path(tree) -> dict:
    return {jax.tree_util.keystr(path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
