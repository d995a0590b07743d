"""Parity of the port's FVD I3D with the JAX package, on the CPU; and the
weight bridge's 3-D convolution kernels.

Both packages run the same seeded numpy variables in the JAX layout
(``random_i3d_variables``: the JAX module's names and shapes, He kernels,
the BatchNorm statistics away from (0, 1)), loaded into the port by
``load_jax_variables``.  Every
``Mixed_*`` block's output and the logits at 64 px x 8 frames, and the
embedder at 224, agree within ``tests/test_backbone_parity.py``'s
tolerance across backends (atol 2e-3 * max(scale, 0.1), rtol 5e-3);
TensorFlow's ``SAME`` padding of a stride-2 convolution and max pool
within 1e-5 at an odd and an even length; the resize of 256 px frames to
224 within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    assert_tap_close, jax_taps, port_taps, random_variables, shapes_by_path,
    single_threaded_torch)

from playablevideogeneration_tpu.evaluation.metrics import i3d as jax_i3d
from playablevideogeneration_tpu_torch.evaluation.metrics import i3d
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables

SIZE, FRAMES = 64, 8  # Mixed_5x at 2x2x2, so every pool still mixes pixels
MIXED = ["Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f",
         "Mixed_5b", "Mixed_5c"]


def ndhwc(x: torch.Tensor) -> np.ndarray:
    """(N, C, D, H, W) -> the JAX layout (N, D, H, W, C)."""
    return x.permute(0, 2, 3, 4, 1).numpy()


def port_layout(videos: np.ndarray) -> torch.Tensor:
    """(N, T, H, W, 3) numpy -> the port's (N, T, 3, H, W)."""
    return torch.from_numpy(videos).permute(0, 1, 4, 2, 3)


def videos(seed, n, frames, size):
    return np.random.default_rng(seed).uniform(0, 1, (n, frames, size, size, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def variables():
    """Seeded variables in the JAX layout (``test_random_variables_have_the_jax_layout``)."""
    return i3d.random_i3d_variables(31)


@pytest.fixture(scope="module")
def taps(variables):
    x = videos(5, 1, FRAMES, SIZE)
    with jax.default_matmul_precision("highest"):
        want_out, want = jax_taps(jax_i3d.I3D(input_size=SIZE), variables, jnp.asarray(x))
    model = load_jax_variables(i3d.I3D(input_size=SIZE), variables).eval()
    got_out, got = port_taps(model, port_layout(x), ndhwc)
    want["logits"], got["logits"] = want_out, got_out
    return got, want


@pytest.mark.parametrize("name", MIXED + ["logits"])
def test_taps_match_jax(taps, name):
    got, want = taps
    assert sorted(got) == sorted(want) == sorted(MIXED + ["logits"])
    assert_tap_close(got[name], want[name], name)
    if name == "logits":
        assert got[name].shape == (1, 400)


def test_random_variables_have_the_jax_layout():
    """``random_i3d_variables`` has the JAX module's tree, names and shapes
    (BatchNorms with a bias and statistics but no scale) and loads into the
    port's module."""
    want = jax.eval_shape(jax_i3d.random_i3d_variables, jax.random.PRNGKey(0))
    got = i3d.random_i3d_variables(4)
    assert shapes_by_path(got) == shapes_by_path(want)
    assert sorted(got["params"]["Conv3d_1a_7x7"]["bn"]) == ["bias"]
    model = i3d.make_i3d(got, device="cpu")
    assert model.Conv3d_1a_7x7.bn.weight is None
    np.testing.assert_array_equal(
        model.Mixed_3b.Branch_1b.conv3d.weight.numpy(),
        got["params"]["Mixed_3b"]["Branch_1b"]["conv3d"]["kernel"].transpose(4, 3, 0, 1, 2))


def test_fvd_embedder_matches_jax(variables):
    """``make_fvd_embedder`` at 224 (48 px frames resized up): numpy in,
    (N, 400) numpy out."""
    x = videos(6, 2, 3, 48)
    want = np.asarray(jax_i3d.make_fvd_embedder(variables)(x))
    embed = i3d.make_fvd_embedder(variables, device="cpu")
    got = embed(x)
    assert embed.model.input_size == 224
    assert isinstance(got, np.ndarray) and got.shape == (2, 400)
    assert_tap_close(got, want, "logits at 224")


@pytest.mark.parametrize("frames", [7, 8])
def test_same_padding_matches_jax(frames):
    """A stride-2 7x7x7 unit and a stride-2 3x3x3 max pool on an odd and an
    even length (and odd, uneven spatial sizes): TensorFlow's ``SAME`` puts
    the smaller half of the padding in front, and the pool pads with
    -inf."""
    x = np.random.default_rng(frames).normal(size=(1, frames, 9, 12, 3)).astype(np.float32)
    unit = jax_i3d.Unit3D(4, (7, 7, 7), (2, 2, 2))
    tree = random_variables(jax.eval_shape(unit.init, jax.random.PRNGKey(0), x), seed=frames)
    want = np.asarray(unit.apply(tree, jnp.asarray(x)))
    port = load_jax_variables(i3d.Unit3D(3, 4, (7, 7, 7), (2, 2, 2)), tree).eval()
    with torch.no_grad():
        got = ndhwc(port(torch.from_numpy(x).permute(0, 4, 1, 2, 3)))
    assert got.shape == want.shape == (1, (frames + 1) // 2, 5, 6, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    negative = x - 10.0  # padded with zeros, the border maxima would be 0
    want = np.asarray(jax_i3d._max_pool_3d(jnp.asarray(negative), (3, 3, 3), (2, 2, 2)))
    got = ndhwc(i3d.max_pool_same(torch.from_numpy(negative).permute(0, 4, 1, 2, 3),
                                  (3, 3, 3), (2, 2, 2)))
    np.testing.assert_array_equal(got, want)
    assert (got < 0).all()


def test_resize_of_256_px_frames_to_224_matches_jax(variables):
    """BAIR's 256 px frames shrink to 224 frame by frame, so the resize
    must antialias as ``jax.image.resize`` does: the first unit's input
    against it, and plain bilinear interpolation far from it."""
    x = videos(8, 1, 2, 256)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, 224, 224, 3), "linear"))
    model = i3d.make_i3d(variables, device="cpu")
    seen = []
    model.Conv3d_1a_7x7.register_forward_pre_hook(
        lambda m, args: seen.append((ndhwc(args[0]) + 1.0) / 2.0))
    with torch.no_grad():
        model(port_layout(x))
    np.testing.assert_allclose(seen[0], want, rtol=1e-5, atol=1e-5)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x[0]).permute(0, 3, 1, 2),
                                            (224, 224), mode="bilinear", align_corners=False)
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want[0]).max() > 1e-2


def test_3d_kernels_load_with_depth_height_and_width_in_place():
    """A cubic flax 3-D kernel (kd, kh, kw, in, out) whose every element
    encodes its indices must land at weight[o, i, d, h, w]: the reversed
    transpose has the same shape and would load silently.  The loaded
    convolution equals flax's on an input that is not symmetric."""
    d, h, w, i, o = np.indices((3, 3, 3, 2, 4))
    kernel = (10000 * d + 1000 * h + 100 * w + 10 * i + o).astype(np.float32)
    conv = torch.nn.Conv3d(2, 4, 3, bias=False)
    load_jax_variables(conv, {"params": {"kernel": kernel}})
    weight = conv.weight.detach().numpy()
    for index in [(3, 1, 0, 1, 2), (0, 0, 2, 0, 1), (1, 1, 1, 2, 0)]:
        o_, i_, d_, h_, w_ = index
        assert weight[index] == kernel[d_, h_, w_, i_, o_]
    assert not np.array_equal(weight, kernel.T)

    x = np.random.default_rng(9).normal(size=(1, 5, 6, 7, 2)).astype(np.float32)
    flax_conv = jax_i3d.nn.Conv(4, (3, 3, 3), padding="VALID", use_bias=False)
    want = np.asarray(flax_conv.apply({"params": {"kernel": jnp.asarray(kernel / 1e4)}},
                                      jnp.asarray(x)))
    load_jax_variables(conv, {"params": {"kernel": kernel / 1e4}})
    with torch.no_grad():
        got = ndhwc(conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_dense_kernels_still_load_transposed():
    """The 2-D case (the Inception Score's ``fc``): (in, out) -> weight
    (out, in), unchanged by the 3-D fix."""
    kernel = np.arange(12, dtype=np.float32).reshape(3, 4)
    linear = load_jax_variables(torch.nn.Linear(3, 4),
                                {"params": {"kernel": kernel, "bias": np.ones(4)}})
    np.testing.assert_array_equal(linear.weight.detach().numpy(), kernel.T)
    np.testing.assert_array_equal(linear.bias.detach().numpy(), np.ones(4))
