"""Parity of the port's FID InceptionV3 and Inception Score with the JAX
package, on the CPU.

Both packages run the same seeded numpy variables in the JAX layout
(``random_inception_variables``: the JAX module's names and shapes, He
kernels so that the frames' differences reach the last block, the
BatchNorm statistics away from (0, 1), a 1008-way ``fc`` head), loaded
into the port by ``load_jax_variables``.  Every ``Mixed_*`` block's output and the pool3
features at 128 px, and the extractor at 299, agree within
``tests/test_backbone_parity.py``'s tolerance across backends: atol
2e-3 * max(scale, 0.1) and rtol 5e-3, scale the largest magnitude of the
JAX values (94 convolutions and BatchNorms summed in other orders; a
wrong pool or padding moves a block's output by 10-100 %).  The class
probabilities agree within 1e-5, the FID average pool within 1e-6, the
resize to 299 within 1e-5, and the Inception Score within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    assert_tap_close, jax_taps, port_taps, shapes_by_path, single_threaded_torch)

from playablevideogeneration_tpu.evaluation.metrics import inception as jax_inception
from playablevideogeneration_tpu_torch.evaluation.metrics import inception
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables

SIZE = 128  # the deepest blocks at 2x2, so every pool still mixes pixels
MIXED = ["Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
         "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"]


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def variables():
    """Seeded variables in the JAX layout (``test_random_variables_have_the_jax_layout``)
    with a 1008-way ``fc`` head."""
    return inception.random_inception_variables(21, with_fc=True)


def backbone(variables):
    return {"params": {k: v for k, v in variables["params"].items() if k != "fc"},
            "batch_stats": variables["batch_stats"]}


def frames(seed, n, size):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def taps(variables):
    x = frames(2, 2, SIZE)
    with jax.default_matmul_precision("highest"):
        want_out, want = jax_taps(jax_inception.InceptionV3FID(input_size=SIZE),
                                  backbone(variables), jnp.asarray(x))
    model = load_jax_variables(inception.InceptionV3FID(input_size=SIZE),
                               backbone(variables)).eval()
    got_out, got = port_taps(model, torch.from_numpy(x).permute(0, 3, 1, 2), nhwc)
    want["pool3"], got["pool3"] = want_out, got_out
    return got, want


@pytest.mark.parametrize("name", MIXED + ["pool3"])
def test_taps_match_jax(taps, name):
    got, want = taps
    assert sorted(got) == sorted(want) == sorted(MIXED + ["pool3"])
    assert_tap_close(got[name], want[name], name)
    if name == "pool3":
        assert got[name].shape == (2, 2048)


def test_random_variables_have_the_jax_layout():
    """``random_inception_variables`` has the JAX module's tree, names and
    shapes (and the converter's ``fc`` when asked), and loads into the
    port's module."""
    want = jax.eval_shape(jax_inception.random_inception_variables, jax.random.PRNGKey(0))
    for with_fc in (False, True):
        got = inception.random_inception_variables(3, with_fc=with_fc)
        fc = got["params"].pop("fc", None)
        assert (fc is not None) == with_fc
        assert shapes_by_path(got) == shapes_by_path(want)
        assert all(leaf.dtype == np.float32 for leaf in jax.tree_util.tree_leaves(got))
    assert fc["kernel"].shape == (2048, 1008) and fc["bias"].shape == (1008,)
    bn = got["batch_stats"]["Mixed_5b"]["branch1x1"]["bn"]
    assert 0.8 <= bn["var"].min() and bn["var"].max() <= 1.2 and np.abs(bn["mean"]).max() > 0
    again = inception.random_inception_variables(3, with_fc=False)
    np.testing.assert_array_equal(again["params"]["Conv2d_1a_3x3"]["conv"]["kernel"],
                                  got["params"]["Conv2d_1a_3x3"]["conv"]["kernel"])
    model = inception.make_inception(got, device="cpu")
    np.testing.assert_array_equal(
        model.Conv2d_1a_3x3.conv.weight.numpy(),
        got["params"]["Conv2d_1a_3x3"]["conv"]["kernel"].transpose(3, 2, 0, 1))


def test_fid_extractor_matches_jax(variables):
    """``make_fid_extractor`` at 299 (64 px frames resized up): numpy in,
    (N, 2048) numpy out."""
    x = frames(3, 2, 64)
    want = np.asarray(jax_inception.make_fid_extractor(variables)(x))
    extract = inception.make_fid_extractor(variables, device="cpu")
    got = extract(x)
    assert extract.model.input_size == 299
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert_tap_close(got, want, "pool3 at 299")


def test_class_probabilities_match_jax(variables):
    x = frames(4, 2, 64)
    want = np.asarray(jax_inception.make_class_probability_fn(variables)(x))
    got = inception.make_class_probability_fn(variables, device="cpu")(x)
    assert got.shape == (2, 1008)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="no classifier head"):
        inception.make_class_probability_fn(backbone(variables), device="cpu")


def test_avg_pool_without_padding_count_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 9, 7, 5)).astype(np.float32)
    want = np.asarray(jax_inception._avg_pool_3x3_no_pad_count(jnp.asarray(x)))
    got = nhwc(inception._avg_pool_3x3_no_pad_count(torch.from_numpy(x).permute(0, 3, 1, 2)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # A corner averages its 4 pixels, not 9.
    np.testing.assert_allclose(got[:, 0, 0], x[:, :2, :2].mean(axis=(1, 2)), rtol=1e-6)


@pytest.mark.parametrize("size", [64, 320])
def test_input_resize_to_299_matches_jax(variables, size):
    """The resize inside the model (the first convolution's input is
    ``2 * resize(x) - 1``) against ``jax.image.resize(..., "linear")``: up
    from 64 px and down from 320, where plain bilinear interpolation
    would differ."""
    x = frames(6, 1, size)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), "linear"))
    model = inception.make_inception(variables, device="cpu")
    seen = []
    model.Conv2d_1a_3x3.register_forward_pre_hook(
        lambda m, args: seen.append((nhwc(args[0]) + 1.0) / 2.0))
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(seen[0], want, rtol=1e-5, atol=1e-5)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), (299, 299),
                                            mode="bilinear", align_corners=False)
    assert (np.abs(nhwc(plain) - want).max() > 1e-2) == (size > 299)


@pytest.mark.parametrize("splits", [10, 3])
def test_inception_score_matches_jax(splits):
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 2, (23, 1008))
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    got = inception.inception_score(probs, splits)
    want = jax_inception.inception_score(probs, splits)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert got[0] > 1.0
    uniform = np.full((4, 10), 0.1)
    assert inception.inception_score(uniform) == pytest.approx((1.0, 0.0))

