"""The offline evaluation's captured programs on the CPU, through the
capture stand-in (``graphs.StandIn``): the Faster R-CNN detector backend,
the FID extractor, the Inception Score's class probabilities, the FVD
embedder and the dataset evaluator's frame metrics, each against its eager
run (``backend=None`` on the CPU) at tiny sizes.

Graphed and eager outputs agree bit for bit (the same CPU operations on
the same values); a program is captured once per key, a ragged batch and a
changed TF32 switch being new keys; a result handed out is the caller's;
no replay makes a tensor from host data.  One case holds the graphed
frame metrics against the JAX package's ``_compute_frame_metrics`` at the
tolerance of tests/test_torch_offline_eval.py (rtol 1e-4, atol 1e-9).
"""
import functools
import gc
import types
import weakref
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_variables, single_threaded_torch  # noqa: F401

from playablevideogeneration_tpu.evaluation import dataset_evaluator as jax_evaluator
from playablevideogeneration_tpu.evaluation.metrics import lpips as jax_lpips
from playablevideogeneration_tpu.models import vgg as jax_vgg
from playablevideogeneration_tpu_torch.evaluation.dataset_evaluator import DatasetEvaluator
from playablevideogeneration_tpu_torch.evaluation.metrics import frcnn, i3d, inception, lpips
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.utils.logging import Logger
from playablevideogeneration_tpu_torch.utils.pretrained import make_metric_vgg

METRIC_TOL = dict(rtol=1e-4, atol=1e-9)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
# The backbones' input sizes, cut from 299 and 224 so that a CPU forward
# takes well under a second.
INCEPTION_SIZE, I3D_SIZE = 75, 32
CASES = ["detector", "fid", "class_probabilities", "fvd", "frame_metrics"]
# The cases of the key tests, which hold ``graphs.replayed``'s keys: the
# detector, whose CPU forward is the slowest, shares them.
BACKBONES = CASES[1:]


@pytest.fixture(scope="module")
def weights():
    variables = frcnn.random_frcnn_variables(3)
    variables["params"]["box_head"]["cls_score"]["bias"][frcnn.PERSON_LABEL] += 4.5
    return dict(frcnn=variables, inception=inception.random_inception_variables(4),
                i3d=i3d.random_i3d_variables(5))


def _evaluator(vgg_variables=None, backend=None) -> DatasetEvaluator:
    config = {"evaluation": {"batching": {"batch_size": 1, "num_workers": 1}}}
    heads = [np.random.default_rng(6).uniform(0, 1, c).astype(np.float32)
             for c in LPIPS_CHANNELS]
    return DatasetEvaluator(config, Logger(), [], [], vgg_variables=vgg_variables,
                            lpips_fn=lpips.make_lpips_fn(make_metric_vgg(vgg_variables, "cpu"),
                                                         heads),
                            detector=types.SimpleNamespace(), device="cpu", backend=backend)


def _make(name: str, weights: dict, backend):
    """(the function under test, its ProgramCache)."""
    if name == "detector":
        fn = frcnn.make_person_box_backend(weights["frcnn"], min_size=64, max_size=128,
                                           device="cpu", backend=backend)
        return fn.detect, fn.programs
    if name == "fid":
        fn = inception.make_fid_extractor(weights["inception"], "cpu", backend=backend)
        fn.model.input_size = INCEPTION_SIZE
        return fn, fn.programs
    if name == "class_probabilities":
        fn = inception.make_class_probability_fn(weights["inception"], "cpu", backend=backend)
        fn.model.input_size = INCEPTION_SIZE
        return fn, fn.programs
    if name == "fvd":
        fn = i3d.make_fvd_embedder(weights["i3d"], "cpu", backend=backend)
        fn.model.input_size = I3D_SIZE
        return fn, fn.programs
    evaluator = _evaluator(backend=backend)
    return evaluator._compute_frame_metrics, evaluator._frame_metrics.programs


def _inputs(name: str, seed: int, n: int = 2) -> tuple:
    rng = np.random.default_rng(seed)
    if name == "detector":  # one frame: a CPU forward takes seconds (RoIAlign)
        n -= 1
        return (rng.uniform(0, 1, (n, 64, 96, 3)).astype(np.float32),)
    if name in ("fid", "class_probabilities"):
        return (rng.uniform(0, 1, (n, 32, 32, 3)).astype(np.float32),)
    if name == "fvd":
        return (rng.uniform(0, 1, (n, 8, 24, 24, 3)).astype(np.float32),)
    ref = rng.uniform(0, 1, (n, 3, 32, 32, 3)).astype(np.float32)
    return ref, np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)


def _arrays(out) -> list:
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, tuple) else [out]


def _assert_equal(got, want) -> None:
    got, want = _arrays(got), _arrays(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _captures(programs) -> list:
    return [program.captures for program in programs.values()]


@pytest.mark.parametrize("name", CASES)
def test_graphed_equals_eager_with_one_capture_per_key(name, weights):
    """Two calls of one shape: each bit for bit with the eager run on its
    inputs, one capture, and the first call's result untouched by the
    second (it is the caller's copy, not the static output)."""
    graphed, programs = _make(name, weights, graphs.StandIn)
    eager, _ = _make(name, weights, None)
    first, second = _inputs(name, 1), _inputs(name, 2)
    got_first = graphed(*first)
    got_second = graphed(*second)
    _assert_equal(got_second, eager(*second))
    _assert_equal(got_first, eager(*first))
    assert not all(np.array_equal(a, b) for a, b in zip(_arrays(got_first),
                                                        _arrays(got_second)))
    assert _captures(programs) == [1]
    if name == "detector":
        assert (got_second[1] > 0).any()  # some detections, not only padding


@pytest.mark.parametrize("name", BACKBONES)
def test_a_ragged_batch_is_a_second_key(name, weights):
    graphed, programs = _make(name, weights, graphs.StandIn)
    eager, _ = _make(name, weights, None)
    full, ragged = _inputs(name, 3), _inputs(name, 4, n=1)
    _assert_equal(graphed(*full), eager(*full))
    _assert_equal(graphed(*ragged), eager(*ragged))
    _assert_equal(graphed(*full), eager(*full))
    assert [key[0][0][0] for key in programs] == [1, 2]  # the least recently used first
    assert _captures(programs) == [1, 1]


@pytest.mark.parametrize("name", BACKBONES)
def test_a_changed_tf32_switch_is_a_new_key(name, weights):
    """A graph replays the math modes it recorded with: with cuDNN's or
    cuBLAS's TF32 switched, a call captures its own program."""
    graphed, programs = _make(name, weights, graphs.StandIn)
    x = _inputs(name, 5)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        for cudnn, matmul in [(True, False), (False, False), (False, True), (True, False)]:
            torch.backends.cudnn.allow_tf32 = cudnn
            torch.backends.cuda.matmul.allow_tf32 = matmul
            graphed(*x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert sorted(key[1:] for key in programs) == [(False, False), (False, True), (True, False)]
    assert _captures(programs) == [1, 1, 1]


def _refuse(name):
    def refused(*args, **kwargs):
        raise AssertionError(f"torch.{name} inside a recorded run")
    return refused


def _refuse_moves(to):
    """``Tensor.to`` that refuses to move a tensor to a device (on the card,
    from the host): a cast is allowed."""
    def guarded(self, *args, **kwargs):
        if "device" in kwargs or any(isinstance(a, (torch.device, str)) for a in args):
            raise AssertionError("Tensor.to(device) inside a recorded run")
        return to(self, *args, **kwargs)
    return guarded


class _NoHostData(graphs.StandIn):
    """A stand-in whose replays fail on any tensor made from host data or
    moved to a device."""

    def replay(self):
        with mock.patch.object(torch, "tensor", _refuse("tensor")), \
                mock.patch.object(torch, "as_tensor", _refuse("as_tensor")), \
                mock.patch.object(torch, "from_numpy", _refuse("from_numpy")), \
                mock.patch.object(torch.Tensor, "to", _refuse_moves(torch.Tensor.to)):
            super().replay()


@pytest.mark.parametrize("name", CASES)
def test_a_replay_makes_no_tensor_from_host_data(name, weights):
    """Everything the recorded run needs from the host (the detector's
    ImageNet statistics and anchors, SSIM's window) was made on the device
    before it: a replay that copied from the host would break a capture on
    the card."""
    graphed, programs = _make(name, weights, _NoHostData)
    eager, _ = _make(name, weights, None)
    for seed in (6, 7):
        x = _inputs(name, seed)
        _assert_equal(graphed(*x), eager(*x))
    assert _captures(programs) == [1]


def test_graphed_frame_metrics_match_jax():
    """B = 1, T = 3, 32x32 with converted-layout VGG19 weights and LPIPS
    heads: the graphed frame metrics against the JAX evaluator's jitted
    ``_compute_frame_metrics``."""
    vgg_variables = random_variables(
        jax.eval_shape(jax_vgg.random_vgg_variables, jax.random.PRNGKey(0)), seed=61)
    heads = [np.random.default_rng(6).uniform(0, 1, c).astype(np.float32)
             for c in LPIPS_CHANNELS]
    evaluator = _evaluator(vgg_variables, graphs.StandIn)
    ref, gen = _inputs("frame_metrics", 8, n=1)
    got = evaluator._compute_frame_metrics(ref, gen)
    stub = types.SimpleNamespace(lpips_fn=jax_lpips.make_lpips_fn(
        jax_vgg.make_vgg_apply(vgg_variables), heads))
    want = jax.jit(functools.partial(jax_evaluator.DatasetEvaluator._compute_frame_metrics,
                                     stub))(vgg_variables, jnp.asarray(ref), jnp.asarray(gen))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == (1, 3)
        np.testing.assert_allclose(got[key], np.asarray(value), **METRIC_TOL, err_msg=key)
    assert _captures(evaluator._frame_metrics.programs) == [1]


class _Module(torch.nn.Module):
    pass


def test_program_cache_evicts_the_least_recently_used():
    cache = graphs.ProgramCache(size=2)
    made = []

    def make(key):
        made.append(key)
        return types.SimpleNamespace(key=key)

    for key in ["a", "b", "a", "c", "b", "a"]:
        assert cache.program(key, lambda key=key: make(key)).key == key
    assert made == ["a", "b", "c", "b", "a"]
    assert list(cache) == ["b", "a"]


def test_program_cache_drops_a_stale_program_before_making_its_successor():
    """A program that ``current`` rejects is released before ``make`` runs:
    on the card its graph and pool go before the next capture."""
    cache = graphs.ProgramCache()
    old = cache.program("k", lambda: _Module())
    alive = weakref.ref(old)
    del old

    def make():
        gc.collect()
        assert alive() is None, "the stale program is still referenced"
        return _Module()

    new = cache.program("k", make, current=lambda program: False)
    assert cache["k"] is new and len(cache) == 1
