"""Parity of the port's kernel modules (ops/cuda) with the Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the JAX package's Pallas kernel in interpret mode.  On a GPU,
``chip_smoke.py`` holds each CUDA kernel against its plain version at every
shape of the flagship play step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nchw, nhwc

from playablevideogeneration_tpu.ops.pallas import convlstm_gates as jax_gates
from playablevideogeneration_tpu.ops.pallas import fused_norm_act as jax_norm_act
from playablevideogeneration_tpu_torch.ops.cuda import build
from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import fused_lstm_gates
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    fold_batch_norm,
    fused_scale_shift_leaky_relu,
)

# (batch, H, W, channels); rows = batch*H*W.  The second and third are
# ragged against the Pallas 512-row tile, the third (1000 rows, 65
# channels) also against any power-of-two channel layout.
GATE_SHAPES = [(2, 4, 4, 8), (3, 7, 5, 8), (1, 10, 100, 65)]


def _gate_inputs(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    gates = rng.normal(size=(b, h, w, 4 * c)).astype(np.float32) * 2.0
    cell = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return gates, cell


@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_gate_update_matches_pallas_kernel(shape):
    gates, cell = _gate_inputs(sum(shape), *shape)
    want_h, want_c = jax_gates.fused_lstm_gates(
        jnp.asarray(gates), jnp.asarray(cell), use_pallas=False, interpret=True)
    ref_h, ref_c = jax_gates._gate_math(jnp.asarray(gates), jnp.asarray(cell))
    before = fused_lstm_gates.launches
    got_h, got_c = fused_lstm_gates(nchw(gates), nchw(cell))
    assert fused_lstm_gates.launches == before  # CPU tensors launch nothing
    for got, want, ref in ((got_h, want_h, ref_h), (got_c, want_c, ref_c)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _norm_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    channels = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    bias = rng.normal(size=channels).astype(np.float32)
    mean = rng.normal(size=channels).astype(np.float32)
    var = rng.uniform(0.5, 2.0, channels).astype(np.float32)
    return x, (scale, bias, mean, var)


@pytest.mark.parametrize("shape", [(2, 6, 6, 16), (1, 5, 7, 65), (1, 32, 32, 65)])
def test_norm_act_matches_pallas_kernel(shape):
    x, stats = _norm_inputs(len(shape) + shape[-1], shape)
    a_jax, b_jax = jax_norm_act.fold_batch_norm(*map(jnp.asarray, stats), eps=1e-5)
    want = jax_norm_act.fused_scale_shift_leaky_relu(
        jnp.asarray(x), a_jax, b_jax, interpret=True)
    a, b = fold_batch_norm(*map(torch.from_numpy, stats), eps=1e-5)
    # XLA may compute the fold as scale * rsqrt(var + eps): 1 ulp apart.
    np.testing.assert_allclose(a.numpy(), np.asarray(a_jax), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_jax), rtol=1e-6, atol=1e-6)
    got = fused_scale_shift_leaky_relu(nchw(x), a, b)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_norm_act_bf16_rounds_coefficients_like_pallas_kernel():
    """bf16 storage: the Pallas kernel rounds a, b to x's dtype before its
    f32 math; the port's caller does the same rounding before the call."""
    x, stats = _norm_inputs(11, (1, 8, 8, 65))
    x_bf16 = jnp.asarray(x).astype(jnp.bfloat16)
    a_jax, b_jax = jax_norm_act.fold_batch_norm(*map(jnp.asarray, stats), eps=1e-5)
    want = jax_norm_act.fused_scale_shift_leaky_relu(x_bf16, a_jax, b_jax,
                                                     interpret=True)
    a, b = fold_batch_norm(*map(torch.from_numpy, stats), eps=1e-5)
    x_torch = nchw(np.asarray(x_bf16.astype(jnp.float32))).to(torch.bfloat16)
    got = fused_scale_shift_leaky_relu(x_torch, a.to(torch.bfloat16).float(),
                                       b.to(torch.bfloat16).float())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-5, atol=1e-5)


def _bad_gate_inputs():
    g = torch.zeros(1, 8, 3, 3)
    c = torch.zeros(1, 2, 3, 3)
    return {
        "channels": (torch.zeros(1, 6, 3, 3), c),
        "rank": (g.reshape(8, 3, 3), c.reshape(2, 3, 3)),
        "dtype": (g.half(), c.half()),
        "mixed_dtype": (g, c.bfloat16()),
        "strides": (g.transpose(2, 3), c.transpose(2, 3)),
    }


@pytest.mark.parametrize("case", sorted(_bad_gate_inputs()))
def test_gate_wrapper_rejects_bad_inputs(case):
    gates, c = _bad_gate_inputs()[case]
    with pytest.raises((ValueError, TypeError)):
        fused_lstm_gates(gates, c)


def _bad_norm_inputs():
    x = torch.zeros(1, 4, 3, 3)
    a = torch.ones(4)
    return {
        "channels": (x, torch.ones(3), torch.ones(3)),
        "rank": (x[0], a, a),
        "dtype": (x.half(), a, a),
        "coefficient_dtype": (x, a.bfloat16(), a.bfloat16()),
        "strides": (x.transpose(2, 3), a, a),
    }


@pytest.mark.parametrize("case", sorted(_bad_norm_inputs()))
def test_norm_act_wrapper_rejects_bad_inputs(case):
    with pytest.raises((ValueError, TypeError)):
        fused_scale_shift_leaky_relu(*_bad_norm_inputs()[case])


def test_kernel_libraries_are_named_by_source_hash():
    names = build.sources()
    assert {"convlstm_gates", "fused_norm_act"} <= set(names)
    paths = {build.library_path(n) for n in names}
    assert len(paths) == len(names)
    for path in paths:
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"


FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
  shift
done
echo "ptxas info    : Used 1 registers for $src"
case "$src" in *fused_norm_act.cu) echo "error: boom"; exit 2;; esac
echo built > "$out"
"""


def test_build_compiles_each_source_and_raises_with_nvcc_output(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)fused_norm_act.cu.*error: boom"):
        build.build(["convlstm_gates", "fused_norm_act"])
    assert build.library_path("convlstm_gates").read_text() == "built\n"
    assert not build.library_path("fused_norm_act").exists()
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [
        build.library_path("convlstm_gates").name]
    assert build.build(["convlstm_gates"]) == {}
