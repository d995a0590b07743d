"""Parity of the port's kernel modules (ops/cuda) with the Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the JAX package's Pallas kernel in interpret mode (the gate
backward through ``jax.vjp`` of its custom VJP).  On a GPU,
``chip_smoke.py`` holds each CUDA kernel against its plain version at every
shape of the flagship's play and training steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    nchw, nhwc, single_threaded_torch)

from playablevideogeneration_tpu.ops.pallas import convlstm_gates as jax_gates
from playablevideogeneration_tpu.ops.pallas import fused_norm_act as jax_norm_act
from playablevideogeneration_tpu_torch.ops.cuda import build
from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import (
    fused_lstm_gates,
    fused_lstm_gates_bwd,
)
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    fold_batch_norm,
    fused_batch_norm_leaky_relu,
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


def _cotangents(seed, b, h, w, c):
    rng = np.random.default_rng(seed + 100)
    return tuple(rng.normal(size=(b, h, w, c)).astype(np.float32) for _ in range(2))


def _jax_gate_vjps(gates, cell, dh, dc):
    """(dgates, dc_prev) from the Pallas custom VJP in interpret mode and
    from autodiff of the plain ``_gate_math``."""
    cotangents = (jnp.asarray(dh), jnp.asarray(dc))
    outs = []
    for fn in (lambda g, c: jax_gates.fused_lstm_gates(g, c, use_pallas=False, interpret=True),
               jax_gates._gate_math):
        _, vjp = jax.vjp(fn, jnp.asarray(gates), jnp.asarray(cell))
        outs.append(tuple(np.asarray(x) for x in vjp(cotangents)))
    return outs


@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_gate_backward_matches_pallas_kernel(shape):
    """K2's plain version, and the autograd function around K1 and K2, hold
    against the Pallas backward kernel and against ``jax.vjp`` of the
    plain gate math."""
    gates, cell = _gate_inputs(sum(shape), *shape)
    dh, dc = _cotangents(sum(shape), *shape)
    wants = _jax_gate_vjps(gates, cell, dh, dc)

    before = fused_lstm_gates_bwd.launches
    direct = fused_lstm_gates_bwd(nchw(gates), nchw(cell), nchw(dh), nchw(dc))
    g, c = nchw(gates).requires_grad_(), nchw(cell).requires_grad_()
    new_h, new_c = fused_lstm_gates(g, c)
    through_autograd = torch.autograd.grad((new_h, new_c), (g, c), (nchw(dh), nchw(dc)))
    assert fused_lstm_gates_bwd.launches == before  # CPU tensors launch nothing
    # XLA's and PyTorch's f32 sigmoid and tanh differ by a few ulp, which
    # the backward's products of up to five factors carry: atol 1e-5 on
    # values of order 1.
    for got in (direct, through_autograd):
        for want in wants:
            for tensor, expected in zip(got, want):
                assert tensor.dtype == torch.float32 and tensor.is_contiguous()
                np.testing.assert_allclose(nhwc(tensor), expected, rtol=1e-5, atol=1e-5)


def test_gate_backward_takes_an_unused_cell_cotangent():
    """After the last step only h' is used: autograd hands the function a
    zero dc, and the result equals the VJP with dc = 0."""
    shape = (2, 3, 5, 8)
    gates, cell = _gate_inputs(7, *shape)
    dh, _ = _cotangents(7, *shape)
    want = _jax_gate_vjps(gates, cell, dh, np.zeros_like(dh))[0]
    g, c = nchw(gates).requires_grad_(), nchw(cell).requires_grad_()
    new_h, _ = fused_lstm_gates(g, c)
    got = torch.autograd.grad(new_h, (g, c), nchw(dh))
    for tensor, expected in zip(got, want):
        np.testing.assert_allclose(nhwc(tensor), expected, rtol=1e-5, atol=1e-5)


def test_gate_backward_keeps_the_storage_dtype():
    """bf16 storage: dgates comes back in gates' dtype and dc_prev in c's,
    from f32 math rounded once, as the Pallas kernel writes them."""
    shape = (1, 4, 4, 8)
    gates, cell = _gate_inputs(3, *shape)
    dh, dc = _cotangents(3, *shape)
    args = [nchw(x).to(torch.bfloat16) for x in (gates, cell, dh, dc)]
    dgates, dc_prev = fused_lstm_gates_bwd(*args)
    assert dgates.dtype == dc_prev.dtype == torch.bfloat16
    want = _jax_gate_vjps(*[nhwc(x) for x in args])[0]
    for tensor, expected in zip((dgates, dc_prev), want):
        np.testing.assert_allclose(nhwc(tensor), expected, rtol=2 ** -7, atol=1e-6)


def test_gate_function_under_activation_checkpointing():
    """The autograd function rerun by ``torch.utils.checkpoint`` gives the
    gradients of the plain run."""
    from torch.utils.checkpoint import checkpoint

    gates, cell = _gate_inputs(9, 2, 4, 4, 8)
    grads = []
    for use_checkpoint in (False, True):
        g, c = nchw(gates).requires_grad_(), nchw(cell).requires_grad_()
        fn = lambda a, b: fused_lstm_gates(a * 1.5, b)[0].square().sum()  # noqa: E731
        loss = checkpoint(fn, g, c, use_reentrant=False) if use_checkpoint else fn(g, c)
        grads.append(torch.autograd.grad(loss, (g, c)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


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
    """The port takes the raw statistics and folds them itself; the JAX
    reference folds them with its own ``fold_batch_norm`` and runs the
    Pallas kernel in interpret mode."""
    x, stats = _norm_inputs(len(shape) + shape[-1], shape)
    a_jax, b_jax = jax_norm_act.fold_batch_norm(*map(jnp.asarray, stats), eps=1e-5)
    want = jax_norm_act.fused_scale_shift_leaky_relu(
        jnp.asarray(x), a_jax, b_jax, interpret=True)
    a, b = fold_batch_norm(*map(torch.from_numpy, stats), eps=1e-5)
    # XLA may compute the fold as scale * rsqrt(var + eps): 1 ulp apart.
    np.testing.assert_allclose(a.numpy(), np.asarray(a_jax), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_jax), rtol=1e-6, atol=1e-6)
    got = fused_batch_norm_leaky_relu(nchw(x), *map(torch.from_numpy, stats), 1e-5)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_norm_act_bf16_rounds_coefficients_like_pallas_kernel():
    """bf16 storage: the Pallas kernel rounds a, b to x's dtype before its
    f32 math; the port rounds its own fold of the raw statistics the same
    way (inside the kernel on the card, in the plain version here)."""
    x, stats = _norm_inputs(11, (1, 8, 8, 65))
    x_bf16 = jnp.asarray(x).astype(jnp.bfloat16)
    a_jax, b_jax = jax_norm_act.fold_batch_norm(*map(jnp.asarray, stats), eps=1e-5)
    want = jax_norm_act.fused_scale_shift_leaky_relu(x_bf16, a_jax, b_jax,
                                                     interpret=True)
    x_torch = nchw(np.asarray(x_bf16.astype(jnp.float32))).to(torch.bfloat16)
    got = fused_batch_norm_leaky_relu(x_torch, *map(torch.from_numpy, stats), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-5, atol=1e-5)
    # Unrounded coefficients give another answer: the rounding is pinned.
    a, b = fold_batch_norm(*map(torch.from_numpy, stats), eps=1e-5)
    unrounded = (x_torch.float() * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))
    unrounded = torch.where(unrounded >= 0, unrounded, unrounded * 0.2).bfloat16()
    assert not torch.equal(unrounded, got)


def test_eval_batch_norm_leaky_relu_is_one_wrapper_call(monkeypatch):
    """In evaluation mode a BatchNorm followed by LeakyReLU hands its raw
    parameters and running statistics to the fused wrapper and runs no
    other operation: on the card a call is one launch, with no fold or
    cast around it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from playablevideogeneration_tpu_torch.models import layers

    class RecordOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    calls = []
    monkeypatch.setattr(layers, "fused_batch_norm_leaky_relu",
                        lambda *args: calls.append(args) or args[0])
    norm = layers.BatchNorm(4, activation="leaky_relu").eval()
    x = torch.ones(1, 4, 3, 3, dtype=torch.bfloat16)
    with RecordOps() as recorded:
        y = norm(x)
    assert recorded.ops == [] and y is x and len(calls) == 1
    assert all(got is want for got, want in zip(
        calls[0], (x, norm.weight, norm.bias, norm.running_mean, norm.running_var)))
    assert calls[0][5] == layers.EPS


@pytest.mark.parametrize("dtype,elements,length,offset,rows,want", [
    (torch.float32, 4, 4 * 9, 0, None, 4),
    (torch.bfloat16, 8, 8 * 9, 0, None, 8),
    (torch.bfloat16, 4, 4 * 9, 0, None, 4),     # K1's 8-byte bf16 packs
    (torch.bfloat16, 8, 4 * 9, 0, None, 1),     # a multiple of 4, not of 8
    (torch.float32, 4, 5 * 7 * 9, 0, None, 1),  # ragged: C*H*W of (3, 5, 7, 9)
    (torch.bfloat16, 8, 5 * 7 * 9, 0, None, 1),
    (torch.float32, 4, 4 * 9, 1, None, 1),      # storage one element into its buffer
    (torch.bfloat16, 8, 8 * 9, 1, None, 1),
    (torch.bfloat16, 4, 4 * 9, 1, None, 1),
    (torch.float32, 4, 4 * 9, 4, None, 4),      # 16 bytes into its buffer: aligned again
    (torch.bfloat16, 4, 4 * 9, 4, None, 4),     # 8 bytes in: aligned for an 8-byte pack
    (torch.bfloat16, 8, 8 * 9, 4, None, 1),     # ... but not for a 16-byte one
    (torch.bfloat16, 8, 8 * 9, 0, 3, 1),        # too few bytes: at the launch floor
])
def test_vector_width_needs_whole_aligned_packs(dtype, elements, length, offset, rows, want):
    """The kernels take packs of ``elements`` per access only where every
    run of ``length`` elements is whole packs, every tensor is aligned to a
    pack and the launch moves enough bytes to leave the launch floor;
    otherwise the same kernel runs one element per thread."""
    rows = rows or build.MIN_PACKED_BYTES // (length * dtype.itemsize) + 1
    view = torch.zeros(offset + rows * length, dtype=dtype)[offset:].view(rows, length)
    fresh = torch.zeros(rows, length, dtype=dtype)
    assert view.is_contiguous() and fresh.data_ptr() % 16 == 0
    assert build.vector_width(length, fresh, view, elements=elements) == want
    assert build.vector_width(length, view, fresh, elements=elements) == want


def test_wrappers_reject_planes_beyond_32_bit_offsets():
    """K1's and K2's offsets inside a batch slice, and K3's batch rows and
    offsets inside a row, are 32-bit."""
    c = torch.empty(1, 2 ** 29, 1, 1, device="meta")
    gates = torch.empty(1, 2 ** 31, 1, 1, device="meta")
    with pytest.raises(ValueError, match=r"2\*\*31"):
        fused_lstm_gates(gates, c)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        fused_lstm_gates_bwd(gates, c, c, c)
    stat = torch.empty(1, device="meta")
    for x in (torch.empty(1, 1, 2 ** 16, 2 ** 15, device="meta"),
              torch.empty(2 ** 31, 1, 1, 1, device="meta")):
        with pytest.raises(ValueError, match=r"2\*\*31"):
            fused_batch_norm_leaky_relu(x, stat, stat, stat, stat)


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


def _bad_gate_backward_inputs():
    g = torch.zeros(1, 8, 3, 3)
    c = torch.zeros(1, 2, 3, 3)
    return {
        "cotangent_shape": (g, c, torch.zeros(1, 2, 3, 4), c),
        "cotangent_dtype": (g, c, c.bfloat16(), c),
        "cotangent_strides": (g, c, c.transpose(2, 3), c),
        "device": tuple(t.to("meta") for t in (g, c, c, c)),
    }


@pytest.mark.parametrize("case", sorted(_bad_gate_backward_inputs()))
def test_gate_backward_wrapper_rejects_bad_inputs(case):
    """Only CPU tensors take the plain version; any other device launches
    the kernel (CUDA) or raises."""
    with pytest.raises((ValueError, TypeError)):
        fused_lstm_gates_bwd(*_bad_gate_backward_inputs()[case])


def _bad_norm_inputs():
    x = torch.zeros(1, 4, 3, 3)
    s = torch.ones(4)
    return {
        "channels": (x, torch.ones(3), s, s, torch.ones(3)),
        "rank": (x[0], s, s, s, s),
        "dtype": (x.half(), s, s, s, s),
        "coefficient_dtype": (x, s.bfloat16(), s, s, s),
        "strides": (x.transpose(2, 3), s, s, s, s),
        "mean_shape": (x, s, s, torch.ones(4, 1), s),
        "var_dtype": (x, s, s, s, s.double()),
        "statistics_device": (x, s, s, s.to("meta"), s),
        "statistics_strides": (x, s, torch.ones(8)[::2], s, s),
        "device": tuple(t.to("meta") for t in (x, s, s, s, s)),
    }


@pytest.mark.parametrize("case", sorted(_bad_norm_inputs()))
def test_norm_act_wrapper_rejects_bad_inputs(case):
    """Shapes, dtypes, devices and contiguity of x and of the four
    statistics vectors; only CPU tensors take the plain version."""
    with pytest.raises((ValueError, TypeError)):
        fused_batch_norm_leaky_relu(*_bad_norm_inputs()[case])


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
