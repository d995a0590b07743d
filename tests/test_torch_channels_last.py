"""The port's channels-last storage, on the CPU.

CADDY and VGG19 keep every 4-D activation and every convolution weight in
channels-last storage (``torch.channels_last``), so that the card's NHWC
convolutions need no transposing copy.  Forward hooks on every
convolution, BatchNorm and ConvLSTM cell hold a tiny BAIR-shaped training
step (forward, every loss term, backward) and the play route to it, so that
an op that falls back to channels-first (a ``stack``, a ``reshape``, a
resize) shows here.  The gate and norm wrappers' plain versions take both
contiguous storages and give the same values in either; the wrappers
raise on any other strides, and off the CPU on contiguous NCHW, which the
CUDA kernels do not take.
"""
import numpy as np
import pytest
import torch

from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.inference.play_session import PlaySession
from playablevideogeneration_tpu_torch.models import layers
from playablevideogeneration_tpu_torch.models.caddy import Caddy, seeded_init
from playablevideogeneration_tpu_torch.models.vgg import Vgg19, make_vgg
from playablevideogeneration_tpu_torch.ops.cuda import build
from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import (
    _gate_math,
    _gate_math_bwd,
    fused_lstm_gates,
    fused_lstm_gates_bwd,
)
from playablevideogeneration_tpu_torch.ops.cuda.fused_norm_act import (
    _batch_norm_leaky_relu,
    fused_batch_norm_leaky_relu,
)
from playablevideogeneration_tpu_torch.training import losses
from playablevideogeneration_tpu_torch.training.trainer import compute_loss_terms
from playablevideogeneration_tpu_torch.utils import tensor_ops as tops

CL = torch.channels_last
B, T, SIZE, ACTIONS = 2, 4, 32, 7
LOSS_WEIGHTS = {f"{name}{suffix}": 1.0 for suffix in ("", "_pretraining") for name in (
    "reconstruction_loss_lambda", "perceptual_loss_lambda", "states_rec_lambda",
    "entropy_lambda", "action_directions_kl_lambda", "action_mutual_information_lambda",
    "action_state_distribution_kl_lambda")}
LOSS_WEIGHTS["hidden_states_rec_lambda_pretraining"] = 1.0


def _tiny_caddy(stacking: int = 1, checkpoint_steps: bool = False) -> Caddy:
    """The flagship's layout of networks (``configs/01_bair.yaml``: 7
    actions, 2-D variations) at 32x32 frames, 8 state features at 4x4 and
    hidden size 8, f32."""
    model = Caddy(actions_count=ACTIONS, action_space_dimension=2, state_features=8,
                  state_resolution=(4, 4), hidden_state_size=8,
                  observation_stacking=stacking, checkpoint_steps=checkpoint_steps)
    return seeded_init(model, 3)


def _images(value) -> list:
    """The 4-D tensors of a hook's arguments or outputs."""
    if isinstance(value, torch.Tensor):
        return [value] if value.dim() == 4 else []
    if isinstance(value, (list, tuple)):
        return [t for item in value for t in _images(item)]
    return []


class _LayoutHooks:
    """Forward hooks on every convolution (CADDY's and VGG's), BatchNorm
    and ConvLSTM cell of ``modules``, noting each 4-D input or output that
    is not channels-last-contiguous."""

    def __init__(self, *modules: torch.nn.Module):
        self.calls = 0
        self.islands = []
        self._handles = [
            m.register_forward_hook(self._hook)
            for module in modules for name, m in module.named_modules()
            if isinstance(m, (layers.Conv2d, layers.BatchNorm, layers.ConvLSTMCell))]
        assert self._handles

    def _hook(self, module, args, output):
        self.calls += 1
        for role, value in (("input", args), ("output", output)):
            for t in _images(value):
                if not t.is_contiguous(memory_format=CL):
                    self.islands.append((type(module).__name__, role, tuple(t.shape),
                                         t.stride()))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for handle in self._handles:
            handle.remove()


def _batch(stacking: int, seed: int):
    """The loader's channels-last (B, T, H, W, 3*stacking) frames as the
    trainer views them, and actions."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (B, T, SIZE, SIZE, 3 * stacking)).astype(np.float32)
    actions = torch.from_numpy(rng.integers(0, ACTIONS, (B, T)))
    return tops.sequence_to_nchw(frames, "cpu"), actions


@pytest.mark.parametrize("pretraining,checkpoint_steps,motion,stacking", [
    pytest.param(False, False, False, 1, id="full"),
    pytest.param(False, True, True, 1, id="full-checkpointed-motion"),
    pytest.param(True, False, False, 1, id="pretraining"),
    pytest.param(False, False, False, 4, id="full-stacking4"),
])
def test_a_train_step_keeps_every_image_channels_last(pretraining, checkpoint_steps, motion,
                                                      stacking):
    """Forward, the seven loss terms and the backward of a tiny BAIR-shaped
    step (Tennis's stacking of 4 in one case): every 4-D input and output
    of a convolution, BatchNorm or ConvLSTM cell is channels-last-
    contiguous, and so is each convolution weight's gradient."""
    model = _tiny_caddy(stacking, checkpoint_steps).train()
    vgg = make_vgg("cpu", torch.float32, 4)
    observations, actions = _batch(stacking, 5)
    assert tops.flatten(observations).is_contiguous(memory_format=CL)
    with _LayoutHooks(model, vgg) as hooks:
        total, _ = compute_loss_terms(
            model, observations, actions, 2, 0.8, torch.Generator().manual_seed(0), vgg,
            LOSS_WEIGHTS, 1.0, pretraining, motion, 0.1, losses.init_mi_matrix(ACTIONS), 0.2)
        total.backward()
    assert hooks.calls > 100
    assert hooks.islands == []
    grads = [(name, p.grad) for name, p in model.named_parameters()
             if p.dim() == 4 and p.grad is not None]
    assert grads
    assert [name for name, g in grads if not g.is_contiguous(memory_format=CL)] == []


@pytest.mark.parametrize("backend", [None, graphs.StandIn], ids=["eager", "static-buffers"])
def test_the_play_route_keeps_every_image_channels_last(backend):
    """The interactive step and the scripted rollout of the play session,
    eagerly and on the program's static buffers: no channels-first island,
    and the carries and the window stay NHWC-contiguous, the model's
    storage at the JAX package's shapes."""
    model = _tiny_caddy().eval()
    session = PlaySession(model, backend=backend)
    rng = np.random.default_rng(6)
    session.start(rng.uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32))
    with _LayoutHooks(model) as hooks:
        for action in (0, 3, 6):
            frame = session.generate_next_u8(action)
        frames = session.rollout(np.array([1, 2, 5]))
    assert frame.shape == (SIZE, SIZE, 3) and frames.shape == (3, SIZE, SIZE, 3)
    assert hooks.calls > 100
    assert hooks.islands == []
    assert all(t.is_contiguous() for t in session._state())


@pytest.mark.parametrize("make", [
    pytest.param(lambda: _tiny_caddy(), id="caddy"),
    pytest.param(lambda: Vgg19(), id="vgg19"),
    pytest.param(lambda: make_vgg("cpu", torch.bfloat16, 1), id="make_vgg"),
    pytest.param(lambda: _tiny_caddy().to("cpu", torch.float32).train(), id="moved"),
])
def test_convolution_weights_are_stored_channels_last_from_construction(make):
    """Every convolution weight is channels-last from its construction on,
    through ``to`` and a state-dict load; the bf16 cast a layer hands the
    convolution keeps it, so cuDNN is given no filter to transform."""
    model = make()
    model.load_state_dict({k: v.contiguous() for k, v in model.state_dict().items()})
    convs = [m for m in model.modules() if isinstance(m, layers.Conv2d)]
    assert convs
    for conv in convs:
        assert conv.weight.is_contiguous(memory_format=CL)
        with torch.no_grad():
            cast = conv._cast("weight") if conv.compute_dtype != torch.float32 else conv.weight
        assert cast.is_contiguous(memory_format=CL)


def test_sequence_helpers_keep_channels_innermost():
    """``stack`` and ``cat`` give ``torch.stack``'s and ``torch.cat``'s values
    with the channels innermost; ``flatten`` of such a sequence is a view, of
    a slice of its time axis a channels-last copy, and ``sequence_to_nchw``
    a view of the loader's NHWC frames."""
    frames = [torch.randn(2, 5, 3, 4).contiguous(memory_format=CL) for _ in range(3)]
    stacked = tops.stack(frames, dim=1)
    assert torch.equal(stacked, torch.stack(frames, dim=1))
    assert tops.flatten(stacked).data_ptr() == stacked.data_ptr()
    assert tops.flatten(stacked).is_contiguous(memory_format=CL)
    sliced = tops.flatten(stacked[:, 1:])
    assert torch.equal(sliced, stacked[:, 1:].reshape(-1, 5, 3, 4))
    assert sliced.is_contiguous(memory_format=CL)
    vectors = torch.randn(2, 2)[:, :, None, None].expand(-1, -1, 3, 4)
    parts = [frames[0], vectors, frames[1][:, :-1]]
    joined = tops.cat(parts, dim=1)
    assert torch.equal(joined, torch.cat(parts, dim=1))
    assert joined.is_contiguous(memory_format=CL)
    along_time = tops.cat([stacked, stacked[:, :1]], dim=1)
    assert torch.equal(along_time, torch.cat([stacked, stacked[:, :1]], dim=1))
    assert tops.flatten(along_time).is_contiguous(memory_format=CL)
    loader = np.random.default_rng(0).uniform(-1, 1, (2, 3, 4, 5, 6)).astype(np.float32)
    viewed = tops.sequence_to_nchw(torch.from_numpy(loader), "cpu")
    assert viewed.shape == (2, 3, 6, 4, 5)
    assert np.array_equal(viewed.numpy(), loader.transpose(0, 1, 4, 2, 3))
    assert tops.flatten(viewed).is_contiguous(memory_format=CL)


def _storages(t: torch.Tensor) -> dict:
    return {"nchw": t.contiguous(), "channels_last": t.contiguous(memory_format=CL)}


def _gate_args(kernel: str, seed: int, dtype: torch.dtype):
    gen = torch.Generator().manual_seed(seed)
    b, c, h, w = 2, 8, 3, 5
    gates = torch.randn(b, 4 * c, h, w, generator=gen).to(dtype)
    state = [torch.randn(b, c, h, w, generator=gen).to(dtype) for _ in range(3)]
    return [gates, state[0]] if kernel == "k1" else [gates] + state


def _norm_args(seed: int, dtype: torch.dtype):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 16, 3, 5, generator=gen).to(dtype)
    statistics = [torch.rand(16, generator=gen) + 0.5, torch.randn(16, generator=gen),
                  torch.randn(16, generator=gen), torch.rand(16, generator=gen) + 0.5]
    return [x], statistics


_WRAPPERS = {
    "k1": (fused_lstm_gates, _gate_math),
    "k2": (fused_lstm_gates_bwd, _gate_math_bwd),
    "k3": (fused_batch_norm_leaky_relu, _batch_norm_leaky_relu),
}


def _wrapper_args(kernel: str, dtype: torch.dtype):
    if kernel == "k3":
        return _norm_args(9, dtype)
    return _gate_args(kernel, 9, dtype), []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("storage", ["nchw", "channels_last"])
@pytest.mark.parametrize("kernel", sorted(_WRAPPERS))
def test_wrappers_take_both_storages_with_the_plain_values(kernel, storage, dtype):
    """K1, K2 and K3's wrappers on either contiguous storage give their
    plain version's values, in the storage they were given: bit for bit on
    the same storage, and the NCHW values within the CPU's rounding, whose
    vectorised and strided ``sigmoid`` and ``tanh`` may differ by an ulp
    (the card's per-element kernels do not)."""
    wrapper, plain = _WRAPPERS[kernel]
    images, statistics = _wrapper_args(kernel, dtype)
    stored = [_storages(t)[storage] for t in images]
    got = wrapper(*stored, *statistics)
    same, nchw = plain(*stored, *statistics), plain(*images, *statistics)
    for g, s, n in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, same, nchw))):
        assert g.dtype == n.dtype and torch.equal(g, s)
        torch.testing.assert_close(g, n, rtol=2 ** -20, atol=1e-7)
        assert g.is_contiguous(memory_format=CL if storage == "channels_last" else
                               torch.contiguous_format)


def _other_strides(t: torch.Tensor) -> torch.Tensor:
    """A view of ``t`` in neither contiguous storage."""
    return t.transpose(2, 3)


@pytest.mark.parametrize("kernel,case", [
    (kernel, case) for kernel in sorted(_WRAPPERS) for case in ("mixed", "transposed", "sliced")
    if not (kernel == "k3" and case == "mixed")])  # K3 takes one image
def test_wrappers_raise_on_any_other_strides(kernel, case):
    """One tensor channels-last and another NCHW, a transposed view, or a
    channel slice of a channels-last tensor: the wrapper raises, on any
    device (the meta device stands for the card)."""
    wrapper, _ = _WRAPPERS[kernel]
    images, statistics = _wrapper_args(kernel, torch.float32)
    for device in ("cpu", "meta"):
        args = [t.to(device).contiguous(memory_format=CL) for t in images]
        stats = [s.to(device) for s in statistics]
        if case == "mixed":
            args[-1] = args[-1].contiguous()
        elif case == "transposed":
            args[0] = _other_strides(args[0]).contiguous().transpose(2, 3)
        else:
            wide = torch.zeros(args[0].shape[0], args[0].shape[1] + 1, *args[0].shape[2:],
                               device=device).contiguous(memory_format=CL)
            args[0] = wide[:, :-1]
        with pytest.raises(ValueError, match="channels-last-contiguous or all contiguous"):
            wrapper(*args, *stats)


@pytest.mark.parametrize("shape,nhwc", [
    ((2, 8, 3, 5), None),
    ((2, 1, 3, 5), "both"),
    ((2, 8, 1, 1), "both"),
])
def test_a_storage_is_chosen_from_the_strides(shape, nhwc):
    """Channels-last-contiguous tensors read as channels-last and
    contiguous ones as NCHW; a tensor that is both (one channel, or one
    pixel) reads as channels-last, which the CUDA kernels take."""
    x = torch.zeros(shape)
    if nhwc == "both":
        assert build.channels_last(x) and build.channels_last(x.contiguous(memory_format=CL))
    else:
        assert not build.channels_last(x)
        assert build.channels_last(x.contiguous(memory_format=CL))


@pytest.mark.parametrize("kernel", sorted(_WRAPPERS))
def test_wrappers_refuse_nchw_off_the_cpu(kernel):
    """Off the CPU (the meta device stands for the card) a wrapper refuses
    contiguous NCHW tensors, since its CUDA kernel takes channels-last
    storage alone, and passes channels-last ones on to the device check."""
    wrapper, _ = _WRAPPERS[kernel]
    images, statistics = _wrapper_args(kernel, torch.float32)
    stats = [s.to("meta") for s in statistics]
    with pytest.raises(ValueError, match="channels-last storage, got contiguous NCHW"):
        wrapper(*(t.to("meta").contiguous() for t in images), *stats)
    with pytest.raises(ValueError, match="unsupported device meta"):
        wrapper(*(t.to("meta").contiguous(memory_format=CL) for t in images), *stats)
