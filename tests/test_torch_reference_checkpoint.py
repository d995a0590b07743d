"""Import of reference ``.pth.tar`` checkpoints into the port, against the
JAX package's importer, on the CPU.

No released checkpoint is in the repository, so one is built: the
conftest tiny model's seeded variables, loaded into the port's modules,
written in the reference's key layout by ``chip_smoke.reference_state_dict``
(per-gate ConvLSTM convolutions, OIHW kernels, (out, in) linears,
``num_batches_tracked``), which phase 11 of ``chip_smoke.py`` also uses.
The JAX package's own converter must map that layout back to the tree
exactly, which proves the writer; then the port's converter must give the
identical tree, and a ``.pth.tar`` written with ``torch.save`` must drive
the same play step and full forward in both packages (rtol 1e-3 / atol
2e-4 in f32, the harness's tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401 (single_threaded_torch is an autouse fixture)
    NOISE, patched_noise, random_variables, single_threaded_torch, to_port_layout)

import chip_smoke

from playablevideogeneration_tpu.data.synthetic import make_synthetic_config
from playablevideogeneration_tpu.evaluation import action_sampler as jax_samplers
from playablevideogeneration_tpu.utils import reference_checkpoint as jax_reference
from playablevideogeneration_tpu_torch.config.configuration import Configuration
from playablevideogeneration_tpu_torch.evaluation import action_sampler as samplers
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.training.trainer import Trainer
from playablevideogeneration_tpu_torch.utils import reference_checkpoint
from playablevideogeneration_tpu_torch.utils.jax_weights import _leaves, load_jax_variables

TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def variables(tiny_variables):
    return random_variables(tiny_variables, seed=31)


@pytest.fixture(scope="module")
def source(tiny_model, variables):
    """The port's tiny model holding ``variables``."""
    return load_jax_variables(_port_model(tiny_model), variables)


@pytest.fixture(scope="module")
def checkpoint(source, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("reference") / "latest.pth.tar")
    chip_smoke.write_reference_checkpoint(source, path)
    return path


def _flat(tree):
    return dict(_leaves(tree))


def _assert_same_tree(got, want):
    assert sorted(got) == sorted(want)
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        assert got[path].shape == value.shape, path
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


def _port_model(tiny_model):
    return Caddy(tiny_model.actions_count, tiny_model.action_space_dimension,
                 tiny_model.state_features, tiny_model.state_resolution,
                 tiny_model.hidden_state_size, tiny_model.observation_stacking)


def test_written_layout_round_trips_through_the_jax_converter(source, variables):
    state = chip_smoke.reference_state_dict(source)
    assert "dynamics_network.recurrent_layers_blocks.1.0.cell.forget_gate.weight" in state
    assert any(k.endswith("num_batches_tracked") for k in state)
    assert state["action_network.0.mean_fc.weight"].shape[0] == 2  # (out, in)
    _assert_same_tree(jax_reference.convert_reference_state_dict(state), variables)


def test_port_converter_matches_the_jax_converter(source):
    state = chip_smoke.reference_state_dict(source)
    _assert_same_tree(reference_checkpoint.convert_reference_state_dict(state),
                      jax_reference.convert_reference_state_dict(state))


def test_checkpoint_loads_to_the_same_tree_in_both_packages(checkpoint, variables):
    _assert_same_tree(reference_checkpoint.load_reference_checkpoint(checkpoint),
                      jax_reference.load_reference_checkpoint(checkpoint))
    _assert_same_tree(reference_checkpoint.load_reference_checkpoint(checkpoint), variables)


@pytest.mark.parametrize("broken", ["incomplete_gates", "unmapped_key"])
def test_converter_rejects_broken_layouts(source, broken):
    state = chip_smoke.reference_state_dict(source)
    if broken == "incomplete_gates":
        del state["dynamics_network.recurrent_layers_blocks.0.0.cell.cell_gate.bias"]
        match = "Incomplete ConvLSTM gates"
    else:
        state["rendering_network.extra_blocks.0.weight"] = np.zeros(1, np.float32)
        match = "Unmapped reference key"
    for convert in (reference_checkpoint.convert_reference_state_dict,
                    jax_reference.convert_reference_state_dict):
        with pytest.raises(KeyError, match=match):
            convert(state)


def _trainer(tiny_model):
    config = make_synthetic_config(
        data_root="/nonexistent", output_root="/nonexistent", height=32, width=32,
        actions_count=3, batch_size=2, observations_count=4, observation_stacking=2,
        hidden_state_size=8, state_features=8)
    Configuration(config=config).check_config(check_data_root=False)
    trainer = Trainer(config, _port_model(tiny_model))
    trainer.init_state()
    return trainer


def test_load_reference_weights_imports_weights_only(tiny_model, checkpoint, variables):
    """Every parameter and buffer equals the tree loaded directly, bit for
    bit; the optimizer's state and the step stay as initialised."""
    trainer = _trainer(tiny_model)
    with pytest.raises(RuntimeError, match="init_state"):
        Trainer(trainer.config, _port_model(tiny_model)).load_reference_weights(checkpoint)
    trainer.load_reference_weights(checkpoint)
    want = load_jax_variables(_port_model(tiny_model), variables).state_dict()
    got = trainer.model.state_dict()
    assert list(got) == list(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert trainer.state.step == 0 and trainer.global_step == 0
    assert not trainer.state.optimizer.state_dict()["state"]


@pytest.fixture(scope="module")
def loaded(tiny_model, checkpoint):
    """(JAX variables, port model in eval mode), each from the checkpoint
    through its own package's importer."""
    trainer = _trainer(tiny_model)
    trainer.load_reference_weights(checkpoint)
    return jax_reference.load_reference_checkpoint(checkpoint), trainer.model.eval()


def test_checkpoint_drives_the_same_play_step(tiny_model, loaded):
    jax_variables, port = loaded
    rng = np.random.default_rng(8)
    window = rng.uniform(-1, 1, (1, 32, 32, 6)).astype(np.float32)
    action = np.eye(3, dtype=np.float32)[[2]]
    variation = rng.normal(size=(1, 2)).astype(np.float32)
    jax_carry = tiny_model.apply(jax_variables, 1, method="init_play")
    _, want, want_window = tiny_model.apply(jax_variables, jax_carry, jnp.asarray(window),
                                            jnp.asarray(action), jnp.asarray(variation),
                                            method="play_step")
    _, got, got_window = port.play_step(port.init_play(1), torch.from_numpy(window),
                                        torch.from_numpy(action), torch.from_numpy(variation))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_window.numpy(), np.asarray(want_window), **TOL)


def test_checkpoint_drives_the_same_full_forward(tiny_model, loaded):
    """The evaluation forward (frozen statistics, one-hot actions, zero
    variations, two ground-truth frames): every output field."""
    jax_variables, port = loaded
    rng = np.random.default_rng(9)
    obs = rng.uniform(-1, 1, (2, 4, 32, 32, 6)).astype(np.float32)
    acts = rng.integers(0, 3, (2, 4)).astype(np.int32)
    with patched_noise():
        NOISE.reset()
        want = tiny_model.apply(jax_variables, jnp.asarray(obs), jnp.asarray(acts), 2,
                                train=False, gumbel_temperature=jnp.asarray(0.4),
                                action_sampler=jax_samplers.one_hot_action_sampler,
                                variation_sampler=jax_samplers.zero_action_variation_sampler,
                                rngs={"sample": jax.random.PRNGKey(0)})
        NOISE.reset()
        with torch.no_grad():
            got = port(torch.from_numpy(np.ascontiguousarray(obs.transpose(0, 1, 4, 2, 3))),
                       torch.from_numpy(acts), 2, generator=torch.Generator(),
                       gumbel_temperature=0.4, action_sampler=samplers.one_hot_action_sampler,
                       variation_sampler=samplers.zero_action_variation_sampler)
    for name, value in vars(got).items():
        expected = getattr(want, name)
        if value is None:
            assert expected is None, name
            continue
        values, expecteds = ((value, expected) if isinstance(value, list)
                             else ([value], [expected]))
        for v, e in zip(values, expecteds):
            np.testing.assert_allclose(v.numpy(), to_port_layout(name, e), err_msg=name, **TOL)

