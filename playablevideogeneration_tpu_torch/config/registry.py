"""Component registry.

Counterpart of ``playablevideogeneration_tpu/config/registry.py``: the YAML
names its model, trainer and evaluator by the reference's dotted module
paths, and the registry maps those strings (and their short aliases) to
the port's factories: models, trainers, the in-training evaluator, the
evaluation-dataset builder and the offline dataset evaluators.
"""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRIES: Dict[str, Dict[str, Callable]] = {
    "model": {},
    "trainer": {},
    "evaluator": {},
    "builder": {},
    "dataset_evaluator": {},
}


def resolve(kind: str, name: str) -> Callable:
    reg = _REGISTRIES[kind]
    if name in reg:
        return reg[name]

    # Dotted paths and bare names both resolve, e.g.
    # "model.main_model.model" == "main_model" and "training.trainer" == "trainer".
    def shorten(dotted):
        parts = dotted.split(".")
        return parts[-2] if len(parts) >= 3 else parts[-1]

    short = shorten(name)
    for key, fn in reg.items():
        if key == short or shorten(key) == short:
            return fn
    raise KeyError(f"No {kind} registered under '{name}'. Known: {sorted(reg)}")


def _register_defaults():
    """Registers the built-in components; imported here, on first use, to
    keep the registry free of import cycles."""
    from playablevideogeneration_tpu_torch.evaluation.builder import make_builder
    from playablevideogeneration_tpu_torch.evaluation.dataset_evaluator import (
        make_dataset_evaluator,
        make_dataset_evaluator_bair,
        make_dataset_evaluator_breakout,
    )
    from playablevideogeneration_tpu_torch.evaluation.evaluator import make_evaluator
    from playablevideogeneration_tpu_torch.models.caddy import make_model
    from playablevideogeneration_tpu_torch.training.smooth_mi import make_smooth_mi_trainer
    from playablevideogeneration_tpu_torch.training.trainer import make_trainer

    # The main and reduced models differ only in the widths that the
    # config's hidden_state_size sets, so one factory serves both names.
    _REGISTRIES["model"].setdefault("model.main_model.model", make_model)
    _REGISTRIES["model"].setdefault("model.reduced_model.model", make_model)
    _REGISTRIES["trainer"].setdefault("training.trainer", make_trainer)
    _REGISTRIES["trainer"].setdefault("training.smooth_mi_trainer", make_smooth_mi_trainer)
    _REGISTRIES["evaluator"].setdefault("evaluation.evaluator", make_evaluator)
    _REGISTRIES["builder"].setdefault("evaluation.evaluation_dataset_builder", make_builder)
    _REGISTRIES["dataset_evaluator"].setdefault("evaluation.dataset_evaluator",
                                                make_dataset_evaluator)
    _REGISTRIES["dataset_evaluator"].setdefault("evaluation.dataset_evaluator_bair",
                                                make_dataset_evaluator_bair)
    _REGISTRIES["dataset_evaluator"].setdefault("evaluation.dataset_evaluator_breakout",
                                                make_dataset_evaluator_breakout)
