"""Training entry point.

Counterpart of ``playablevideogeneration_tpu/cli/train.py``.  Trains on
the GPU by default; ``--device cpu`` runs on the CPU when asked, and
without a GPU the default raises instead of moving to the CPU:

    python -m playablevideogeneration_tpu_torch.cli.train --config configs/01_bair.yaml

On G GPUs of one machine, G/M-way data-parallel and M-way
tensor-parallel (``tpu.model_parallel: M``, default 1; M must divide G)
with the JAX trainer's semantics: the config's ``batch_size`` split over
the G/M data indices, the wide kernels' output channels over the M ranks
of each model group:

    torchrun --nproc_per_node=G -m playablevideogeneration_tpu_torch.cli.train \
        --config configs/01_bair.yaml

``tpu.data_parallel_devices``, when set, counts data indices over every
node, as the JAX package counts devices over every process: times
``tpu.model_parallel`` it must be the world.

A run resumes from its ``latest`` checkpoint when there is one, saves
``latest`` after every epoch and ``checkpoint_<step>`` every ``save_freq``
steps, and evaluates on the validation split every ``eval_freq`` steps:
with the Gumbel sampler, and when the data carries ground-truth actions
also with the one-hot sampler and the ground-truth sampler through the
Hungarian mapping.  In a run of several ranks rank 0 evaluates (under
tensor parallelism on a full-width copy of the model that its model group
gathers) while the other ranks wait, and only rank 0 prints, logs and
writes checkpoints.
"""
from __future__ import annotations

import argparse
import os
from typing import Mapping, Optional

import torch.distributed as dist

from playablevideogeneration_tpu_torch.config import registry
from playablevideogeneration_tpu_torch.config.configuration import Configuration
from playablevideogeneration_tpu_torch.data.splitter import generate_splits
from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.evaluation.action_sampler import (
    make_ground_truth_action_sampler,
    one_hot_action_sampler,
)
from playablevideogeneration_tpu_torch.parallel import mesh
from playablevideogeneration_tpu_torch.utils import checkpoint as ckpt_lib
from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device
from playablevideogeneration_tpu_torch.utils.logging import Logger
from playablevideogeneration_tpu_torch.utils.pretrained import get_vgg_variables, make_metric_vgg


def build_run(config_dict: dict, use_wandb: bool = False, logger: Optional[Logger] = None,
              device: DeviceLike = "cuda",
              datasets: Optional[Mapping[str, VideoDataset]] = None):
    """(model, datasets, trainer, evaluators, logger) for a checked config.

    :param logger: a custom logger in place of the config's
    :param datasets: ``{"train", "validation", "test"}`` datasets in place
        of the ones the config's data root holds (videos held in memory,
        for example)
    """
    registry._register_defaults()
    if logger is None:
        logger = Logger(config_dict, use_wandb=use_wandb,
                        enabled=mesh.process_info().rank == 0)
    device = resolve_device(device)
    seed = config_dict.get("seed", 0)

    model = registry.resolve("model", config_dict["model"]["architecture"])(
        config_dict, device, seed)
    if datasets is None:
        transforms = get_final_transforms(config_dict)
        datasets = {name: VideoDataset(path, batching, transforms[name], allowed_videos=allowed)
                    for name, (path, batching, allowed) in generate_splits(config_dict).items()}
    datasets = dict(datasets)

    trainer = registry.resolve("trainer", config_dict["training"]["trainer"])(
        config_dict, model, datasets["train"], logger, seed=seed)
    make_evaluator = registry.resolve("evaluator", config_dict["evaluation"]["evaluator"])
    # The evaluators share one VGG, the config's converted weights or seeded
    # random ones, in f32 whatever the model's dtype; the test evaluator is
    # built for callers that evaluate the test split themselves, training
    # drives only the validation one.
    vgg = make_metric_vgg(get_vgg_variables(config_dict)[0], device)
    evaluators = {name: make_evaluator(config_dict, model, datasets[name], logger,
                                       action_sampler=None, logger_prefix=name, vgg=vgg)
                  for name in ("validation", "test")}
    return model, datasets, trainer, evaluators, logger


def train(config_dict: dict, use_wandb: bool = False, max_steps: Optional[int] = None,
          device: DeviceLike = "cuda", *,
          datasets: Optional[Mapping[str, VideoDataset]] = None):
    """Trains until ``max_steps`` (default: the config's), resuming from the
    ``latest`` checkpoint when there is one; returns the trainer.
    ``datasets`` is passed to ``build_run``."""
    model, datasets, trainer, evaluators, logger = build_run(
        config_dict, use_wandb, device=device, datasets=datasets)

    latest = os.path.join(config_dict["logging"]["save_root_directory"], "latest")
    trainer.init_state()
    if ckpt_lib.checkpoint_exists(latest):
        logger.print(f"- Resuming from checkpoint '{latest}'")
        trainer.load_checkpoint()
    else:
        logger.print("- No checkpoint found, starting from scratch")

    if max_steps is None:
        max_steps = config_dict["training"]["max_steps"]
    save_freq = config_dict["training"]["save_freq"]
    eval_freq = config_dict["evaluation"]["eval_freq"]
    last_eval = trainer.global_step
    last_periodic_save = trainer.global_step

    while trainer.global_step < max_steps:
        step_before = trainer.global_step
        trainer.train_epoch(max_steps=max_steps)
        if trainer.global_step == step_before:
            # No full batch this epoch: without this the loop would spin,
            # writing a checkpoint per turn.
            raise RuntimeError(
                "train_epoch performed no steps: the train split yields "
                "no full batch at the current sequence length/batch size")
        # The step an epoch ends on for a length change counts, untaken.
        trainer.state.step = trainer.global_step
        trainer.save_checkpoint()
        if trainer.global_step - last_periodic_save >= save_freq:
            trainer.save_checkpoint(f"checkpoint_{trainer.global_step}")
            last_periodic_save = trainer.global_step

        if eval_freq and trainer.global_step - last_eval >= eval_freq:
            last_eval = trainer.global_step
            if trainer.mesh.data_index == 0:
                with trainer.full_model_in(evaluators["validation"]):
                    if trainer.process.rank == 0:
                        evaluate(evaluators["validation"], trainer.global_step,
                                 config_dict["data"]["ground_truth_available"])
            if trainer.distributed:
                mesh.barrier()
    logger.print("- Training complete")
    return trainer


def evaluate(validation, step: int, ground_truth_available: bool) -> None:
    """The in-training evaluation at ``step``: with the Gumbel sampler, and
    when the data carries ground-truth actions also with the one-hot
    sampler and the ground-truth sampler through the Hungarian mapping."""
    validation.set_action_sampler(None)
    validation.evaluate(step)
    if ground_truth_available:
        validation.set_action_sampler(one_hot_action_sampler, label="one_hot")
        validation.evaluate(step, save_images=False)
        mapping = validation.get_best_action_mappings()
        validation.set_action_sampler(
            make_ground_truth_action_sampler(mapping, validation.device), label="gt_actions")
        validation.evaluate(step, save_images=False)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda; under torchrun "
                             "cuda:LOCAL_RANK)")
    args = parser.parse_args()

    device = mesh.init_distributed(args.device)
    try:
        configuration = Configuration(args.config)
        configuration.check_config()
        configuration.create_directory_structure()
        train(configuration.get_config(), use_wandb=args.wandb, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
