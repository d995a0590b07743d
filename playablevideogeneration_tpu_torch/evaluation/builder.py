"""Evaluation dataset builder.

Counterpart of ``playablevideogeneration_tpu/evaluation/builder.py``:
reconstructs every test sequence autoregressively from
``evaluation_dataset.ground_truth_observations_init`` ground-truth frames,
with one-hot inferred actions, zero action variations and the final
Gumbel temperature, the model in evaluation mode (frozen BatchNorm
through the fused norm kernel on the card); prepends the sequence's first
ground-truth frame, maps [-1, 1] to [0, 1] and quantises to uint8.  Each
sequence becomes a ``Video`` whose per-frame metadata is ``{model,
inferred_action, encoded_action}``, ``{model}`` on the last frame: the
input of the offline evaluation.

``build_videos`` keeps the videos in memory; ``build`` writes them in the
on-disk video format, which needs Pillow.

On a CUDA device the forward is a captured program (``inference.graphs``)
per batch shape (B, T), as the JAX builder keeps one ``jax.jit`` per
shape: the last, ragged batch gets its own.  The generator is registered
with each graph, so the replays draw the eager forward's noise; the
forward's outputs are copied out of the graph's static buffers.  On the
CPU the forward runs eagerly.
"""
from __future__ import annotations

import os
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from playablevideogeneration_tpu_torch.data.loader import DataLoader
from playablevideogeneration_tpu_torch.data.video import Video, pillow_image
from playablevideogeneration_tpu_torch.data.video_dataset import Batch
from playablevideogeneration_tpu_torch.evaluation.action_sampler import (
    one_hot_action_sampler,
    zero_action_variation_sampler,
)
from playablevideogeneration_tpu_torch.evaluation.evaluator import eval_mode, evaluation_forward
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.models.caddy import Caddy
from playablevideogeneration_tpu_torch.models.outputs import ModelOutput
from playablevideogeneration_tpu_torch.utils.logging import Logger
from playablevideogeneration_tpu_torch.utils.tensor_ops import sequence_to_nchw


class EvaluationDatasetBuilder:
    """Noise (the action networks' sampled directions, recorded as
    ``encoded_action``) comes from the builder's generator on the model's
    device, seeded with 0 at each build.  ``backend`` is for the CPU tests
    only (``graphs.StandIn``); by default the device decides."""

    def __init__(self, config: dict, model: Caddy, dataset, logger: Logger,
                 logger_prefix: str = "test", backend: Optional[type] = None):
        self.config = config
        self.model = model
        self.dataset = dataset
        self.logger = logger
        self.device = model.centroids.device
        b = config["evaluation"]["batching"]
        self.dataloader = DataLoader(dataset, batch_size=b["batch_size"], shuffle=False,
                                     drop_last=False, num_workers=b["num_workers"])
        self.output_path = config["logging"]["evaluation_dataset_directory"]
        self.ground_truth_observations_init = \
            config["evaluation_dataset"]["ground_truth_observations_init"]
        self.temperature = config["training"]["gumbel_temperature_end"]
        self.generator = torch.Generator(device=self.device)
        self._backend = graphs.resolve_backend(self.device, backend)
        # (B, T) -> graphs.Program
        self._programs = {}

    def _eager_forward(self, observations: torch.Tensor, actions: torch.Tensor,
                       generator: torch.Generator) -> ModelOutput:
        return evaluation_forward(self.model, observations, actions, generator,
                                  self.ground_truth_observations_init, self.temperature,
                                  one_hot_action_sampler, zero_action_variation_sampler)

    def _forward(self, observations: torch.Tensor, actions: torch.Tensor,
                 generator: torch.Generator) -> ModelOutput:
        """The forward of one batch, on a model in evaluation mode: eager on
        the CPU, else a replay of the program of its (B, T), captured again
        for another model or generator."""
        if self._backend is None:
            return self._eager_forward(observations, actions, generator)
        key = tuple(observations.shape[:2])
        program = self._programs.get(key)
        if (program is None or program.model is not self.model
                or program.generators[0] is not generator):
            builder = weakref.proxy(self)  # the program must not hold its owner
            program = self._programs[key] = graphs.Program(
                lambda obs, acts: ((), builder._eager_forward(obs, acts, generator)), (),
                [observations.clone(), actions.clone()], self.model, self._backend,
                generators=(generator,))
        return graphs.copied(program(observations, actions))

    def reconstruct(self, batch: Batch, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, ModelOutput]:
        """The batch's sequences as (B, T, 3, H, W) f32 in [0, 1] on the
        device (the first ground-truth frame, then the T-1 reconstructed
        ones) and the forward's output.  The model must be in evaluation
        mode."""
        observations = sequence_to_nchw(batch.observations, self.device)
        actions = torch.as_tensor(batch.actions, device=self.device)
        out = self._forward(observations, actions, generator)
        frames = torch.cat([observations[:, :1, :3], out.reconstructed_observations.float()],
                           dim=1)
        # Unconditional: the inputs are in [-1, 1] and the decoder is
        # tanh-bounded; a guard on the batch's minimum would leave an
        # all-bright batch in [-1, 1].
        return (frames + 1.0) / 2.0, out

    def build_videos(self) -> List[Video]:
        """Every test sequence's reconstruction as an in-memory ``Video``;
        the model's previous mode is restored afterwards."""
        videos: List[Video] = []
        generator = self.generator.manual_seed(0)
        with eval_mode(self.model):
            for batch in self.dataloader:
                frames, out = self.reconstruct(batch, generator)
                images = (frames.clamp(0.0, 1.0) * 255).to(torch.uint8).permute(0, 1, 3, 4, 2)
                videos.extend(self._predictions_to_videos(
                    images.cpu().numpy(), out.selected_actions.cpu().numpy(),
                    out.sampled_action_directions.float().cpu().numpy()))
        return videos

    def build(self) -> str:
        """Builds the evaluation dataset and writes it under the run's
        ``evaluation_dataset`` directory; returns that path."""
        pillow_image("writing the evaluation dataset's PNG frames")
        videos = self.build_videos()
        os.makedirs(self.output_path, exist_ok=True)
        for idx, video in enumerate(videos):
            video.save(os.path.join(self.output_path, f"{idx:05d}"), "png")
        self.logger.print(f"- Wrote {len(videos)} evaluation sequences to {self.output_path}")
        return self.output_path

    @staticmethod
    def _predictions_to_videos(images: np.ndarray, actions: np.ndarray,
                               encoded_mus: np.ndarray) -> List[Video]:
        """(B, T, H, W, 3) uint8 frames, (B, T-1) inferred actions and
        (B, T-1, D) encoded action directions -> B videos."""
        sequence_length = images.shape[1]
        videos = []
        for b in range(images.shape[0]):
            metadata = [{"model": "ours", "inferred_action": int(a),
                         "encoded_action": list(map(float, np.atleast_1d(m)))}
                        for a, m in zip(actions[b].tolist(), encoded_mus[b].tolist())]
            metadata.append({"model": "ours"})  # the last frame has no action
            videos.append(Video().add_content(
                list(images[b]), [0] * sequence_length, [0] * sequence_length, metadata,
                [False] * sequence_length))
        return videos


def make_builder(config: dict, model: Caddy, dataset, logger: Logger,
                 **kwargs) -> EvaluationDatasetBuilder:
    return EvaluationDatasetBuilder(config, model, dataset, logger, **kwargs)
