"""In-training evaluator.

Counterpart of ``playablevideogeneration_tpu/evaluation/evaluator.py``:
runs the model autoregressively from one ground-truth frame over the
validation set and reports per-position sequence losses, action-space
diagnostics and the action accuracy under the Hungarian matching, whose
ground-truth -> model action mapping then drives the ground-truth action
sampler (``cli/train.py``).  It writes a grid of example sequences.

The forward runs with the model in evaluation mode (frozen BatchNorm
statistics, through the fused norm kernel on the card; no centroid update)
under ``torch.no_grad``; the model's previous mode is restored afterwards.
The noise comes from the evaluator's generator on the model's device,
seeded in place with ``1234 + step`` at each evaluation.

On a CUDA device a batch's forward and its metrics (``_batch_metrics``)
are one captured program (``inference.graphs``) per ``(action sampler,
B, T)``, the counterpart of the JAX evaluator's ``jax.jit`` per
``(action sampler, T)``, kept in a cache of ``PROGRAMS`` that evicts the
least recently used, as the JAX evaluator's does; the generator is
registered with each graph and the host reads the metrics after the
replay.  On the CPU the batch runs eagerly.
"""
from __future__ import annotations

import collections
import contextlib
import os
import weakref
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from playablevideogeneration_tpu_torch.data.loader import DataLoader
from playablevideogeneration_tpu_torch.data.video import write_frame
from playablevideogeneration_tpu_torch.evaluation.hungarian import compute_actions_accuracy
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.models.caddy import ActionSampler, Caddy, VariationSampler
from playablevideogeneration_tpu_torch.models.outputs import ModelOutput
from playablevideogeneration_tpu_torch.models.vgg import Vgg19
from playablevideogeneration_tpu_torch.training import losses
from playablevideogeneration_tpu_torch.utils.logging import AverageMeter, Logger
from playablevideogeneration_tpu_torch.utils.pretrained import get_vgg_variables, make_metric_vgg
from playablevideogeneration_tpu_torch.utils.tensor_ops import sequence_to_nchw

# The evaluation forward's ground-truth frames and Gumbel temperature.
GROUND_TRUTH_OBSERVATIONS = 1
GUMBEL_TEMPERATURE = 0.4
# Per-batch scalars, in the order of the batch's transfer.
_SCALARS = ("observations_loss/avg", "perceptual_loss/avg", "states_loss/avg", "entropy",
            "samples_entropy", "action_distribution_entropy", "action_directions_kl_loss",
            "action_mutual_information_loss")
# The captured batches kept, as the JAX evaluator keeps its jitted forwards.
PROGRAMS = 6


def _nhwc(x: torch.Tensor) -> np.ndarray:
    """(B, T, C, H, W) tensor -> (B, T, H, W, C) f32 numpy."""
    return x.detach().float().permute(0, 1, 3, 4, 2).cpu().numpy()


@contextlib.contextmanager
def eval_mode(model: Caddy) -> Iterator[Caddy]:
    """The model in evaluation mode within the block (frozen BatchNorm
    statistics, no centroid update), its previous mode restored after it:
    a train step after an evaluation must normalise with batch statistics
    again."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


@torch.no_grad()
def evaluation_forward(model: Caddy, observations: torch.Tensor, actions: torch.Tensor,
                       generator: torch.Generator, ground_truth_observations: int,
                       gumbel_temperature: float, action_sampler: Optional[ActionSampler] = None,
                       variation_sampler: Optional[VariationSampler] = None) -> ModelOutput:
    """The full forward of the evaluation passes and of the evaluation
    dataset's reconstructions, without gradients, on a model in evaluation
    mode (``eval_mode``)."""
    return model(observations, actions, ground_truth_observations, generator=generator,
                 gumbel_temperature=gumbel_temperature, action_sampler=action_sampler,
                 variation_sampler=variation_sampler)


class Evaluator:
    """:param vgg: the perceptual loss's VGG19; by default the config's
        converted weights, or seeded random ones when there are none, in
        f32 (``utils.pretrained.make_metric_vgg``), as the JAX evaluator's
    :param backend: for the tests and the chip check only:
        ``graphs.StandIn`` or ``graphs.Eager``; by default the device
        decides (``graphs.resolve_backend``)"""

    def __init__(self, config: dict, model: Caddy, dataset, logger: Logger,
                 action_sampler: Optional[ActionSampler] = None, logger_prefix: str = "test",
                 vgg: Optional[Vgg19] = None, backend: Optional[type] = None):
        self.config = config
        self.model = model
        self.dataset = dataset
        self.logger = logger
        self.logger_prefix = logger_prefix
        self.action_sampler = action_sampler
        self._sampler_label: Optional[str] = None
        self.max_evaluation_batches = config["evaluation"]["max_evaluation_batches"]
        self.best_action_mappings: Optional[Dict[int, int]] = None
        self.device = model.centroids.device
        b = config["evaluation"]["batching"]
        self.dataloader = DataLoader(dataset, batch_size=b["batch_size"], shuffle=False,
                                     drop_last=True, num_workers=b["num_workers"])
        if vgg is None:
            vgg = make_metric_vgg(get_vgg_variables(config)[0], self.device)
        self.vgg = vgg
        self.generator = torch.Generator(device=self.device)
        self._backend = graphs.resolve_backend(self.device, backend)
        # (action sampler, B, T) -> graphs.Program, the least recently used first
        self._programs: "collections.OrderedDict[tuple, graphs.Program]" = \
            collections.OrderedDict()

    def set_action_sampler(self, action_sampler: Optional[ActionSampler],
                           label: Optional[str] = None) -> None:
        """Swaps the action sampler; ``label`` tags this pass's metric keys
        (``<prefix>/<label>/...``), so that passes logged at one step keep
        their own values."""
        self.action_sampler = action_sampler
        self._sampler_label = label

    def get_best_action_mappings(self) -> Dict[int, int]:
        if self.best_action_mappings is None:
            raise RuntimeError("Action mapping requires a prior evaluate() call")
        return self.best_action_mappings

    def _forward(self, observations: torch.Tensor, actions: torch.Tensor,
                 generator: torch.Generator) -> ModelOutput:
        """One batch through the model, which is in evaluation mode."""
        return evaluation_forward(self.model, observations, actions, generator,
                                  GROUND_TRUTH_OBSERVATIONS, GUMBEL_TEMPERATURE,
                                  self.action_sampler)

    @torch.no_grad()
    def _batch_metrics(self, observations: torch.Tensor, out: ModelOutput) -> torch.Tensor:
        """The batch's scalars (``_SCALARS``), its per-position
        observation, perceptual and state losses, and its selected actions,
        in one f32 vector on the device."""
        rec = out.reconstructed_observations
        obs_avg, obs_terms = losses.sequence_loss(losses.observations_loss, observations, rec)
        per_avg, per_terms = losses.sequence_loss(
            lambda a, b: losses.perceptual_loss(self.vgg, a, b), observations, rec)
        st_avg, st_terms = losses.sequence_loss(losses.states_loss, out.states,
                                                out.reconstructed_states)
        softmax = torch.nn.functional.softmax
        scalars = [
            obs_avg, per_avg, st_avg, losses.entropy_logits(out.action_logits),
            losses.entropy_probabilities(out.action_samples),
            losses.entropy_probabilities(out.action_samples.mean(dim=(0, 1))[None]),
            losses.kl_gaussian_divergence(out.action_directions_distribution),
            losses.mutual_information_loss(softmax(out.action_logits, dim=-1),
                                           softmax(out.reconstructed_action_logits, dim=-1)),
        ]
        return torch.cat([torch.stack([s.float() for s in scalars]), obs_terms, per_terms,
                          st_terms, out.selected_actions.reshape(-1).float()])

    def _eager_batch(self, observations: torch.Tensor, actions: torch.Tensor
                     ) -> Tuple[ModelOutput, torch.Tensor]:
        out = self._forward(observations, actions, self.generator)
        return out, self._batch_metrics(observations, out)

    def _batch(self, observations: torch.Tensor, actions: torch.Tensor
               ) -> Tuple[ModelOutput, torch.Tensor]:
        """One batch's forward and ``_batch_metrics``, on a model in
        evaluation mode: eagerly on the CPU, else a replay of the program of
        its (sampler, B, T), captured again for another model.  A replay's
        outputs are static: the next batch overwrites them."""
        if self._backend is None:
            return self._eager_batch(observations, actions)
        key = (self.action_sampler, *observations.shape[:2])
        program = self._programs.get(key)
        if program is not None and program.model is self.model:
            self._programs.move_to_end(key)
        else:
            self._programs.pop(key, None)
            while len(self._programs) >= PROGRAMS:
                self._programs.popitem(last=False)
            evaluator = weakref.proxy(self)  # the program must not hold its owner
            program = self._programs[key] = graphs.Program(
                lambda obs, acts: ((), evaluator._eager_batch(obs, acts)), (),
                [observations.clone(), actions.clone()], self.model, self._backend,
                generators=(self.generator,))
        return program(observations, actions)

    def evaluate(self, step: int, save_images: bool = True) -> Dict[str, float]:
        """Evaluates the model at ``step``; returns the logged metrics."""
        meter = AverageMeter()
        all_pred, all_gt = [], []
        self.generator.manual_seed(1234 + step)
        self.logger.print(f"== Evaluation [{step}][{self.logger_prefix}] ==")
        with eval_mode(self.model):
            batches_done = 0
            first = None
            for batch in self.dataloader:
                if (self.max_evaluation_batches is not None
                        and batches_done >= self.max_evaluation_batches):
                    break
                batches_done += 1
                observations = sequence_to_nchw(batch.observations, self.device)
                actions = torch.as_tensor(batch.actions, device=self.device)
                out, values = self._batch(observations, actions)
                if first is None:
                    first = (batch, graphs.copied(out))
                t = observations.shape[1]
                values = values.cpu().numpy()
                results = dict(zip(_SCALARS, values[:len(_SCALARS)].tolist()))
                terms = values[len(_SCALARS):len(_SCALARS) + 3 * t].reshape(3, t)
                for i in range(t):
                    results[f"observations_loss/pos_{i}"] = float(terms[0, i])
                    results[f"perceptual_loss/pos_{i}"] = float(terms[1, i])
                    results[f"states_loss/pos_{i}"] = float(terms[2, i])
                meter.add(results)
                all_pred.append(values[len(_SCALARS) + 3 * t:].astype(np.int64))
                # The last action of each sequence cannot be predicted.
                all_gt.append(np.asarray(batch.actions[:, :-1]).reshape(-1))
            if save_images and first is not None:
                self._save_examples(*first, step)

        if not all_pred:
            self.logger.print("- No evaluation batches available")
            return {}

        accuracy, mapping = compute_actions_accuracy(
            np.concatenate(all_pred), np.concatenate(all_gt), self.config["data"]["actions_count"])
        self.best_action_mappings = mapping

        prefix = self.logger_prefix
        if self._sampler_label:
            prefix = f"{prefix}/{self._sampler_label}"
        log_data = {f"{prefix}/actions_accuracy": accuracy}
        keys = list(_SCALARS)
        for i in range(first[0].observations.shape[1]):
            keys += [f"observations_loss/pos_{i}", f"perceptual_loss/pos_{i}",
                     f"states_loss/pos_{i}"]
        for key in keys:
            log_data[f"{prefix}/{key}"] = meter.pop(key)

        self.logger.log(log_data, step=step)
        for key in ("observations_loss/avg", "perceptual_loss/avg", "states_loss/avg"):
            self.logger.print(f"- {key}: {log_data[prefix + '/' + key]:.3f}")
        self.logger.print(f"- actions_accuracy: {accuracy:.3f}")
        return log_data

    @staticmethod
    def _attention_overlay(frames: np.ndarray, attention: np.ndarray) -> np.ndarray:
        """A low-resolution [0, 1] attention map (T, h', w', 1) over [-1, 1]
        frames (T, H, W, 3), upsampled by nearest neighbour: unattended
        pixels go black."""
        t, h, w = frames.shape[:3]
        att = attention[..., 0]
        ys = np.arange(h) * att.shape[1] // h
        xs = np.arange(w) * att.shape[2] // w
        att = att[:, ys][:, :, xs][..., None]
        return frames * att + (1.0 - att) * -1.0

    def _save_examples(self, batch, out: ModelOutput, step: int, max_sequences: int = 4):
        """Writes one image of example sequences, per sequence the rows:
        ground truth, reconstruction, ground-truth attention,
        reconstructed attention, motion weight mask."""
        out_dir = self.config["logging"].get("output_images_directory")
        if not out_dir:
            return
        os.makedirs(out_dir, exist_ok=True)
        gt = np.asarray(batch.observations[..., :3])  # (B, T, H, W, 3) in [-1, 1]
        rec = _nhwc(out.reconstructed_observations)  # (B, T-1, H, W, 3)
        attention = _nhwc(out.attention)  # (B, T, h, w, 1)
        rec_attention = (_nhwc(out.reconstructed_attention)
                         if out.reconstructed_attention is not None else None)
        motion = _nhwc(losses.motion_weight_mask(
            torch.from_numpy(np.ascontiguousarray(gt.transpose(0, 1, 4, 2, 3))),
            torch.from_numpy(np.ascontiguousarray(rec.transpose(0, 1, 4, 2, 3)))))
        motion = motion / max(float(motion.max()), 1e-6) * 2.0 - 1.0

        def pad_left(row_frames):
            return [np.zeros_like(row_frames[0])] + list(row_frames)

        rows = []
        for b in range(min(max_sequences, gt.shape[0])):
            seq_rows = [
                np.concatenate(list(gt[b]), axis=1),
                np.concatenate(pad_left(rec[b]), axis=1),
                np.concatenate(list(self._attention_overlay(gt[b], attention[b])), axis=1),
                np.concatenate(list(np.repeat(motion[b], 3, axis=-1)), axis=1),
            ]
            if rec_attention is not None:
                seq_rows.insert(3, np.concatenate(pad_left(
                    self._attention_overlay(rec[b], rec_attention[b])), axis=1))
            rows.append(np.concatenate(seq_rows, axis=0))
        grid = ((np.clip(np.concatenate(rows, axis=0), -1, 1) + 1.0) * 127.5).astype(np.uint8)
        write_frame(os.path.join(out_dir, f"{self.logger_prefix}_observations_{step}.png"), grid)


def make_evaluator(config: dict, model: Caddy, dataset, logger: Logger,
                   action_sampler: Optional[Callable] = None, logger_prefix: str = "test",
                   **kwargs) -> Evaluator:
    return Evaluator(config, model, dataset, logger, action_sampler, logger_prefix, **kwargs)
