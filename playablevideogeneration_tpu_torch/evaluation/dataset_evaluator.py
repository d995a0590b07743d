"""Offline dataset evaluators: metrics over a (reference, generated)
dataset pair.

Counterpart of ``playablevideogeneration_tpu/evaluation/dataset_evaluator.py``.
Per batch of the two datasets, zipped: the per-observation MSE,
motion-masked MSE, PSNR, SSIM, VGG cosine similarity and, with its
weights, LPIPS, on the device in f32 without gradients and read back once;
then, on the host, the detections, the movements between successful
detections paired with the generated frames' inferred actions.  At the
end: per-position statistics, the detection metric, the action-space
statistics and SVM accuracies, the density plots; over both datasets the
FID, the FVD and, when ``evaluation.compute_inception_score`` is set, the
generated frames' Inception Score; and the markers of what could not be
computed (``*_unavailable``, ``vgg_sim_note``).

Three protocols: generic (tennis: player positions from the detector),
Breakout (platform positions from a colour scan) and BAIR (arm states
from the reference videos' metadata, no detection metric).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from playablevideogeneration_tpu_torch.data.loader import DataLoader
from playablevideogeneration_tpu_torch.evaluation.metrics import frame_metrics
from playablevideogeneration_tpu_torch.evaluation.metrics.action_metrics import (
    action_classification_score,
    action_variance,
)
from playablevideogeneration_tpu_torch.evaluation.metrics.detection import (
    TennisPlayerDetector,
    breakout_platform_positions,
    detection_metric,
    make_detector,
)
from playablevideogeneration_tpu_torch.evaluation.metrics.fid import compute_fid
from playablevideogeneration_tpu_torch.evaluation.metrics.fvd import compute_fvd
from playablevideogeneration_tpu_torch.evaluation.metrics.inception import inception_score
from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device
from playablevideogeneration_tpu_torch.utils.logging import Logger
from playablevideogeneration_tpu_torch.utils.pretrained import make_metric_vgg

# Per-observation metrics, in the order of the batch's transfer.
_FRAME_METRICS = ("mse", "motion_masked_mse", "psnr", "ssim", "vgg_sim")


class MetricsAccumulator:
    """Concatenates the values added under each key."""

    def __init__(self):
        self._data: Dict[str, List[np.ndarray]] = {}

    def add(self, key: str, value: np.ndarray):
        self._data.setdefault(key, []).append(np.asarray(value))

    def pop(self, key: str) -> np.ndarray:
        # An absent key gives an empty array: with the detector backend
        # 'none', for example, no (movement, action) pair is ever added.
        values = self._data.pop(key, [])
        return np.concatenate(values, axis=0) if values else np.zeros((0,))


def compute_positional_statistics(values: np.ndarray, prefix: str) -> Dict:
    """Per-position mean and variance of (N, T) values, and the mean and
    variance of the per-position means."""
    results: Dict = {}
    positional = values.mean(axis=0)
    variances = values.var(axis=0)
    results[f"{prefix}/avg"] = float(positional.mean())
    results[f"{prefix}/var"] = float(positional.var())
    for i, v in enumerate(positional.tolist()):
        results[f"{prefix}/{i}"] = v
    for i, v in enumerate(variances.tolist()):
        results[f"{prefix}/{i}/var"] = v
    return results


class DatasetEvaluator:
    """The generic evaluator (the tennis protocol: 2-D player positions).

    :param vgg_variables: the converted VGG19 weights (a variables tree);
        None uses seeded random weights and records ``vgg_sim_note``
    :param lpips_fn: (B, T, H, W, 3) pair -> (B, T) on ``device``
        (``metrics.lpips.make_lpips_fn``); None records ``lpips_unavailable``
    :param detector: the movement detector; by default the config's
        ``evaluation.detector``
    :param fid_extractor: (N, H, W, 3) frames -> (N, D) numpy activations
        (``metrics.inception.make_fid_extractor``); None records
        ``fid_unavailable``
    :param fvd_embedder: (N, T, H, W, 3) videos -> (N, D) numpy embeddings
        (``metrics.i3d.make_fvd_embedder``); None records ``fvd_unavailable``
    :param class_probability_fn: (N, H, W, 3) frames -> (N, classes) numpy
        probabilities (``metrics.inception.make_class_probability_fn``),
        used when ``evaluation.compute_inception_score`` is set; None then
        records ``inception_score_unavailable``
    :param device: where the frame metrics run (default: cuda)
    """

    # Whether the protocol compares the reference's and the generated
    # detections.  BAIR's movements are the reference videos' metadata
    # states, which generated videos lack, so it compares none.
    uses_detection_metric = True

    def __init__(self, config: dict, logger: Logger, reference_dataset, generated_dataset,
                 vgg_variables: Optional[Dict] = None, lpips_fn=None,
                 fid_extractor=None, fvd_embedder=None,
                 detector: Optional[TennisPlayerDetector] = None,
                 class_probability_fn=None, device: DeviceLike = "cuda"):
        self.config = config
        self.logger = logger
        self.device = resolve_device(device)
        b = config["evaluation"]["batching"]
        if len(reference_dataset) != len(generated_dataset):
            raise ValueError(f"Reference and generated datasets differ in size: "
                             f"{len(reference_dataset)} vs {len(generated_dataset)}")
        self.reference_dataloader = DataLoader(reference_dataset, batch_size=b["batch_size"],
                                               shuffle=False, drop_last=False,
                                               num_workers=b["num_workers"])
        self.generated_dataloader = DataLoader(generated_dataset, batch_size=b["batch_size"],
                                               shuffle=False, drop_last=False,
                                               num_workers=b["num_workers"])
        self._vgg_pretrained = vgg_variables is not None
        self.vgg = make_metric_vgg(vgg_variables, self.device)
        self.lpips_fn = lpips_fn
        self.fid_extractor = fid_extractor
        self.fvd_embedder = fvd_embedder
        self.class_probability_fn = class_probability_fn
        self.compute_is = bool(config["evaluation"].get("compute_inception_score", False))
        self.detector = (make_detector(config, self.device) if detector is None
                         else detector)

    @torch.no_grad()
    def _compute_frame_metrics(self, reference: np.ndarray, generated: np.ndarray
                               ) -> Dict[str, np.ndarray]:
        """The batch's (B, T) per-observation metrics, computed on the
        device in f32 and read back in one transfer."""
        ref = torch.as_tensor(reference, device=self.device, dtype=torch.float32)
        gen = torch.as_tensor(generated, device=self.device, dtype=torch.float32)
        values = [frame_metrics.mse(ref, gen), frame_metrics.motion_masked_mse(ref, gen),
                  frame_metrics.psnr(ref, gen), frame_metrics.ssim(ref, gen),
                  frame_metrics.vgg_cosine_similarity(self.vgg, ref, gen)]
        names = list(_FRAME_METRICS)
        if self.lpips_fn is not None:
            values.append(self.lpips_fn(ref, gen))
            names.append("lpips")
        return dict(zip(names, torch.stack(values).cpu().numpy()))

    def compute_detections(self, observations: np.ndarray, batch) -> np.ndarray:
        """(B, T, H, W, C) -> (B, T, D) detections, -1 where none."""
        return self.detector(observations)

    def compute_movements_and_actions(self, reference_detections: np.ndarray,
                                      generated_batch) -> tuple:
        """The (movement, inferred action) pairs of consecutive successful
        reference detections, the action read from the generated frame's
        metadata."""
        movements, inferred_actions = [], []
        b, t = reference_detections.shape[:2]
        for seq in range(b):
            metadata = generated_batch.videos[seq].metadata
            start = generated_batch.initial_frames[seq]
            for obs in range(t - 1):
                if (reference_detections[seq, obs, 0] != -1
                        and reference_detections[seq, obs + 1, 0] != -1):
                    meta = metadata[start + obs]
                    if "inferred_action" not in meta:
                        continue
                    movements.append(reference_detections[seq, obs + 1]
                                     - reference_detections[seq, obs])
                    inferred_actions.append(meta["inferred_action"])
        return np.asarray(movements, np.float64), np.asarray(inferred_actions, np.int64)

    def compute_metrics(self) -> Dict:
        acc = MetricsAccumulator()
        n_batches = len(self.reference_dataloader)
        for idx, (ref_batch, gen_batch) in enumerate(
                zip(self.reference_dataloader, self.generated_dataloader)):
            self.logger.print(f"- Computing metrics for batch [{idx}/{n_batches}]")
            ref_obs = ref_batch.observations  # (B, T, H, W, 3) in [0, 1]
            gen_obs = gen_batch.observations
            if ref_obs.min() < 0 or ref_obs.max() > 1 or gen_obs.min() < 0 or gen_obs.max() > 1:
                raise ValueError("Input observations outside allowed range [0, 1]")

            for key, value in self._compute_frame_metrics(ref_obs, gen_obs).items():
                acc.add(key, value)

            ref_det = self.compute_detections(ref_obs, ref_batch)
            if self.uses_detection_metric:
                acc.add("reference_detections", ref_det)
                acc.add("generated_detections", self.compute_detections(gen_obs, gen_batch))

            movements, inferred = self.compute_movements_and_actions(ref_det, gen_batch)
            if len(movements):
                acc.add("movements", movements)
                acc.add("inferred_actions", inferred)

        results: Dict = {}
        for key in _FRAME_METRICS:
            results.update(compute_positional_statistics(acc.pop(key), key))
        if self.lpips_fn is not None:
            results.update(compute_positional_statistics(acc.pop("lpips"), "lpips"))
        else:
            results["lpips_unavailable"] = "no pretrained LPIPS weights provided"
        if not self._vgg_pretrained:
            results["vgg_sim_note"] = "random VGG19 features (no pretrained weights)"

        if self.uses_detection_metric:
            ref_det = acc.pop("reference_detections")
            gen_det = acc.pop("generated_detections")
            if ref_det.size and bool((ref_det[..., 0] != -1).any()):
                results.update(detection_metric(ref_det, gen_det, "detection"))
            else:
                results["detection_unavailable"] = "no detector backend provided"
        else:
            results["detection_unavailable"] = (
                "protocol computes no detection metric "
                "(reference dataset_evaluator_bair.py has no detector)")

        movements = acc.pop("movements")
        inferred = acc.pop("inferred_actions")
        actions_count = self.config["data"]["actions_count"]
        if len(movements):
            results.update(action_variance(inferred, movements, actions_count))
            results.update(action_classification_score(inferred, movements, actions_count))
            self._plot_action_space(inferred, movements, actions_count)
        else:
            results["action_space_unavailable"] = "no (movement, action) pairs could be extracted"

        if self.fid_extractor is not None:
            self.logger.print("- Computing FID score")
            results["fid"] = self._compute_fid()
        else:
            results["fid_unavailable"] = "no FID Inception weights provided"
        if self.fvd_embedder is not None:
            self.logger.print("- Computing FVD score")
            results["fvd"] = self._compute_fvd()
        else:
            results["fvd_unavailable"] = "no FVD I3D weights provided"
        if self.compute_is:
            if self.class_probability_fn is not None:
                self.logger.print("- Computing Inception Score")
                probs = np.concatenate([self.class_probability_fn(frames) for frames in
                                        self._iter_frames(self.generated_dataloader)], axis=0)
                results["inception_score"], results["inception_score_std"] = \
                    inception_score(probs)
            else:
                results["inception_score_unavailable"] = "no Inception classifier head available"
        return results

    def _iter_frames(self, dataloader):
        """The loader's batches as (B*T, H, W, 3) frames."""
        for batch in dataloader:
            obs = batch.observations
            yield obs.reshape((-1,) + obs.shape[2:])

    def _compute_fid(self) -> float:
        """The FID over every frame of both datasets."""
        return compute_fid(self.fid_extractor, self._iter_frames(self.reference_dataloader),
                           self._iter_frames(self.generated_dataloader))

    def _compute_fvd(self) -> float:
        return compute_fvd(self.fvd_embedder,
                           (b.observations for b in self.reference_dataloader),
                           (b.observations for b in self.generated_dataloader))

    def plot_kwargs(self) -> dict:
        """The protocol's density-plot limits and orientation."""
        return {}

    def _plot_action_space(self, actions, movements, actions_count):
        from playablevideogeneration_tpu_torch.evaluation.plotting import density_plots

        out_dir = self.config["logging"].get("output_directory")
        if out_dir:
            density_plots.plot_all(actions, movements, actions_count, out_dir,
                                   **self.plot_kwargs())


class DatasetEvaluatorBreakout(DatasetEvaluator):
    """Breakout: movements are the platform's 1-D x-position deltas, found
    by a colour-band scan."""

    def compute_detections(self, observations: np.ndarray, batch) -> np.ndarray:
        return breakout_platform_positions(observations)

    def plot_kwargs(self) -> dict:
        return {"xlim": (-40, 40), "ylim": (-10, 10)}


class DatasetEvaluatorBair(DatasetEvaluator):
    """BAIR: movements are the arm-state deltas in the reference videos'
    per-frame metadata ``state``; no visual detector, no detection
    metric."""

    uses_detection_metric = False

    def compute_detections(self, observations: np.ndarray, batch) -> np.ndarray:
        b, t = observations.shape[:2]
        out = None
        for seq in range(b):
            metadata = batch.videos[seq].metadata
            start = batch.initial_frames[seq]
            for obs in range(t):
                meta = metadata[start + obs] if start + obs < len(metadata) else {}
                state = meta.get("state")
                if state is None:
                    continue
                state = np.asarray(state, np.float64).reshape(-1)
                if out is None:
                    out = np.full((b, t, state.shape[0]), -1.0)
                out[seq, obs] = state
        if out is None:
            out = np.full((b, t, 2), -1.0)
        return out

    def plot_kwargs(self) -> dict:
        return {"xlim": (-0.1, 0.1), "ylim": (-0.1, 0.1), "axis_inversion": True}


def make_dataset_evaluator(config, logger, reference_dataset, generated_dataset,
                           **kwargs) -> DatasetEvaluator:
    return DatasetEvaluator(config, logger, reference_dataset, generated_dataset, **kwargs)


def make_dataset_evaluator_breakout(config, logger, reference_dataset, generated_dataset,
                                    **kwargs) -> DatasetEvaluator:
    return DatasetEvaluatorBreakout(config, logger, reference_dataset, generated_dataset,
                                    **kwargs)


def make_dataset_evaluator_bair(config, logger, reference_dataset, generated_dataset,
                                **kwargs) -> DatasetEvaluator:
    return DatasetEvaluatorBair(config, logger, reference_dataset, generated_dataset, **kwargs)
