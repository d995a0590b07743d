"""Interactive playable-video generation.

Counterpart of ``playablevideogeneration_tpu/cli/play.py``.  Plays a
trained model on the GPU by default; ``--device cpu`` runs on the CPU
when asked, and without a GPU the default raises:

    python -m playablevideogeneration_tpu_torch.cli.play --config configs/01_bair.yaml

Three front ends over one ``PlaySession``:

- default: a scripted rollout of ``--frames`` random actions, read back
  in one transfer, timed and saved as a session;
- ``--interactive``: the terminal, one key per action (``InputHelper``),
  ``0`` saves the session and restarts it, ``q`` quits;
- ``--window``: an OpenCV window with the same keys (needs a display).

A session is saved as PNG frames, ``session.pkl`` (actions and
timestamps) and, when ffmpeg is installed, four mp4 variants.  The model
comes from the run's ``latest`` checkpoint or, with
``--reference-checkpoint``, from a reference ``.pth.tar``.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import List, Optional, Tuple

import numpy as np

from playablevideogeneration_tpu_torch.config import registry
from playablevideogeneration_tpu_torch.config.configuration import Configuration
from playablevideogeneration_tpu_torch.data.splitter import generate_splits
from playablevideogeneration_tpu_torch.data.transforms import get_final_transforms
from playablevideogeneration_tpu_torch.data.video import pillow_image, write_frame
from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset
from playablevideogeneration_tpu_torch.inference.play_session import PlaySession, frame_to_uint8
from playablevideogeneration_tpu_torch.utils.device import DeviceLike, resolve_device
from playablevideogeneration_tpu_torch.utils.input_helper import InputHelper
from playablevideogeneration_tpu_torch.utils.logging import Logger
from playablevideogeneration_tpu_torch.utils.video_saver import VideoSaver


def load_trained_model(config_dict: dict, split: str, device: DeviceLike = "cuda",
                       dataset: Optional[VideoDataset] = None,
                       reference_checkpoint: Optional[str] = None):
    """(model in evaluation mode, the split's dataset, logger): the config's
    model on ``device`` with the run's ``latest`` checkpoint or, with
    ``reference_checkpoint``, a reference ``.pth.tar`` loaded through the
    config's trainer.

    :param dataset: the split's ``VideoDataset`` in place of the one the
        config's data root holds (videos held in memory, for example)
    """
    registry._register_defaults()
    logger = Logger(config_dict)
    device = resolve_device(device)
    seed = config_dict.get("seed", 0)
    model = registry.resolve("model", config_dict["model"]["architecture"])(
        config_dict, device, seed)
    if dataset is None:
        path, batching, allowed = generate_splits(config_dict)[split]
        dataset = VideoDataset(path, batching, get_final_transforms(config_dict)[split],
                               allowed_videos=allowed)
    trainer = registry.resolve("trainer", config_dict["training"]["trainer"])(
        config_dict, model, dataset, logger, seed=seed)
    trainer.init_state()
    if reference_checkpoint:
        trainer.load_reference_weights(reference_checkpoint)
    else:
        trainer.load_checkpoint()
        logger.print(f"- Loaded checkpoint at step {trainer.global_step}")
    return model.eval(), dataset, logger


def load_play_session(config_dict: dict, noise: bool = False,
                      reference_checkpoint: Optional[str] = None, device: DeviceLike = "cuda",
                      dataset: Optional[VideoDataset] = None
                      ) -> Tuple[PlaySession, np.ndarray, Logger]:
    """(session, start observation, logger): the trained model
    (``load_trained_model``) in a ``PlaySession`` started from a frame of
    a validation sequence, both drawn from a generator seeded with the
    current time in seconds."""
    model, dataset, logger = load_trained_model(config_dict, "validation", device, dataset,
                                                reference_checkpoint)
    rng = np.random.default_rng(int(time.time()))
    sample = dataset[int(rng.integers(0, len(dataset)))]
    t = int(rng.integers(0, sample.observations.shape[0]))
    observation = sample.observations[t]
    session = PlaySession(model, noise=noise)
    session.start(observation)
    return session, observation, logger


def save_session(frames, actions, output_dir: str, logger: Logger, timestamps=None) -> None:
    """Saves a session: ``00000.png`` ..., ``session.pkl`` with the actions
    and timestamps, and when ffmpeg is installed the plain, action-labelled,
    timecoded and timecoded-labelled mp4s.  Needs Pillow."""
    if not frames:
        logger.print("- Nothing to save: no frames recorded")
        return
    pillow_image("saving a play session as PNG frames")
    os.makedirs(output_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        write_frame(os.path.join(output_dir, f"{i:05d}.png"), frame_to_uint8(frame))
    with open(os.path.join(output_dir, "session.pkl"), "wb") as f:
        pickle.dump({"actions": actions, "timestamps": timestamps}, f)
    saver = VideoSaver()
    if saver.available:
        stacked = np.stack([frame_to_uint8(f) for f in frames])
        saver.save_video(stacked, os.path.join(output_dir, "session.mp4"))
        saver.save_video_with_actions(stacked, actions,
                                      os.path.join(output_dir, "session_actions.mp4"))
        if timestamps is not None and len(timestamps) == len(frames):
            saver.save_video_timecoded(stacked, timestamps,
                                       os.path.join(output_dir, "session_timecoded.mp4"))
            saver.save_video_timecoded(
                stacked, timestamps, os.path.join(output_dir, "session_timecoded_actions.mp4"),
                actions=actions)
    logger.print(f"- Session saved to {output_dir}")


class SessionRecorder:
    """The interactive front ends' bookkeeping: records (frame, action,
    timestamp) triples, saves on demand and then restarts the session from
    its start observation."""

    def __init__(self, session: PlaySession, observation, logger: Logger, output_dir: str):
        self.session = session
        self.observation = observation
        self.logger = logger
        self.output_dir = output_dir
        self.frames, self.actions, self.timestamps = [], [], []

    def step(self, action: int):
        """Generates one frame for ``action``; returns (uint8 frame, ms)."""
        start = time.perf_counter()
        frame = self.session.generate_next_u8(action)
        latency = (time.perf_counter() - start) * 1000
        self.frames.append(frame)
        self.actions.append(action)
        self.timestamps.append(time.time())
        return frame, latency

    def save_and_reset(self) -> None:
        save_session(self.frames, self.actions,
                     os.path.join(self.output_dir, f"session_{int(time.time())}"),
                     self.logger, timestamps=self.timestamps)
        self.frames, self.actions, self.timestamps = [], [], []
        if self.observation is not None:
            self.session.start(self.observation)  # a fresh state and window


def interactive_loop(session: PlaySession, logger: Logger, output_dir: str, actions_count: int,
                     observation=None, input_helper: Optional[InputHelper] = None) -> None:
    """The terminal front end: keys 1..N act, 0 saves and restarts, q or
    the end of input quits."""
    recorder = SessionRecorder(session, observation, logger, output_dir)
    if input_helper is None:
        input_helper = InputHelper(interactive=True)
    logger.print(f"Keys: 1..{actions_count} = action, 0 = save & reset, q = quit")
    while True:
        key = input_helper.read_character().strip()
        if key in ("q", ""):
            break
        if key == "0":
            recorder.save_and_reset()
            continue
        try:
            action = int(key) - 1
        except ValueError:
            continue
        if not 0 <= action < actions_count:
            continue
        frame, latency = recorder.step(action)
        logger.print(f"frame {len(recorder.frames)} action {action} ({latency:.1f} ms)")


def window_loop(session: PlaySession, logger: Logger, output_dir: str, actions_count: int,
                observation=None, zoom: int = 10) -> None:
    """The OpenCV front end: the frame (first the start observation) zoomed
    by nearest neighbour, keys 1..N act, 0 saves and restarts, q / ESC or
    closing the window quits.  Needs OpenCV and a display."""
    import cv2

    window = "playable video generation"
    cv2.namedWindow(window, cv2.WINDOW_NORMAL)
    recorder = SessionRecorder(session, observation, logger, output_dir)

    def initial_frame():
        if observation is None:
            return None
        return frame_to_uint8(np.asarray(observation)[..., :3])

    frame = initial_frame()
    logger.print(f"Keys: 1..{actions_count} = action, 0 = save & reset, q = quit")
    while True:
        if frame is not None:
            display = cv2.resize(frame, (frame.shape[1] * zoom, frame.shape[0] * zoom),
                                 interpolation=cv2.INTER_NEAREST)
            label = f"action {recorder.actions[-1]}" if recorder.actions else ""
            cv2.putText(display, label, (8, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 255), 2)
            cv2.imshow(window, cv2.cvtColor(display, cv2.COLOR_RGB2BGR))
        raw = cv2.waitKey(0)
        if raw == -1 or cv2.getWindowProperty(window, cv2.WND_PROP_VISIBLE) < 1:
            break  # the window was closed
        # Some OpenCV builds set modifier bits (NumLock ...) above the key.
        key = raw & 0xFF
        if key in (ord("q"), 27):
            break
        action = key - ord("0") - 1
        if action == -1:
            recorder.save_and_reset()
            frame = initial_frame()
            continue
        if not 0 <= action < actions_count:
            continue
        frame, _latency = recorder.step(action)
    cv2.destroyAllWindows()


def scripted_rollout(session: PlaySession, actions_count: int, frames: int,
                     logger: Logger) -> Tuple[np.ndarray, List[int]]:
    """The default front end's rollout: ``frames`` actions drawn from a
    generator seeded with 0, through ``PlaySession.rollout`` (one readback);
    returns the (frames, H, W, 3) uint8 frames and the actions."""
    actions = np.random.default_rng(0).integers(0, actions_count, size=frames)
    start = time.perf_counter()
    generated = session.rollout(actions)
    elapsed = time.perf_counter() - start
    logger.print(f"- Generated {len(generated)} frames in {elapsed:.2f}s "
                 f"({len(generated) / elapsed:.1f} fps)")
    return generated, actions.tolist()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--interactive", action="store_true")
    parser.add_argument("--window", action="store_true", help="OpenCV window (needs a display)")
    parser.add_argument("--frames", type=int, default=60, help="scripted rollout length")
    parser.add_argument("--noise", action="store_true", help="sample N(0,1) action variations")
    parser.add_argument("--reference-checkpoint", type=str, default=None,
                        help="import weights from a reference .pth.tar checkpoint instead "
                             "of the run's latest checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to play on (default: cuda)")
    args = parser.parse_args()

    configuration = Configuration(args.config)
    configuration.check_config()
    configuration.create_directory_structure()
    config_dict = configuration.get_config()

    session, observation, logger = load_play_session(
        config_dict, noise=args.noise, reference_checkpoint=args.reference_checkpoint,
        device=args.device)
    output_dir = config_dict["logging"]["output_directory"]
    actions_count = config_dict["data"]["actions_count"]
    if args.window:
        window_loop(session, logger, output_dir, actions_count, observation=observation)
    elif args.interactive:
        interactive_loop(session, logger, output_dir, actions_count, observation=observation)
    else:
        frames, actions = scripted_rollout(session, actions_count, args.frames, logger)
        save_session(list(frames), actions, os.path.join(output_dir, "scripted_session"), logger)


if __name__ == "__main__":
    main()
