"""Video writing: an ffmpeg pipe when ffmpeg is installed, PNG frames
otherwise.

Counterpart of ``playablevideogeneration_tpu/utils/video_saver.py``: raw
RGB frames piped to an ``ffmpeg`` subprocess (x264), plus the variants
with an action label drawn on each frame and resampled to the frames'
wall-clock timestamps.  ``available`` is false without ffmpeg.  Pillow is
imported only to draw the labels or write PNG frames.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np

from playablevideogeneration_tpu_torch.data.video import pillow_image, write_frame


def _labelled(frame: np.ndarray, action, upscale: int) -> np.ndarray:
    """The frame with ``action <n>`` drawn in its top-left corner."""
    Image = pillow_image("drawing action labels on video frames")
    from PIL import ImageDraw

    image = Image.fromarray(np.asarray(frame, np.uint8))
    if upscale > 1:
        image = image.resize((image.width * upscale, image.height * upscale), Image.NEAREST)
    ImageDraw.Draw(image).text((4, 4), f"action {action}", fill=(255, 255, 0))
    return np.asarray(image)


class VideoSaver:
    def __init__(self, framerate: int = 10, crf: int = 23):
        self.framerate = framerate
        self.crf = crf
        self.ffmpeg = shutil.which("ffmpeg")

    @property
    def available(self) -> bool:
        return self.ffmpeg is not None

    def save_video(self, frames: np.ndarray, path: str) -> str:
        """Writes (N, H, W, 3) uint8 frames as an mp4 through ffmpeg, or as
        a directory of PNG frames without it; returns what it wrote."""
        frames = np.asarray(frames, np.uint8)
        if not self.available:
            base = os.path.splitext(path)[0] + "_frames"
            os.makedirs(base, exist_ok=True)
            for i, frame in enumerate(frames):
                write_frame(os.path.join(base, f"{i:05d}.png"), frame)
            return base
        n, h, w, _ = frames.shape
        cmd = [self.ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{w}x{h}",
               "-r", str(self.framerate), "-i", "-", "-an", "-vcodec", "libx264",
               "-crf", str(self.crf), "-pix_fmt", "yuv420p", path]
        # ffmpeg's stderr goes to a file: a pipe could fill while this
        # process is still writing frames to its stdin, and deadlock.
        with tempfile.TemporaryFile() as err:
            proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                                    stderr=err)
            try:
                proc.stdin.write(frames.tobytes())
                proc.stdin.close()
            except BrokenPipeError:
                pass  # ffmpeg exited early; its stderr is reported below
            if proc.wait() != 0:
                err.seek(0)
                tail = err.read().decode("utf-8", "replace").strip()
                raise RuntimeError(f"ffmpeg failed (rc={proc.returncode}) writing {path}: "
                                   + " | ".join(tail.splitlines()[-3:]))
        return path

    def save_video_with_actions(self, frames: np.ndarray, actions: Sequence[int], path: str,
                                upscale: int = 1) -> str:
        """Draws each frame's action index on it, then saves."""
        annotated = [_labelled(frame, action, upscale) for frame, action in zip(frames, actions)]
        return self.save_video(np.stack(annotated), path)

    def save_video_timecoded(self, frames: np.ndarray, timestamps: Sequence[float], path: str,
                             actions: Optional[Sequence[int]] = None,
                             upscale: int = 1) -> str:
        """Resamples the frames to their wall-clock times, so the video plays
        at the speed it was generated: each frame is repeated over [t_i,
        t_{i+1}) at the saver's frame rate, the last one for the median
        interval; with ``actions``, each frame carries its action label."""
        frames = np.asarray(frames, np.uint8)
        timestamps = np.asarray(timestamps, np.float64)
        if len(timestamps) != len(frames):
            raise ValueError("one timestamp per frame required")
        start = timestamps[0]
        intervals = np.diff(timestamps)
        tail = float(np.median(intervals)) if len(intervals) else 1.0 / self.framerate
        ends = np.concatenate([timestamps[1:], [timestamps[-1] + tail]])

        timecoded: List[np.ndarray] = []
        for idx, frame in enumerate(frames):
            if actions is not None:
                frame = _labelled(frame, actions[idx], upscale)
            first_tick = int(round((timestamps[idx] - start) * self.framerate))
            last_tick = int(round((ends[idx] - start) * self.framerate))
            timecoded.extend([frame] * max(1, last_tick - first_tick))
        return self.save_video(np.stack(timecoded), path)
