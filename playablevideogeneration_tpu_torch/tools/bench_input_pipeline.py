"""Input-pipeline throughput benchmark: thread vs process decode.

Counterpart of ``tools/bench_input_pipeline.py`` of the JAX package.  It
measures the ``DataLoader``'s batches per second (and frames per second
decoded) over a flat synthetic dataset written to disk as PNG frames, in
both worker modes, each after one warm-up epoch, so that the host
pipeline can be sized against the device step before real-data training
(the reference uses multi-process loader workers,
training/trainer.py:39).  Host-only: no batch is copied to a device.

    python -m playablevideogeneration_tpu_torch.tools.bench_input_pipeline \\
        [--videos 8] [--size 64]

Prints one JSON line: ``thread`` and ``process``, each with
``batches_per_sec`` and ``frames_per_sec``, and ``workers``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--videos", type=int, default=8)
    parser.add_argument("--length", type=int, default=48)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--observations", type=int, default=6)
    parser.add_argument("--workers", type=int, default=max(1, (os.cpu_count() or 2) - 1))
    args = parser.parse_args(argv)

    from playablevideogeneration_tpu_torch.data.loader import DataLoader
    from playablevideogeneration_tpu_torch.data.synthetic import build_synthetic_dataset
    from playablevideogeneration_tpu_torch.data.transforms import make_train_transform
    from playablevideogeneration_tpu_torch.data.video_dataset import VideoDataset

    with tempfile.TemporaryDirectory() as root:
        build_synthetic_dataset(root, videos_per_split=args.videos, length=args.length,
                                height=args.size, width=args.size, actions_count=3, flat=True)
        batching = {"batch_size": args.batch_size, "observations_count": args.observations,
                    "skip_frames": 0, "observation_stacking": 1, "num_workers": args.workers}
        transform = make_train_transform(None, (args.size, args.size))
        dataset = VideoDataset(root, batching, transform)

        results = {}
        for mode in ("thread", "process"):
            loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                                drop_last=True, num_workers=args.workers, worker_mode=mode)
            # A warm-up epoch populates any lazy caches fairly for both modes.
            for _ in loader:
                pass
            start = time.perf_counter()
            batches = frames = 0
            for batch in loader:
                batches += 1
                frames += batch.observations.shape[0] * batch.observations.shape[1]
            elapsed = time.perf_counter() - start
            results[mode] = {"batches_per_sec": batches / elapsed,
                             "frames_per_sec": frames / elapsed}
        results["workers"] = args.workers
        print(json.dumps(results))
        return results


if __name__ == "__main__":
    main()
