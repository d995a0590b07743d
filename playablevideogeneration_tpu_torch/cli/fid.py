"""The FID between two paths, as ``python -m pytorch_fid path1 path2``.

Counterpart of ``playablevideogeneration_tpu/cli/fid.py``: each path is a
directory of ``*.jpg`` / ``*.jpeg`` / ``*.png`` / ``*.bmp`` images or an
``.npz`` file of statistics (``mu``, ``sigma``); prints ``FID:  <value>``.
``--save-stats`` writes the first path's statistics to the second, an
``.npz``, instead (to compute a reference set's statistics once).

The backbone is ``evaluation/metrics/inception.py`` on ``--device``
(default ``cuda``); its weights resolve as the offline evaluation's do
(``--weights``, else ``fid_inception.npz`` in ``PVG_PRETRAINED_WEIGHTS``).
Two ``.npz`` files need no backbone.  Reading images needs Pillow.

    python -m playablevideogeneration_tpu_torch.cli.fid path_a path_b
    python -m playablevideogeneration_tpu_torch.cli.fid --save-stats path_a out.npz
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Iterator, List

import numpy as np

from playablevideogeneration_tpu_torch.evaluation.metrics.fid import (
    compute_statistics_from_frames,
    fid_from_statistics,
)
from playablevideogeneration_tpu_torch.utils import pretrained

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def list_images(directory: str) -> List[str]:
    files = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if f.lower().endswith(IMAGE_EXTENSIONS))
    if not files:
        raise SystemExit(f"No images ({'/'.join(IMAGE_EXTENSIONS)}) in '{directory}'")
    return files


def iter_image_batches(files: List[str], batch_size: int,
                       quiet: bool = False) -> Iterator[np.ndarray]:
    """(N, H, W, 3) f32 batches in [0, 1], unresized (the backbone resizes
    to 299).  A batch ends early where the next image's size differs, so a
    directory of mixed sizes gives smaller batches."""
    from PIL import Image

    batch: List[np.ndarray] = []
    for i, path in enumerate(files):
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        if batch and img.shape != batch[0].shape:
            yield np.stack(batch)
            batch = []
        batch.append(img)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
        if not quiet and (i + 1) % (batch_size * 4) == 0:
            print(f"  {i + 1}/{len(files)} images", file=sys.stderr)
    if batch:
        yield np.stack(batch)


def statistics_of_path(path: str, extractor, batch_size: int, quiet: bool):
    """(mu, sigma) of one path."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    return compute_statistics_from_frames(
        extractor, iter_image_batches(list_images(path), batch_size, quiet))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("path", nargs=2,
                        help="two image directories and/or .npz statistics files")
    parser.add_argument("--batch-size", type=int, default=50)
    parser.add_argument("--weights", default=None,
                        help="fid_inception.npz path (default: resolve via "
                             "PVG_PRETRAINED_WEIGHTS)")
    parser.add_argument("--save-stats", action="store_true",
                        help="write path1's statistics to path2 (.npz) instead of computing FID")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the Inception backbone (default: cuda)")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    config = ({"tpu": {"pretrained_weights": {"fid_inception": args.weights}}}
              if args.weights else {})
    extractor = pretrained.get_fid_extractor(config, device=args.device)
    needs_model = args.save_stats or any(not p.endswith(".npz") for p in args.path)
    if extractor is None and needs_model:
        raise SystemExit(
            "No FID InceptionV3 weights found — pass --weights or set "
            "PVG_PRETRAINED_WEIGHTS (docs/PRETRAINED_WEIGHTS.md); FID over "
            "random features would be meaningless.")

    if args.save_stats:
        src, dst = args.path
        if not dst.endswith(".npz"):
            raise SystemExit("--save-stats output path must end in .npz")
        mu, sigma = statistics_of_path(src, extractor, args.batch_size, args.quiet)
        os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
        np.savez(dst, mu=mu, sigma=sigma)
        print(f"Saved statistics of {src} to {dst}")
        return

    for p in args.path:
        if not os.path.exists(p):
            raise SystemExit(f"Invalid path: {p}")
    mu1, s1 = statistics_of_path(args.path[0], extractor, args.batch_size, args.quiet)
    mu2, s2 = statistics_of_path(args.path[1], extractor, args.batch_size, args.quiet)
    print("FID: ", fid_from_statistics(mu1, s1, mu2, s2))


if __name__ == "__main__":
    main()
