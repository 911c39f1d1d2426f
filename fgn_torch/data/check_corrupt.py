"""Corrupt-image scan for downloaded datasets.

Rebuild of the reference's datasets/coco/check_corrupt.py: decode every
image in a directory with both cv2 and PIL and report files that fail
either decoder (the reference found one corrupt COCO train2017 sample
and committed it as evidence).

    python -m fgn_torch.data.check_corrupt <images_dir>
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple


def check_dir(imgs_dir: str, verbose: bool = True) -> List[Tuple[str, str]]:
    """Returns [(filename, reason), ...] for undecodable images."""
    import cv2

    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        Image = None

    bad = []
    names = sorted(os.listdir(imgs_dir))
    for i, name in enumerate(names):
        fp = os.path.join(imgs_dir, name)
        if not os.path.isfile(fp):
            continue
        img = cv2.imread(fp)
        if img is None or img.size == 0:
            bad.append((name, "cv2 decode failed"))
            continue
        if Image is not None:
            try:
                with Image.open(fp) as im:
                    im.verify()
            except Exception as e:
                bad.append((name, f"PIL: {e}"))
        if verbose and i and i % 10000 == 0:
            print(f"checked {i}/{len(names)}, {len(bad)} corrupt so far")
    if verbose:
        print(f"{len(bad)} corrupt of {len(names)} files in {imgs_dir}")
        for name, reason in bad:
            print(f"  {name}: {reason}")
    return bad


if __name__ == "__main__":
    check_dir(sys.argv[1])
