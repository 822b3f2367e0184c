"""Image loading for RGB and binary edge images.

Replaces the reference's OpenCV imread path (reference:
src/edgegraph3d/utils/edge_graph_3d_utilities.cpp:285-344 parse_images).
Edge images are white-edge-on-black binary maps
(reference: global_defines.hpp EDGE_COLOR white).
"""

from __future__ import annotations

import os
import re

import numpy as np
from PIL import Image


def _numeric_key(name: str):
    m = re.findall(r"\d+", name)
    return (int(m[-1]) if m else 0, name)


def list_image_files(folder: str) -> list[str]:
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
    names = [n for n in os.listdir(folder)
             if os.path.splitext(n)[1].lower() in exts]
    return [os.path.join(folder, n) for n in sorted(names, key=_numeric_key)]


def load_edge_image(path: str, threshold: int = 127) -> np.ndarray:
    """Load a binary edge image -> uint8 {0,255} [H,W]."""
    img = np.asarray(Image.open(path).convert("L"))
    return np.where(img > threshold, 255, 0).astype(np.uint8)


def load_rgb_image(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def load_edge_images(folder: str, image_paths: list[str] | None = None,
                     pad_to_common: bool = True) -> np.ndarray:
    """Load all edge images in a folder into one [C,H,W] uint8 stack.

    If `image_paths` (from the SfM views) is given, files are matched to
    the view order by basename, mirroring parse_images' matching of the
    image folder to camerasPaths_ (edge_graph_3d_utilities.cpp:285-344).
    """
    files = list_image_files(folder)
    if image_paths:
        by_base = {os.path.basename(f): f for f in files}
        ordered = []
        for p in image_paths:
            base = os.path.basename(p)
            stem = os.path.splitext(base)[0]
            cand = by_base.get(base)
            if cand is None:
                matches = [f for f in files
                           if os.path.splitext(os.path.basename(f))[0] == stem]
                if not matches:
                    raise FileNotFoundError(
                        f"no edge image for view {p!r} in {folder!r}")
                cand = matches[0]
            ordered.append(cand)
        files = ordered
    imgs = [load_edge_image(f) for f in files]
    if pad_to_common:
        H = max(i.shape[0] for i in imgs)
        W = max(i.shape[1] for i in imgs)
        out = np.zeros((len(imgs), H, W), dtype=np.uint8)
        for c, im in enumerate(imgs):
            out[c, : im.shape[0], : im.shape[1]] = im
        return out
    return np.stack(imgs)
