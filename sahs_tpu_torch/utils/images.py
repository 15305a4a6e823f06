"""Image files as the JAX package writes and reads them (``imageio.v2``),
through PIL with its defaults: PIL's JPEG at default settings is
``imageio``'s byte for byte, and its PNGs decode equal. OpenCV's JPEG at
its default quality is not, so frames are never written through it."""
from __future__ import annotations

import numpy as np
from PIL import Image


def imwrite(path: str, img: np.ndarray) -> None:
    """A uint8 (H, W) or (H, W, 3) array to ``path``; the format from its
    extension."""
    Image.fromarray(np.asarray(img)).save(path)


def imread(path: str) -> np.ndarray:
    """The file's pixels as a uint8 array, (H, W) or (H, W, C)."""
    with Image.open(path) as im:
        return np.asarray(im)
