"""The 12 semantic classes, their palette and the mask codecs
``color2label``, ``shrink`` and ``label2color`` (``sahs_tpu/utils/seg.py``,
copied: the port never imports the JAX package; reference
nerf-pytorch/nerf/utils.py:5-140). Classes: 0 background, 1 face, 2 nose,
3 glasses, 4 eyes, 5 brows, 6 ears, 7 mouth-interior, 8 lips, 9 hair,
10 neck, 11 torso.
"""
from __future__ import annotations

import numpy as np

NUM_CLASSES = 12

# RGB palette (reference utils.py:29-45).
PALETTE = np.array(
    [
        [0, 0, 0],        # background
        [204, 0, 0],      # face
        [76, 153, 0],     # nose
        [204, 204, 0],    # glasses
        [51, 51, 255],    # eyes
        [0, 255, 255],    # brows
        [102, 51, 0],     # ears
        [102, 204, 0],    # mouth interior
        [255, 255, 0],    # lips
        [0, 0, 204],      # hair
        [255, 153, 51],   # neck
        [0, 204, 0],      # torso
    ],
    dtype=np.int32,
)


def color2label(target: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB parse map -> (H, W, 12) int32 one-hot. A pixel that
    matches no palette entry maps to all zeros (the reference's
    behaviour)."""
    flat = target.reshape(-1, 3).astype(np.int32)
    eq = (flat[:, None, :] == PALETTE[None, :, :]).all(axis=-1)   # (N, 12)
    return eq.reshape(target.shape[0], target.shape[1], NUM_CLASSES).astype(np.int32)


def shrink(mask: np.ndarray) -> np.ndarray:
    """The argmax of a (H, W, 12) soft mask, one-hot again, int32
    (reference utils.py:5-24)."""
    return np.eye(NUM_CLASSES, dtype=np.int32)[np.argmax(mask, axis=-1)]


def label2color(mask: np.ndarray) -> np.ndarray:
    """(H, W, 12) -> (H, W, 3) float BGR-ordered colours in [0, 1]: the
    reference writes the palette reversed per pixel (utils.py:138, cv2's
    BGR convention), kept for output parity (``sahs_tpu/utils/seg.py``)."""
    labels = np.argmax(mask, axis=-1)
    colors = PALETTE[:, ::-1].astype(np.float32) / 255.0
    return colors[labels]
