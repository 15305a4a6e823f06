"""The 12 semantic classes and their palette (the part of
``sahs_tpu/utils/seg.py`` the synthetic dataset needs, copied: the port
never imports the JAX package). Classes: 0 background, 1 face, 2 nose,
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

