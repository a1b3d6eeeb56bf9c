"""CelebAMask-HQ region metadata and label colorization: an own copy of
deepsee_tpu/regions.py (numpy only).

Mirrors the 19-region table (reference: util/util.py:358-378
`get_celebA_regions`), the "consistent region" pairing used by the multi-modal
inference mode (sr_model.py:134: left/right eyes, brows, ears, lips tied to
their partner region), and the generic label colormap (util/util.py:250-276).
"""

from __future__ import annotations

import numpy as np

REGION_NAMES = (
    "Background",     # 0
    "Skin",           # 1
    "Nose",           # 2
    "Eyeglass",       # 3
    "Left eye",       # 4
    "Right eye",      # 5
    "Left eyebrow",   # 6
    "Right eyebrow",  # 7
    "Left Ear",       # 8
    "Right Ear",      # 9
    "Mouth",          # 10
    "Upper Lip",      # 11
    "Lower Lip",      # 12
    "Hair",           # 13
    "Hat",            # 14
    "Earring",        # 15
    "Necklace",       # 16
    "Neck",           # 17
    "Cloth",          # 18
)

NUM_REGIONS = len(REGION_NAMES)  # 19

# Regions whose style should be kept equal to their partner (index+1) when
# randomly perturbing styles, so left/right eyes etc. stay symmetric
# (reference: sr_model.py:134,153 and :314-317).
CONSISTENT_REGIONS = (4, 6, 8, 11)


def region_index(name: str) -> int:
    return REGION_NAMES.index(name)


def label_colormap(n: int = NUM_REGIONS) -> np.ndarray:
    """Bit-interleaved label colormap, (n, 3) uint8.

    Same construction as the reference's `labelcolormap` (util/util.py:250-276,
    originally from pytorch-seg), with label 0 given the color of id 1 so the
    background is visible.
    """
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        idv = i + 1
        for j in range(7):
            r ^= ((idv >> 0) & 1) << (7 - j)
            g ^= ((idv >> 1) & 1) << (7 - j)
            b ^= ((idv >> 2) & 1) << (7 - j)
            idv >>= 3
        cmap[i] = (r, g, b)
    return cmap


def colorize_label(label: np.ndarray, n: int = NUM_REGIONS) -> np.ndarray:
    """Map an integer label map (H, W) to an RGB uint8 image (H, W, 3)."""
    cmap = label_colormap(n)
    label = np.asarray(label).astype(np.int32)
    label = np.clip(label, 0, n - 1)
    return cmap[label]
