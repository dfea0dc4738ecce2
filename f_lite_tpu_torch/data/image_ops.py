"""Host normalize of the image input path (counterpart of the JAX
package's native `image_ops.cpp`: `normalize_u8_to_f32`,
`normalize_batch_u8_to_f32` and `denormalize_f32_to_u8`), in numpy.

uint8 -> float32 is `(float)u8 / 255.0f * 2.0f - 1.0f`: 256 values, so a
float32 lookup table computed with those float32 operations gives the
native route's bits exactly. The way back computes `(x * 0.5 + 0.5) * 255`
in float32, clamps to [0, 255] and rounds half to even.
"""

from __future__ import annotations

import numpy as np

_LUT = (np.arange(256, dtype=np.float32) / np.float32(255.0) * np.float32(2.0)
        - np.float32(1.0))


def normalize_u8(img: np.ndarray) -> np.ndarray:
    """uint8 (..., C) -> float32 in [-1, 1]."""
    return _LUT[np.asarray(img, np.uint8)]


def normalize_batch_u8(imgs: np.ndarray, flip: np.ndarray | None = None) -> np.ndarray:
    """uint8 (B, H, W, C) -> float32 in [-1, 1]; image i mirrored along W
    where `flip[i]` is nonzero."""
    imgs = np.asarray(imgs, np.uint8)
    if flip is not None:
        flip = np.asarray(flip).astype(bool)
        imgs = np.where(flip[:, None, None, None], imgs[:, :, ::-1], imgs)
    return _LUT[imgs]


def denormalize_to_u8(x: np.ndarray) -> np.ndarray:
    """float32 in [-1, 1] -> uint8 (the sampled images' way back)."""
    x = np.asarray(x, np.float32)
    v = (x * np.float32(0.5) + np.float32(0.5)) * np.float32(255.0)
    return np.rint(np.clip(v, np.float32(0.0), np.float32(255.0))).astype(np.uint8)
