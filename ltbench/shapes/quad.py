"""A quad (a, b, c, d) as the two triangles (a, b, c) and (a, c, d),
``(2, 3, 3)`` float64.

spec: ``corners`` (4, 3)."""

from __future__ import annotations

import numpy as np


def triangles(spec: dict) -> np.ndarray:
    a, b, c, d = np.asarray(spec["corners"], np.float64)
    return np.stack([np.stack([a, b, c]), np.stack([a, c, d])])
