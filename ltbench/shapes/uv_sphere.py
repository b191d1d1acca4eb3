"""A UV sphere, ``(T, 3, 3)`` float64: ``n_theta`` bands of ``n_phi``
quads, two triangles a quad but one at each pole (the degenerate half is
left out).  The same triangles as the soft-shadow notebook's sphere, in
band-major order: ``upper`` triangles (a, b, c) of bands 1.., then
``lower`` triangles (a, c, d) of bands ..n_theta-2.

spec: ``center`` (3,), ``radius``, ``n_theta``, ``n_phi``."""

from __future__ import annotations

import numpy as np


def triangles(spec: dict) -> np.ndarray:
    n_theta, n_phi = int(spec["n_theta"]), int(spec["n_phi"])
    center = np.asarray(spec["center"], np.float64)
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    pts = np.stack(
        [np.sin(th)[:, None] * np.cos(ph)[None, :],
         np.cos(th)[:, None] * np.ones_like(ph)[None, :],
         np.sin(th)[:, None] * np.sin(ph)[None, :]], axis=-1)
    pts = center + float(spec["radius"]) * pts
    roll = np.roll(np.arange(n_phi), -1)
    a = pts[:-1, :]
    b = pts[:-1, roll]
    c = pts[1:, roll]
    d = pts[1:, :]
    upper = np.stack([a, b, c], axis=2)[1:].reshape(-1, 3, 3)
    lower = np.stack([a, c, d], axis=2)[:-1].reshape(-1, 3, 3)
    return np.concatenate([upper, lower])
