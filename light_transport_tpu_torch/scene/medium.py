"""Layered participating-medium table (MCML-style).

A stack of horizontal slabs, each with absorption mu_a, scattering mu_s,
anisotropy g, refractive index n and thickness, bounded by ambient media
above and below.  z increases downward; photons launch at z = 0:

    z0=0 ── layer 0 ── z1 ── layer 1 ── ... ── zL (or infinity)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from light_transport_tpu_torch.core.config import MediumConfig


@dataclasses.dataclass
class LayeredMedium:
    mu_a: torch.Tensor  # (L,)
    mu_s: torch.Tensor  # (L,)
    mu_t: torch.Tensor  # (L,) = mu_a + mu_s
    g: torch.Tensor  # (L,)
    n: torch.Tensor  # (L,)
    z_top: torch.Tensor  # (L,) upper boundary depth of each layer
    z_bot: torch.Tensor  # (L,) lower boundary depth (inf for semi-infinite)
    n_above: torch.Tensor  # () ambient index above z=0
    n_below: torch.Tensor  # () ambient index below the last layer

    @staticmethod
    def build(layers: Sequence[MediumConfig], n_above: float = 1.0,
              n_below: float = 1.0, dtype=np.float32,
              device="cpu") -> "LayeredMedium":
        mu_a = np.asarray([l.mu_a for l in layers], dtype=dtype)
        mu_s = np.asarray([l.mu_s for l in layers], dtype=dtype)
        g = np.asarray([l.g for l in layers], dtype=dtype)
        n = np.asarray([l.n for l in layers], dtype=dtype)
        # boundaries: float64 cumsum, then cast
        thick = np.asarray([l.thickness for l in layers], dtype=np.float64)
        z = np.concatenate([[0.0], np.cumsum(thick)])

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

        return LayeredMedium(
            mu_a=t(mu_a), mu_s=t(mu_s), mu_t=t(mu_a + mu_s), g=t(g), n=t(n),
            z_top=t(z[:-1]), z_bot=t(z[1:]),
            n_above=t(n_above), n_below=t(n_below),
        )

    @property
    def num_layers(self) -> int:
        return self.mu_a.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mu_a.device

    def to(self, device) -> "LayeredMedium":
        return LayeredMedium(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})
