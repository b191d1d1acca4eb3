"""Materials as an SoA table with integer BSDF codes.

The counterpart of ``light_transport_tpu.scene.material``: the same host
``Material`` description and defaults, the same preset palette, and the
same table rows.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# BSDF codes, in the reference's if/elif order: diffuse, mirror,
# transmissive, none; glossy (modified Phong) is checked first
BSDF_DIFFUSE = 0
BSDF_MIRROR = 1
BSDF_TRANSMISSIVE = 2
BSDF_NONE = 3
BSDF_GLOSSY = 4

MATERIAL_FIELDS = ("ambient", "diffuse", "specular", "shininess",
                   "reflection", "ior", "emission", "emission_rgb",
                   "transmission", "bsdf", "sigma_a", "sigma_s", "medium_g")


@dataclasses.dataclass(frozen=True)
class Color:
    """Host-side color triple (ambient, diffuse, specular)."""

    ambient: tuple
    diffuse: tuple
    specular: tuple

    @staticmethod
    def of(ambient, diffuse, specular) -> "Color":
        return Color(tuple(ambient), tuple(diffuse), tuple(specular))


@dataclasses.dataclass(frozen=True)
class Material:
    """Host-side material description."""

    color: Color
    shininess: float = 1.0
    reflection: float = 0.0
    ior: float = 1.0
    emission: float = 0.0
    # emitted radiance is emission * emission_color, for hits and NEE alike
    emission_color: tuple = (1.0, 1.0, 1.0)
    transmission: float = 0.0
    is_diffuse: bool = True
    is_mirror: bool = False
    # interior medium of a closed transmissive object: RGB absorption,
    # scattering coefficient and HG anisotropy
    sigma_a: tuple = (0.0, 0.0, 0.0)
    sigma_s: float = 0.0
    medium_g: float = 0.0
    is_glossy: bool = False

    @property
    def bsdf(self) -> int:
        if self.is_glossy:
            return BSDF_GLOSSY
        if self.is_diffuse:
            return BSDF_DIFFUSE
        if self.is_mirror:
            return BSDF_MIRROR
        if self.transmission > 0.0:
            return BSDF_TRANSMISSIVE
        return BSDF_NONE


@dataclasses.dataclass
class MaterialTable:
    """SoA material table; one row per distinct material."""

    ambient: torch.Tensor  # (M, 3)
    diffuse: torch.Tensor  # (M, 3)
    specular: torch.Tensor  # (M, 3)
    shininess: torch.Tensor  # (M,)
    reflection: torch.Tensor  # (M,)
    ior: torch.Tensor  # (M,)
    emission: torch.Tensor  # (M,)
    emission_rgb: torch.Tensor  # (M, 3) emitted radiance = emission * tint
    transmission: torch.Tensor  # (M,)
    bsdf: torch.Tensor  # (M,) int32 BSDF code
    sigma_a: torch.Tensor  # (M, 3)
    sigma_s: torch.Tensor  # (M,)
    medium_g: torch.Tensor  # (M,)

    @staticmethod
    def build(materials: Sequence[Material], dtype=np.float32,
              device="cuda") -> "MaterialTable":
        def arr(f, dt=dtype):
            return torch.as_tensor(np.asarray([f(m) for m in materials], dt),
                                   device=device)

        return MaterialTable(
            ambient=arr(lambda m: m.color.ambient),
            diffuse=arr(lambda m: m.color.diffuse),
            specular=arr(lambda m: m.color.specular),
            shininess=arr(lambda m: m.shininess),
            reflection=arr(lambda m: m.reflection),
            ior=arr(lambda m: m.ior),
            emission=arr(lambda m: m.emission),
            emission_rgb=arr(
                lambda m: tuple(m.emission * c for c in m.emission_color)),
            transmission=arr(lambda m: m.transmission),
            bsdf=arr(lambda m: m.bsdf, np.int32),
            sigma_a=arr(lambda m: m.sigma_a),
            sigma_s=arr(lambda m: m.sigma_s),
            medium_g=arr(lambda m: m.medium_g),
        )

    @property
    def num(self) -> int:
        return self.bsdf.shape[0]


class _Presets:
    """Named colors and materials of the reference palette."""

    WHITE = Color.of((1, 1, 1), (1, 1, 1), (1, 1, 1))
    WHITE_2 = Color.of((0, 0, 0), (0.55, 0.55, 0.55), (0.7, 0.7, 0.7))
    RED = Color.of((0.1, 0, 0), (0.7, 0, 0), (1, 1, 1))
    PURPLE = Color.of((0.1, 0, 0.1), (0.7, 0, 0.7), (1, 1, 1))
    YELLOW = Color.of((0.05, 0.05, 0.0), (0.5, 0.5, 0.4), (0.7, 0.7, 0.04))
    SILVER = Color.of((0.23125,) * 3, (0.2775,) * 3, (0.773911,) * 3)
    GREEN = Color.of((0, 0.1, 0), (0, 0.6, 0), (1, 1, 1))
    GREY = Color.of((0.1, 0.1, 0.1), (0.6, 0.6, 0.6), (1, 1, 1))
    TURQUOISE = Color.of((0.1, 0.18725, 0.1745),
                         (0.396, 0.74151, 0.69102),
                         (0.297254, 0.30829, 0.306678))
    BRONZE = Color.of((0.2125, 0.1275, 0.054),
                      (0.714, 0.4284, 0.18144),
                      (0.393548, 0.271906, 0.166721))
    GLASS = Color.of((0.0, 0.0, 0.0), (0.588235, 0.670588, 0.729412),
                     (0.9, 0.9, 0.9))

    TURQUOISE_MAT = Material(color=TURQUOISE, shininess=0.1, reflection=2,
                             ior=1.65)
    BRONZE_MAT = Material(color=PURPLE, shininess=10, reflection=0.75,
                          ior=1.180, transmission=1.0, is_diffuse=False,
                          is_mirror=True)
    GLASS_MAT = Material(color=GLASS, shininess=96, reflection=0.2, ior=1.5,
                         transmission=1.0, is_diffuse=False, is_mirror=False)
    GLOSSY_MAT = Material(
        color=Color.of((0.0, 0.0, 0.0), (0.25, 0.25, 0.30),
                       (0.65, 0.65, 0.60)),
        shininess=40.0, is_diffuse=False, is_glossy=True)


presets = _Presets()
