"""Area-light and point-light tables, and light-point sampling.

The counterpart of ``light_transport_tpu.scene.lights``: the area table
holds the emitting triangles, areas and the pick CDF are computed on the
host in float64 and then cast, and each NEE shadow ray draws a fresh
area-uniform point.  The point-light table holds delta lights, which have
no geometry: the path tracer adds their direct term deterministically and
Whitted Phong-shades toward them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.scene.geometry import TriangleMesh
from light_transport_tpu_torch.scene.material import MaterialTable

LIGHT_FIELDS = ("v0", "e1", "e2", "normal", "area", "radiance", "cdf",
                "total_area", "mat_id")
POINT_LIGHT_FIELDS = ("position", "intensity", "ambient", "diffuse",
                      "specular")


@dataclasses.dataclass
class LightTable:
    """SoA table of emitting triangles (one row per light triangle)."""

    v0: torch.Tensor  # (L, 3)
    e1: torch.Tensor  # (L, 3)
    e2: torch.Tensor  # (L, 3)
    normal: torch.Tensor  # (L, 3)
    area: torch.Tensor  # (L,)
    radiance: torch.Tensor  # (L, 3) = emission * emission_color
    cdf: torch.Tensor  # (L,) area-weighted pick CDF (inclusive upper edges)
    total_area: torch.Tensor  # () scalar
    mat_id: torch.Tensor  # (L,) int32

    @staticmethod
    def build(mesh: TriangleMesh, materials: MaterialTable,
              dtype=np.float32) -> "LightTable":
        dev = mesh.device
        h_v0, h_e1, h_e2, _, h_normal, h_mat, is_light = mesh.host_arrays()

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a, dt), device=dev)

        idx = np.nonzero(is_light)[0]
        if idx.size == 0:
            # one zero-radiance row keeps the shapes static
            z3 = np.zeros((1, 3))
            return LightTable(v0=t(z3), e1=t(z3), e2=t(z3),
                              normal=t([[0.0, 0.0, 1.0]]), area=t([0.0]),
                              radiance=t(z3), cdf=t([1.0]),
                              total_area=t(0.0), mat_id=t([0], np.int32))
        e1 = h_e1.astype(np.float64)[idx]
        e2 = h_e2.astype(np.float64)[idx]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        mat = h_mat[idx]
        radiance = materials.emission_rgb.cpu().numpy().astype(
            np.float64)[mat]
        cdf = np.cumsum(area) / area.sum()
        return LightTable(v0=t(h_v0[idx]), e1=t(e1), e2=t(e2),
                          normal=t(h_normal[idx]), area=t(area),
                          radiance=t(radiance), cdf=t(cdf),
                          total_area=t(area.sum()), mat_id=t(mat, np.int32))

    @property
    def num(self) -> int:
        return self.area.shape[0]


@dataclasses.dataclass
class PointLightTable:
    """SoA table of point (delta) lights.

    The path tracer adds ``f(wi) * I * cos(theta) / r^2 * V`` per light to
    its direct term (no pdf and no MIS weight: BSDF sampling cannot hit a
    delta light); Whitted Phong-shades toward each position with the
    table's ambient, diffuse and specular light colors."""

    position: torch.Tensor  # (P, 3)
    intensity: torch.Tensor  # (P, 3) radiant intensity I [power/sr]
    ambient: torch.Tensor  # (P, 3) Whitted's light colors
    diffuse: torch.Tensor  # (P, 3)
    specular: torch.Tensor  # (P, 3)

    @staticmethod
    def build(positions, intensities, ambient=None, diffuse=None,
              specular=None, dtype=np.float32,
              device="cuda") -> "PointLightTable":
        """``positions`` and ``intensities`` (P, 3)-broadcastable; the
        light colors default to ones."""
        pos = np.atleast_2d(np.asarray(positions, dtype=dtype))

        def rows(x):
            if x is None:
                return np.ones_like(pos)
            return np.broadcast_to(
                np.atleast_2d(np.asarray(x, dtype=dtype)), pos.shape)

        return PointLightTable(*(
            torch.from_numpy(np.array(a, copy=True)).to(device)
            for a in (pos, rows(intensities), rows(ambient), rows(diffuse),
                      rows(specular))))

    @property
    def num(self) -> int:
        return self.position.shape[0]


def sample_light_points(lights: LightTable, u_pick, u0, u1):
    """Area-uniform points over the union of the light triangles.

    Returns ``(point, normal, radiance, pdf_area)``; the barycentric warp
    is the reference's sqrt warp."""
    li = torch.searchsorted(lights.cdf, u_pick.contiguous(), side="left")
    li = torch.clamp(li, 0, lights.num - 1)
    sa = torch.sqrt(u0)
    b1 = sa * (1.0 - u1)
    b2 = u1 * sa
    point = (lights.v0[li] + b1[..., None] * lights.e1[li]
             + b2[..., None] * lights.e2[li])
    pdf_area = 1.0 / torch.clamp(lights.total_area, min=1e-30)
    return (point, lights.normal[li], lights.radiance[li],
            pdf_area.expand(u_pick.shape))


def geometry_term(shade_point, shade_normal, light_point, light_normal):
    """``|cos(theta) cos(phi)| / r^2``, the unit shadow direction and the
    distance."""
    to_light = light_point - shade_point
    dist2 = torch.clamp(lm.dot(to_light, to_light), min=1e-20)
    dist = torch.sqrt(dist2)
    wi = to_light / dist[..., None]
    cos_theta = lm.dot(shade_normal, wi)
    cos_phi = lm.dot(light_normal, -wi)
    return torch.abs(cos_theta * cos_phi) / dist2, wi, dist
