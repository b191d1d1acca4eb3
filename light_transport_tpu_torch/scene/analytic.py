"""Analytic spheres and planes, and the surface attributes at a hit.

The counterpart of ``light_transport_tpu.scene.analytic``: an SoA table of
spheres and planes on the Scene (``Scene.analytic``), whose nearest hit
``ops.dispatch`` folds into every triangle query, and ``surface_attrs``,
which resolves a hit on either kind to its normal and material.  Analytic
primitives are never lights (NEE samples the light triangles only) and
have no per-triangle detector rows; they carry materials and shade,
reflect and refract like any surface.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from light_transport_tpu_torch.core import math as lm

KIND_TRI = 0
KIND_SPHERE = 1
KIND_PLANE = 2

ANALYTIC_FIELDS = ("sph_center", "sph_radius", "sph_mat", "pl_point",
                   "pl_normal", "pl_mat")


@dataclasses.dataclass
class AnalyticPrims:
    """SoA tables of analytic primitives."""

    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_mat: torch.Tensor  # (S,) int32 material row
    pl_point: torch.Tensor  # (P, 3)
    pl_normal: torch.Tensor  # (P, 3) unit
    pl_mat: torch.Tensor  # (P,) int32

    @staticmethod
    def build(spheres: Sequence[Tuple] = (), planes: Sequence[Tuple] = (),
              dtype=np.float32, device="cuda") -> "AnalyticPrims":
        """``spheres``: (center, radius, mat_id) triples; ``planes``:
        (point, normal, mat_id) triples, the normals normalised here (in
        float32 when ``dtype`` is, as JAX does)."""
        sc = np.asarray([s[0] for s in spheres], dtype).reshape(-1, 3)
        sr = np.asarray([s[1] for s in spheres], dtype).reshape(-1)
        sm = np.asarray([s[2] for s in spheres], np.int32).reshape(-1)
        pp = np.asarray([p[0] for p in planes], dtype).reshape(-1, 3)
        pn = np.asarray([p[1] for p in planes], dtype).reshape(-1, 3)
        if len(planes):
            pn = pn / np.linalg.norm(pn, axis=-1, keepdims=True)
        pm = np.asarray([p[2] for p in planes], np.int32).reshape(-1)
        return AnalyticPrims(*(
            torch.from_numpy(np.array(a, copy=True)).to(device)
            for a in (sc, sr, sm, pp, pn, pm)))

    @property
    def num_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def num_planes(self) -> int:
        return self.pl_mat.shape[0]

    @property
    def num(self) -> int:
        return self.num_spheres + self.num_planes


def intersect_analytic(prims: AnalyticPrims, origins, directions):
    """Nearest analytic hit of each ray: ``(t, kind, idx)``, t = +inf and
    kind = KIND_TRI on a miss; the first primitive wins a tie in t,
    spheres before planes."""
    from light_transport_tpu_torch.ops.intersect import (
        plane_intersect,
        sphere_intersect,
    )

    n = origins.shape[0]
    dev = origins.device
    best_t = torch.full((n,), float("inf"), dtype=origins.dtype, device=dev)
    best_kind = torch.zeros((n,), dtype=torch.int32, device=dev)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=dev)

    def fold(t, kind, i):
        nonlocal best_t, best_kind, best_idx
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_kind = torch.where(closer, kind, best_kind)
        best_idx = torch.where(closer, i, best_idx)

    for i in range(prims.num_spheres):
        fold(sphere_intersect(origins, directions, prims.sph_center[i],
                              prims.sph_radius[i]), KIND_SPHERE, i)
    for i in range(prims.num_planes):
        fold(plane_intersect(origins, directions, prims.pl_point[i],
                             prims.pl_normal[i]), KIND_PLANE, i)
    return best_t, best_kind, best_idx


def surface_attrs(scene, hit, hit_p):
    """``(geometric normal, mat_id, is_light)`` at each hit, a triangle or
    an analytic primitive (row 0 of the mesh for misses, which callers
    mask).  ``hit_p``: the (N, 3) hit positions, which a sphere's normal
    needs."""
    tri = torch.clamp(hit.tri, min=0).long()
    mesh = scene.mesh
    normal, mat_id = mesh.normal[tri], mesh.mat_id[tri].long()
    is_light = mesh.is_light[tri]
    prims = getattr(scene, "analytic", None)
    kind = getattr(hit, "kind", None)
    if prims is None or kind is None or prims.num == 0:
        return normal, mat_id, is_light
    idx = torch.clamp(hit.prim, min=0).long()
    if prims.num_spheres:
        si = torch.clamp(idx, 0, prims.num_spheres - 1)
        is_s = kind == KIND_SPHERE
        normal = torch.where(is_s[:, None],
                             lm.normalize(hit_p - prims.sph_center[si]),
                             normal)
        mat_id = torch.where(is_s, prims.sph_mat[si].long(), mat_id)
    if prims.num_planes:
        pi = torch.clamp(idx, 0, prims.num_planes - 1)
        is_p = kind == KIND_PLANE
        normal = torch.where(is_p[:, None], prims.pl_normal[pi], normal)
        mat_id = torch.where(is_p, prims.pl_mat[pi].long(), mat_id)
    return normal, mat_id, is_light & (kind == KIND_TRI)
