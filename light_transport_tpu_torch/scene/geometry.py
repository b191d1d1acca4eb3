"""Triangle-soup scene geometry as SoA tensors.

The counterpart of ``light_transport_tpu.scene.geometry``: edges, unit
normals and centroids are computed on the host in float64 and cast, so
both packages hold the same float32 mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

MESH_FIELDS = ("v0", "e1", "e2", "normal", "centroid", "mat_id", "is_light")


@dataclasses.dataclass
class TriangleMesh:
    """SoA triangle soup; all tensors share leading dim T."""

    v0: torch.Tensor  # (T, 3) first vertex
    e1: torch.Tensor  # (T, 3) v1 - v0
    e2: torch.Tensor  # (T, 3) v2 - v0
    normal: torch.Tensor  # (T, 3) unit geometric normal
    centroid: torch.Tensor  # (T, 3)
    mat_id: torch.Tensor  # (T,) int32
    is_light: torch.Tensor  # (T,) bool
    # tables derived from the mesh (the intersector's packed weights and
    # cluster bounds), built once on first use
    derived: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @staticmethod
    def build(vertices: np.ndarray, mat_id: np.ndarray,
              is_light: Optional[np.ndarray] = None, dtype=np.float32,
              device="cuda") -> "TriangleMesh":
        """Build from a ``(T, 3, 3)`` vertex array (tri, corner, xyz)."""
        vertices = np.asarray(vertices, dtype=np.float64)
        if vertices.ndim != 3 or vertices.shape[1:] != (3, 3):
            raise ValueError(f"expected (T, 3, 3) vertices, got "
                             f"{vertices.shape}")
        t = vertices.shape[0]
        v0 = vertices[:, 0]
        e1 = vertices[:, 1] - v0
        e2 = vertices[:, 2] - v0
        n = np.cross(e1, e2)
        nlen = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(nlen, 1e-30)
        centroid = vertices.mean(axis=1)
        if is_light is None:
            is_light = np.zeros((t,), dtype=bool)
        host = (v0.astype(dtype), e1.astype(dtype), e2.astype(dtype),
                n.astype(dtype), centroid.astype(dtype),
                np.asarray(mat_id, np.int32), np.asarray(is_light, bool))
        # copies: a tensor never aliases the caller's arrays
        return TriangleMesh(*(torch.from_numpy(np.array(a, copy=True)).to(
            device) for a in host))

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def host_arrays(self):
        """Host numpy copies of (v0, e1, e2, centroid, normal, mat_id,
        is_light), in the JAX package's order."""
        return tuple(getattr(self, f).cpu().numpy()
                     for f in ("v0", "e1", "e2", "centroid", "normal",
                               "mat_id", "is_light"))

    def select(self, order) -> "TriangleMesh":
        """The mesh with its triangles in ``order``."""
        idx = torch.as_tensor(np.asarray(order), device=self.device)
        return TriangleMesh(*(getattr(self, f)[idx] for f in MESH_FIELDS))

    def translated(self, offset) -> "TriangleMesh":
        v0, e1, e2 = self.host_arrays()[:3]
        off = np.asarray(offset, v0.dtype)
        tris = np.stack([v0 + off, v0 + off + e1, v0 + off + e2], axis=1)
        return TriangleMesh.build(tris, self.mat_id.cpu().numpy(),
                                  self.is_light.cpu().numpy(),
                                  dtype=v0.dtype, device=self.device)

    def scaled(self, factor, origin=(0.0, 0.0, 0.0)) -> "TriangleMesh":
        v0, e1, e2 = self.host_arrays()[:3]
        f = np.broadcast_to(np.asarray(factor, v0.dtype), (3,))
        org = np.asarray(origin, v0.dtype)
        a = (v0 - org) * f + org
        tris = np.stack([a, a + e1 * f, a + e2 * f], axis=1)
        return TriangleMesh.build(tris, self.mat_id.cpu().numpy(),
                                  self.is_light.cpu().numpy(),
                                  dtype=v0.dtype, device=self.device)

    def vertices(self) -> np.ndarray:
        """The (T, 3, 3) float64 vertex array (host-side use)."""
        v0, e1, e2 = (a.astype(np.float64) for a in self.host_arrays()[:3])
        return np.stack([v0, v0 + e1, v0 + e2], axis=1)

    def area(self) -> np.ndarray:
        """Per-triangle area |e1 x e2| / 2, in float64 on host copies."""
        e1, e2 = (a.astype(np.float64) for a in self.host_arrays()[1:3])
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


def quad_triangles(a, b, c, d) -> np.ndarray:
    """Split quad (a,b,c,d) into triangles (a,b,c), (a,c,d)."""
    a, b, c, d = (np.asarray(p, dtype=np.float64) for p in (a, b, c, d))
    return np.stack([np.stack([a, b, c]), np.stack([a, c, d])])


def uv_sphere_triangles(center=(0.0, 0.0, 0.0), radius=1.0,
                        n_theta=16, n_phi=32) -> np.ndarray:
    """Vectorised UV-sphere triangulation, ``(T, 3, 3)`` float64: the band
    and quad layout of ``scene.cornell.sphere_triangles`` (pole quads keep
    only their non-degenerate half) built with numpy broadcasting, for the
    million-triangle tessellations where the per-quad loop takes minutes."""
    center = np.asarray(center, np.float64)
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    pts = np.stack(
        [np.sin(th)[:, None] * np.cos(ph)[None, :],
         np.cos(th)[:, None] * np.ones_like(ph)[None, :],
         np.sin(th)[:, None] * np.sin(ph)[None, :]], axis=-1)
    pts = center + radius * pts
    roll = np.roll(np.arange(n_phi), -1)
    a = pts[:-1, :]
    b = pts[:-1, roll]
    c = pts[1:, roll]
    d = pts[1:, :]
    upper = np.stack([a, b, c], axis=2)[1:].reshape(-1, 3, 3)
    lower = np.stack([a, c, d], axis=2)[:-1].reshape(-1, 3, 3)
    return np.concatenate([upper, lower])


def concat_meshes(meshes: Sequence[TriangleMesh]) -> TriangleMesh:
    return TriangleMesh(*(torch.cat([getattr(m, f) for m in meshes])
                          for f in MESH_FIELDS))
