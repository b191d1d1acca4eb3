"""Scene container: mesh, material table, light table, camera, BVH,
treelet tables, analytic primitives, point lights and the watertight flag.

The counterpart of ``light_transport_tpu.scene.scene``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from light_transport_tpu_torch.scene.geometry import TriangleMesh
from light_transport_tpu_torch.scene.analytic import AnalyticPrims
from light_transport_tpu_torch.scene.lights import (
    LightTable,
    PointLightTable,
)
from light_transport_tpu_torch.scene.material import MaterialTable

if TYPE_CHECKING:  # accel.bvh imports scene.geometry
    from light_transport_tpu_torch.accel.bvh import BVH

# with_bvh(treelet="auto") attaches treelet tables past this triangle
# count: the dispatch's crossover to the BVH (ops.dispatch.MXU_MAX_TRIS,
# kept literal here to avoid an import cycle; a test holds them equal)
TREELET_AUTO_MIN_TRIS = 1_048_576
# the table format's limit on leaf triangle indices
TREELET_MAX_TRIS = 1 << 24


def _auto_treelet(scene: "Scene") -> bool:
    """True when the dispatch would send this scene's queries through the
    treelet kernels: the scene lies on the card, is not watertight, and
    its mesh is past the crossover and within the table format."""
    n = scene.mesh.num_triangles
    return (not scene.watertight and scene.device.type == "cuda"
            and TREELET_AUTO_MIN_TRIS < n < TREELET_MAX_TRIS)


@dataclasses.dataclass
class Scene:
    mesh: TriangleMesh
    materials: MaterialTable
    lights: LightTable
    camera: torch.Tensor  # (3,) pinhole position
    bvh: Optional[BVH] = None  # set by with_bvh(); None = mesh in build order
    # treelet tables for the kernels K5/K5r (ops.treelet_kernel), set by
    # with_treelet(); the dispatch then sends every BVH query through them
    treelet: Optional["TreeletTables"] = None
    # analytic spheres and planes (scene.analytic), merged into every query
    analytic: Optional[AnalyticPrims] = None
    # point (delta) lights, set by with_point_lights()
    point_lights: Optional[PointLightTable] = None
    # set by with_watertight(): every triangle query takes the watertight
    # brute force (ops.intersect.intersect_rays_watertight), no kernel
    watertight: bool = False

    @staticmethod
    def build(mesh: TriangleMesh, materials: MaterialTable, camera,
              dtype=np.float32, analytic=None) -> "Scene":
        return Scene(mesh=mesh, materials=materials,
                     lights=LightTable.build(mesh, materials, dtype=dtype),
                     camera=torch.as_tensor(np.asarray(camera, dtype),
                                            device=mesh.device),
                     analytic=analytic)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def with_bvh(self, max_leaf: int = 4, treelet="auto",
                 timings: Optional[dict] = None) -> "Scene":
        """Attach a BVH: reorders the mesh (so consecutive 512-triangle
        clusters are spatially compact) and rebuilds the light table over
        the reordered triangle indices.

        ``treelet``: ``"auto"`` attaches treelet tables exactly when the
        dispatch would use them (the scene is on the card, with more than
        ``TREELET_AUTO_MIN_TRIS`` and fewer than 2^24 triangles); ``True``
        forces them on any device; ``False`` opts out, and the dispatch
        then answers each query with one walk of every ray (one K5 launch
        on the card).  ``timings``, if given, receives the build's steps
        in seconds (``accel.bvh.build``'s keys)."""
        from light_transport_tpu_torch.accel import bvh as bvh_mod

        bvh, ordered = bvh_mod.build(self.mesh, max_leaf=max_leaf,
                                     timings=timings)
        dtype = self.camera.cpu().numpy().dtype
        scene = Scene(mesh=ordered, materials=self.materials,
                      lights=LightTable.build(ordered, self.materials,
                                              dtype=dtype),
                      camera=self.camera, bvh=bvh, analytic=self.analytic,
                      point_lights=self.point_lights,
                      watertight=self.watertight)
        if treelet is True or (treelet == "auto" and _auto_treelet(scene)):
            scene = scene.with_treelet()
        return scene

    def with_treelet(self, T: int = 512) -> "Scene":
        """Attach treelet tables of ``T`` nodes (requires a BVH): the BVH's
        own records, checked against the table format's limits."""
        from light_transport_tpu_torch.ops.treelet_kernel import (
            build_treelet_tables,
        )

        if self.bvh is None:
            raise ValueError("with_treelet() requires with_bvh() first")
        if self.mesh.num_triangles > TREELET_MAX_TRIS:
            raise ValueError(
                f"treelet tables support up to 2^24 triangles, got "
                f"{self.mesh.num_triangles:,}")
        return dataclasses.replace(
            self, treelet=build_treelet_tables(self.bvh, T=T))

    def with_point_lights(self, positions, intensities, **phong) -> "Scene":
        """Attach point (delta) lights on the scene's device, in its dtype:
        ``positions`` and ``intensities`` (P, 3)-broadcastable; ``phong``
        passes Whitted's light colors (``ambient``, ``diffuse``,
        ``specular``) to :class:`PointLightTable`."""
        dtype = self.camera.cpu().numpy().dtype
        return dataclasses.replace(self, point_lights=PointLightTable.build(
            positions, intensities, dtype=dtype, device=self.device,
            **phong))

    def with_watertight(self, on: bool = True) -> "Scene":
        """Send every triangle query through the watertight test, the
        reference's robustness mode: a brute force over every triangle in
        plain PyTorch, on either device, which reaches no kernel."""
        return dataclasses.replace(self, watertight=on)
