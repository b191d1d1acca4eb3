"""Scene container: mesh, material table, light table, camera and BVH.

The counterpart of ``light_transport_tpu.scene.scene``.  Treelet slabs,
point lights, analytic primitives and the watertight mode belong to later
slices (ROADMAP); the port's Scene has none of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from light_transport_tpu_torch.accel.bvh import BVH
from light_transport_tpu_torch.scene.geometry import TriangleMesh
from light_transport_tpu_torch.scene.lights import LightTable
from light_transport_tpu_torch.scene.material import MaterialTable


@dataclasses.dataclass
class Scene:
    mesh: TriangleMesh
    materials: MaterialTable
    lights: LightTable
    camera: torch.Tensor  # (3,) pinhole position
    bvh: Optional[BVH] = None  # set by with_bvh(); None = mesh in build order

    @staticmethod
    def build(mesh: TriangleMesh, materials: MaterialTable, camera,
              dtype=np.float32) -> "Scene":
        return Scene(mesh=mesh, materials=materials,
                     lights=LightTable.build(mesh, materials, dtype=dtype),
                     camera=torch.as_tensor(np.asarray(camera, dtype),
                                            device=mesh.device))

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def with_bvh(self, max_leaf: int = 4) -> "Scene":
        """Attach a BVH: reorders the mesh (so consecutive 512-triangle
        clusters are spatially compact) and rebuilds the light table over
        the reordered triangle indices."""
        from light_transport_tpu_torch.accel import bvh as bvh_mod

        bvh, ordered = bvh_mod.build(self.mesh, max_leaf=max_leaf)
        dtype = self.camera.cpu().numpy().dtype
        return Scene(mesh=ordered, materials=self.materials,
                     lights=LightTable.build(ordered, self.materials,
                                             dtype=dtype),
                     camera=self.camera, bvh=bvh)
