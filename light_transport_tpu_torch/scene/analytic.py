"""Surface attributes at a hit.

The triangle branch of ``light_transport_tpu.scene.analytic.surface_attrs``;
analytic spheres and planes belong to a later slice (ROADMAP), and the
port's Scene carries none.
"""

from __future__ import annotations

import torch


def surface_attrs(scene, hit, hit_p):
    """``(geometric normal, mat_id, is_light)`` of each hit triangle (row 0
    for misses, which callers mask).  ``hit_p`` is unused by triangles and
    kept for the JAX signature."""
    del hit_p
    tri = torch.clamp(hit.tri, min=0).long()
    mesh = scene.mesh
    return mesh.normal[tri], mesh.mat_id[tri].long(), mesh.is_light[tri]
