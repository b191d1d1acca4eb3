"""Intersector dispatch.

The counterpart of ``light_transport_tpu.ops.dispatch``, with the JAX
package's triangle thresholds: meshes of 48 triangles or fewer go to the
brute force of ``ops.intersect`` on either device; larger ones to the
cluster-culled intersector of ``ops.intersect_kernel`` (the CUDA kernels
K3 and K4 for tensors on the card, their plain versions for CPU tensors),
through coherence sorting.  The 48-triangle threshold was tuned on a TPU
and has not been measured on the card.

Not ported yet (ROADMAP): meshes past ``MXU_MAX_TRIS``, which JAX sends to
the BVH walk or the treelet kernel (the BVH slice); the watertight test;
``scene_transmittance`` (transmittance shadows).
"""

from __future__ import annotations

from typing import Optional

import torch

from light_transport_tpu_torch.ops import intersect

# above this many triangles JAX walks the BVH (its MXU/BVH crossover)
MXU_MAX_TRIS = 1_048_576
# at or below this many triangles the plain brute force is cheapest
SMALL_MESH_TRIS = 48


def _use_cluster_intersector(scene) -> bool:
    t = scene.mesh.num_triangles
    if t > MXU_MAX_TRIS:
        raise NotImplementedError(
            f"{t} triangles: meshes past {MXU_MAX_TRIS} need the BVH walk "
            "(ROADMAP, the BVH slice)")
    return t > SMALL_MESH_TRIS


def _tables(scene):
    """The mesh's packed weights and cluster bounds, built once."""
    from light_transport_tpu_torch.ops import intersect_kernel as ik

    mesh = scene.mesh
    if "cluster" not in mesh.derived:
        mesh.derived["cluster"] = (ik.pack_tri_weights(mesh),
                                   ik.cluster_bounds(mesh))
    return mesh.derived["cluster"]


def scene_intersect(scene, origins, directions,
                    ray_chunk: Optional[int] = None, active=None):
    """Nearest hit against the scene.  ``active``: optional (N,) bool;
    inactive lanes get an empty interval (t_max = -inf), so the cluster
    cull drops them, and report no hit."""
    if not _use_cluster_intersector(scene):
        return intersect.intersect_rays(origins, directions, scene.mesh,
                                        ray_chunk=ray_chunk)
    from light_transport_tpu_torch.ops.intersect_kernel import (
        intersect_rays_pallas,
    )
    from light_transport_tpu_torch.ops.raysort import sorted_apply

    weights, clusters = _tables(scene)
    n = origins.shape[0]
    tmax = (torch.full((n,), float("inf"), dtype=origins.dtype,
                       device=origins.device) if active is None
            else torch.where(active, float("inf"), float("-inf")).to(
                origins.dtype))
    return sorted_apply(
        lambda o, d, tm: intersect_rays_pallas(
            o, d, scene.mesh, tri_weights=weights, t_max=tm,
            clusters=clusters),
        scene.mesh, origins, directions, tmax,
        inactive=None if active is None else ~active)


def scene_occluded(scene, origins, directions, max_dist,
                   ray_chunk: Optional[int] = None, active=None):
    """Any-hit visibility against the scene; inactive lanes are skipped by
    the cull and report unoccluded."""
    if not _use_cluster_intersector(scene):
        return intersect.occluded(origins, directions, scene.mesh, max_dist,
                                  ray_chunk=ray_chunk)
    from light_transport_tpu_torch.ops.intersect_kernel import (
        intersect_rays_pallas,
    )
    from light_transport_tpu_torch.ops.raysort import sorted_apply

    weights, clusters = _tables(scene)
    n = origins.shape[0]
    md = torch.as_tensor(max_dist, dtype=origins.dtype,
                         device=origins.device).expand(n)
    if active is not None:
        md = torch.where(active, md, float("-inf"))
    return sorted_apply(
        lambda o, d, m: intersect_rays_pallas(
            o, d, scene.mesh, tri_weights=weights, any_hit=True, max_dist=m,
            clusters=clusters),
        scene.mesh, origins, directions, md,
        inactive=None if active is None else ~active)
