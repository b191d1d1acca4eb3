"""Intersector dispatch.

The counterpart of ``light_transport_tpu.ops.dispatch``, with the JAX
package's triangle thresholds:

* meshes of 48 triangles or fewer go to the brute force of
  ``ops.intersect`` on either device;
* meshes up to ``MXU_MAX_TRIS`` triangles go to the cluster-culled
  intersector of ``ops.intersect_kernel`` (the CUDA kernels K3 and K4 for
  tensors on the card, their plain versions for CPU tensors), through
  coherence sorting;
* past ``MXU_MAX_TRIS`` every query of a scene with a BVH walks it through
  the treelet kernels of ``ops.treelet_kernel`` (K5 and K5r for tensors on
  the card, the plain roped walk of ``accel.bvh`` for CPU tensors).  With
  treelet tables (``Scene.with_treelet``), coherent camera rays
  (``coherent=True``) take one sorted K5 launch and all other rays the
  wavefront driver on K5r.  Without tables (``with_bvh(treelet=False)``,
  JAX's XLA-walk route) every query takes one K5 launch over the BVH's
  records, and coherent camera rays go to the cluster intersector, as in
  JAX.  A big mesh without a BVH goes to the brute force on the CPU and
  raises on the card.

The thresholds and the wavefront's schedule were tuned on a TPU and have
not been measured on the card.  Inactive lanes (``active``) get an empty
ray interval on every path but the brute force and report no hit.

Not ported yet (ROADMAP): the watertight test; ``scene_transmittance``
(transmittance shadows).
"""

from __future__ import annotations

from typing import Optional

import torch

from light_transport_tpu_torch.ops import intersect

# above this many triangles JAX walks the BVH (its MXU/BVH crossover)
MXU_MAX_TRIS = 1_048_576
# at or below this many triangles the plain brute force is cheapest
SMALL_MESH_TRIS = 48
# the treelet schedule of JAX's dispatch: wavefront for incoherent rays,
# one treelet per pass, 12 bounded passes before the unbounded one
TREELET_WAVEFRONT = True
WAVEFRONT_LOADS_PER_PASS = 1
WAVEFRONT_MAX_PASSES = 12


def _use_cluster_intersector(scene, coherent: bool = False) -> bool:
    t = scene.mesh.num_triangles
    if t > MXU_MAX_TRIS:
        return coherent and scene.treelet is None
    return t > SMALL_MESH_TRIS


def _tables(scene):
    """The mesh's packed weights and cluster bounds, built once."""
    from light_transport_tpu_torch.ops import intersect_kernel as ik

    mesh = scene.mesh
    if "cluster" not in mesh.derived:
        mesh.derived["cluster"] = (ik.pack_tri_weights(mesh),
                                   ik.cluster_bounds(mesh))
    return mesh.derived["cluster"]


def _t_max(origins, active, bound=float("inf")):
    """Per-ray upper bound: ``bound`` where active, -inf (dead) elsewhere."""
    n = origins.shape[0]
    t = torch.as_tensor(bound, dtype=origins.dtype,
                        device=origins.device).expand(n)
    return t if active is None else torch.where(active, t, float("-inf"))


def _bvh_query(scene, origins, directions, t_max, active, any_hit,
               coherent):
    """The BVH branch, through the treelet kernels."""
    from light_transport_tpu_torch.ops import treelet_kernel as tk
    from light_transport_tpu_torch.ops.raysort import sorted_apply

    if scene.treelet is None:
        return tk.intersect_bvh_treelet(origins, directions,
                                        tk.TreeletTables.of(scene.bvh),
                                        t_max=t_max, any_hit=any_hit)
    if TREELET_WAVEFRONT and not coherent:
        # self-sorting: the per-pass cursor sort replaces the coherence sort
        return tk.intersect_bvh_treelet_wavefront(
            origins, directions, scene.treelet, t_max=t_max, any_hit=any_hit,
            loads_per_pass=WAVEFRONT_LOADS_PER_PASS,
            max_passes=WAVEFRONT_MAX_PASSES)
    return sorted_apply(
        lambda o, d, t: (
            tk.occluded_bvh_treelet(o, d, scene.treelet, t) if any_hit
            else tk.intersect_bvh_treelet(o, d, scene.treelet, t_max=t)),
        scene.mesh, origins, directions, t_max,
        inactive=None if active is None else ~active)


def _big_mesh(scene, origins) -> bool:
    """Past ``MXU_MAX_TRIS``: True when the BVH answers; raises on the card
    without one (the brute force there would be plain PyTorch)."""
    if scene.mesh.num_triangles <= MXU_MAX_TRIS:
        return False
    if scene.bvh is None and origins.device.type == "cuda":
        raise ValueError(
            f"a mesh of {scene.mesh.num_triangles:,} triangles on the card "
            "needs a BVH: call Scene.with_bvh() first")
    return scene.bvh is not None


def scene_intersect(scene, origins, directions,
                    ray_chunk: Optional[int] = None, active=None,
                    coherent: bool = False):
    """Nearest hit against the scene.  ``active``: optional (N,) bool;
    inactive lanes get an empty interval (t_max = -inf), so the cluster
    cull and the BVH walks drop them, and report no hit.  ``coherent``:
    the batch is a coherent camera grid (bounce 0), which past
    ``MXU_MAX_TRIS`` takes the single-launch treelet kernel."""
    if _use_cluster_intersector(scene, coherent):
        from light_transport_tpu_torch.ops.intersect_kernel import (
            intersect_rays_pallas,
        )
        from light_transport_tpu_torch.ops.raysort import sorted_apply

        weights, clusters = _tables(scene)
        return sorted_apply(
            lambda o, d, tm: intersect_rays_pallas(
                o, d, scene.mesh, tri_weights=weights, t_max=tm,
                clusters=clusters),
            scene.mesh, origins, directions, _t_max(origins, active),
            inactive=None if active is None else ~active)
    if _big_mesh(scene, origins):
        return _bvh_query(scene, origins, directions,
                          _t_max(origins, active), active, False, coherent)
    return intersect.intersect_rays(origins, directions, scene.mesh,
                                    ray_chunk=ray_chunk)


def scene_occluded(scene, origins, directions, max_dist,
                   ray_chunk: Optional[int] = None, active=None):
    """Any-hit visibility against the scene; inactive lanes are skipped and
    report unoccluded."""
    if _use_cluster_intersector(scene):
        from light_transport_tpu_torch.ops.intersect_kernel import (
            intersect_rays_pallas,
        )
        from light_transport_tpu_torch.ops.raysort import sorted_apply

        weights, clusters = _tables(scene)
        return sorted_apply(
            lambda o, d, m: intersect_rays_pallas(
                o, d, scene.mesh, tri_weights=weights, any_hit=True,
                max_dist=m, clusters=clusters),
            scene.mesh, origins, directions,
            _t_max(origins, active, max_dist),
            inactive=None if active is None else ~active)
    if _big_mesh(scene, origins):
        return _bvh_query(scene, origins, directions,
                          _t_max(origins, active, max_dist), active, True,
                          False)
    return intersect.occluded(origins, directions, scene.mesh, max_dist,
                              ray_chunk=ray_chunk)
