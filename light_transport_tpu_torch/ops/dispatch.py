"""Intersector dispatch.

The counterpart of ``light_transport_tpu.ops.dispatch``, with the JAX
package's triangle thresholds:

* a watertight scene (``Scene.with_watertight()``) sends every triangle
  query to the watertight brute force of ``ops.intersect``, before any
  other route and on either device: a robustness mode that reaches no
  kernel, as in JAX;
* meshes of 48 triangles or fewer go to the brute force of
  ``ops.intersect`` on either device;
* meshes up to ``MXU_MAX_TRIS`` triangles go to the cluster-culled
  intersector of ``ops.intersect_kernel`` (the CUDA kernels K3, or the
  cull kernel and K4, for tensors on the card, their plain versions for
  CPU tensors), through coherence sorting;
* past ``MXU_MAX_TRIS`` every query of a scene with a BVH walks it through
  the treelet kernels of ``ops.treelet_kernel`` (K5 and K5r for tensors on
  the card, the plain roped walk of ``accel.bvh`` for CPU tensors).  With
  treelet tables (``Scene.with_treelet``) every query, the camera grid and
  the bounce and shadow rays alike, takes one K5 launch behind the
  coherence sort (``ops.raysort.sorted_apply``).  ``TREELET_WAVEFRONT =
  True`` restores JAX's route, which sends all but the camera rays through
  the wavefront driver on K5r.  On an NVIDIA H100 80GB HBM3 (700 W power
  limit) the single launch won: the 4.2M-triangle render of
  ``chip_smoke.py`` phase 12 (256x256x2, depth 3), routes in turns, was
  busy 7.74-7.77 ms on the device against 13.90-13.91 ms, with 2,764
  launches against 3,335 and the same 27 host syncs, and bitwise the same
  image (PERF.md, section 6).  Without tables
  (``with_bvh(treelet=False)``, JAX's XLA-walk route) every query takes
  one K5 launch over the BVH's records, and coherent camera rays go to
  the cluster intersector, as in JAX.  A big mesh without a BVH goes to
  the brute force on the CPU and raises on the card.

The other thresholds and the wavefront's schedule were tuned on a TPU and
have not been measured on the card.  Inactive lanes (``active``) get an
empty ray interval on every path but the brute force and report no hit.

As in JAX, intersection is not differentiated: every query takes its
rays ``detach()``ed and returns a hit (an occlusion mask, a
transmittance) with no graph, so a caller's gradient (the control
variates' score) stops at the intersector on either device.

A scene's analytic spheres and planes (``scene.analytic``) are tested in
plain PyTorch after the triangle query, on every route: the nearer hit
wins (``Hit.kind`` and ``Hit.prim`` say which primitive; as in JAX,
inactive lanes are tested too, and callers mask them), and an analytic
hit before ``max_dist`` occludes an active lane.

:func:`scene_transmittance` (``RenderConfig(shadow_mode="transmittance")``)
marches a shadow segment through up to three nearest-hit queries and one
any-hit query, on whichever route the scene takes.
"""

from __future__ import annotations

from typing import Optional

import torch

from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.ops import intersect
from light_transport_tpu_torch.utils import profiling

# above this many triangles JAX walks the BVH (its MXU/BVH crossover)
MXU_MAX_TRIS = 1_048_576
# at or below this many triangles the plain brute force is cheapest
SMALL_MESH_TRIS = 48
# the route of big-mesh bounce and shadow rays: one sorted K5 launch
# (False, measured faster on the card) or JAX's wavefront on K5r (True),
# whose schedule is one treelet per pass, 12 bounded passes before the
# unbounded one
TREELET_WAVEFRONT = False
WAVEFRONT_LOADS_PER_PASS = 1
WAVEFRONT_MAX_PASSES = 12


def _isect(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, an intersector call, in the ``lt.isect``
    span."""
    with profiling.span("lt.isect"):
        return fn(*args, **kwargs)


def _use_cluster_intersector(scene, coherent: bool = False) -> bool:
    t = scene.mesh.num_triangles
    if t > MXU_MAX_TRIS:
        return coherent and scene.treelet is None
    return t > SMALL_MESH_TRIS


def _tables(scene):
    """The mesh's packed weights, cluster bounds, triangle-major cluster
    records (which K3 and K4 read) and 32-triangle group boxes (which K4
    reads), built once per scene."""
    from light_transport_tpu_torch.ops import intersect_kernel as ik

    mesh = scene.mesh
    if "cluster" not in mesh.derived:
        w = ik.pack_tri_weights(mesh)
        mesh.derived["cluster"] = (w, ik.cluster_bounds(mesh),
                                   ik.cluster_records(w),
                                   ik.cluster_group_bounds(mesh))
    return mesh.derived["cluster"]


def _t_max(origins, active, bound=float("inf")):
    """Per-ray upper bound: ``bound`` where active, -inf (dead) elsewhere."""
    n = origins.shape[0]
    t = lm.device_const(bound, origins.dtype, origins.device).expand(n)
    return t if active is None else torch.where(active, t, float("-inf"))


def _bvh_query(scene, origins, directions, t_max, active, any_hit,
               coherent):
    """The BVH branch, through the treelet kernels."""
    from light_transport_tpu_torch.ops import treelet_kernel as tk
    from light_transport_tpu_torch.ops.raysort import sorted_apply

    if scene.treelet is None:
        return _isect(tk.intersect_bvh_treelet, origins, directions,
                      tk.TreeletTables.of(scene.bvh), t_max=t_max,
                      any_hit=any_hit)
    if TREELET_WAVEFRONT and not coherent:
        # self-sorting: the per-pass cursor sort replaces the coherence sort
        return _isect(
            tk.intersect_bvh_treelet_wavefront,
            origins, directions, scene.treelet, t_max=t_max, any_hit=any_hit,
            loads_per_pass=WAVEFRONT_LOADS_PER_PASS,
            max_passes=WAVEFRONT_MAX_PASSES)
    return sorted_apply(
        lambda o, d, t: (
            _isect(tk.occluded_bvh_treelet, o, d, scene.treelet, t)
            if any_hit else _isect(tk.intersect_bvh_treelet, o, d,
                                   scene.treelet, t_max=t)),
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


@profiling.spanned("lt.query.nearest")
def scene_intersect(scene, origins, directions,
                    ray_chunk: Optional[int] = None, active=None,
                    coherent: bool = False):
    """Nearest hit against the scene.  ``active``: optional (N,) bool;
    inactive lanes get an empty interval (t_max = -inf), so the cluster
    cull and the BVH walks drop them, and report no hit.  ``coherent``:
    the batch is a coherent camera grid (bounce 0), which past
    ``MXU_MAX_TRIS`` takes the single-launch treelet kernel.  A watertight
    scene tests every lane, as JAX's does; callers mask the inactive."""
    origins, directions = origins.detach(), directions.detach()
    if scene.watertight:
        hit = _isect(intersect.intersect_rays_watertight, origins,
                     directions, scene.mesh, ray_chunk=ray_chunk)
    elif _use_cluster_intersector(scene, coherent):
        from light_transport_tpu_torch.ops.intersect_kernel import (
            intersect_rays_pallas,
        )
        from light_transport_tpu_torch.ops.raysort import sorted_apply

        weights, clusters, records, groups = _tables(scene)
        hit = sorted_apply(
            lambda o, d, tm: _isect(
                intersect_rays_pallas, o, d, scene.mesh, tri_weights=weights,
                t_max=tm, clusters=clusters, records=records, groups=groups),
            scene.mesh, origins, directions, _t_max(origins, active),
            inactive=None if active is None else ~active)
    elif _big_mesh(scene, origins):
        hit = _bvh_query(scene, origins, directions,
                         _t_max(origins, active), active, False, coherent)
    else:
        hit = _isect(intersect.intersect_rays, origins, directions,
                     scene.mesh, ray_chunk=ray_chunk)
    hit = _merge_analytic(scene, hit, origins, directions)
    return hit._replace(t=hit.t.detach())


def _merge_analytic(scene, hit, origins, directions):
    """Fold the nearest analytic sphere or plane hit into the triangle
    hit record (a scene without analytic primitives keeps its record)."""
    prims = scene.analytic
    if prims is None or prims.num == 0:
        return hit
    from light_transport_tpu_torch.scene.analytic import (
        KIND_TRI,
        intersect_analytic,
    )

    t_a, kind_a, idx_a = intersect_analytic(prims, origins.detach(),
                                            directions.detach())
    a_wins = t_a < torch.where(hit.valid, hit.t, float("inf"))
    return intersect.Hit(
        t=torch.where(a_wins, t_a, hit.t),
        tri=torch.where(a_wins, -1, hit.tri),
        valid=hit.valid | a_wins,
        kind=torch.where(a_wins, kind_a, KIND_TRI),
        prim=torch.where(a_wins, idx_a, 0))


@profiling.spanned("lt.query.any")
def scene_occluded(scene, origins, directions, max_dist,
                   ray_chunk: Optional[int] = None, active=None):
    """Any-hit visibility against the scene; inactive lanes are skipped and
    report unoccluded."""
    origins, directions = origins.detach(), directions.detach()
    if scene.watertight:
        md = _t_max(origins, None, max_dist)
        if active is not None:
            md = torch.where(active, md, 0.0)  # an empty interval
        occ = _isect(intersect.occluded_watertight, origins, directions,
                     scene.mesh, md, ray_chunk=ray_chunk)
    elif _use_cluster_intersector(scene):
        from light_transport_tpu_torch.ops.intersect_kernel import (
            intersect_rays_pallas,
        )
        from light_transport_tpu_torch.ops.raysort import sorted_apply

        weights, clusters, records, groups = _tables(scene)
        occ = sorted_apply(
            lambda o, d, m: _isect(
                intersect_rays_pallas, o, d, scene.mesh, tri_weights=weights,
                any_hit=True, max_dist=m, clusters=clusters,
                records=records, groups=groups),
            scene.mesh, origins, directions,
            _t_max(origins, active, max_dist),
            inactive=None if active is None else ~active)
    elif _big_mesh(scene, origins):
        occ = _bvh_query(scene, origins, directions,
                         _t_max(origins, active, max_dist), active, True,
                         False)
    else:
        occ = _isect(intersect.occluded, origins, directions, scene.mesh,
                     max_dist, ray_chunk=ray_chunk)
    prims = scene.analytic
    if prims is not None and prims.num > 0:
        from light_transport_tpu_torch.scene.analytic import (
            intersect_analytic,
        )

        t_a = intersect_analytic(prims, origins, directions)[0]
        a_occ = t_a < max_dist
        if active is not None:
            # inactive lanes report unoccluded, as the triangle routes do
            a_occ = a_occ & active
        occ = occ | a_occ
    return occ


def scene_transmittance(scene, origins, directions, max_dist,
                        ray_chunk: Optional[int] = None, active=None,
                        max_hits: int = 3):
    """Straight-line transmittance ``(N, 3)`` in [0, 1] along shadow
    segments, as JAX's ``scene_transmittance``.

    Up to ``max_hits`` nearest-hit queries march each segment: a surface
    that is not transmissive blocks (0); a backface crossing of a
    transmissive surface exits its object, and the span just marched
    attenuates by Beer–Lambert ``exp(-(sigma_a + sigma_s) * t)`` of its
    material; a segment that ends inside an entered object attenuates by
    the pending extinction over its last span.  Lanes still marching
    after ``max_hits`` crossings are closed out by one any-hit query:
    anything ahead blocks.  The segment is not refracted and interface
    Fresnel loss is ignored (JAX's approximations)."""
    from light_transport_tpu_torch.scene.analytic import surface_attrs
    from light_transport_tpu_torch.scene.material import BSDF_TRANSMISSIVE

    eps = 1e-4
    mats = scene.materials
    n = origins.shape[0]
    kw = dict(dtype=origins.dtype, device=origins.device)
    remaining = _t_max(origins, None, max_dist)
    marching = (torch.ones((n,), dtype=torch.bool, device=origins.device)
                if active is None else active)
    cur_o = origins
    trans = torch.ones((n, 3), **kw)
    pend_sig = torch.zeros((n, 3), **kw)
    for _ in range(max_hits):
        hit = scene_intersect(scene, cur_o, directions, ray_chunk=ray_chunk,
                              active=marching)
        hit_in = hit.valid & (hit.t < remaining) & marching
        # no surface left in range: a lane inside an entered object ends
        # there, and its last span is interior
        end_now = marching & ~hit_in
        trans = torch.where(end_now[:, None],
                            trans * torch.exp(-pend_sig * remaining[:, None]),
                            trans)
        hit_p = cur_o + directions * hit.t[:, None]
        n_geo, mat_id, _ = surface_attrs(scene, hit, hit_p)
        is_trans = mats.bsdf[mat_id] == BSDF_TRANSMISSIVE
        blocked = hit_in & ~is_trans
        trans = torch.where(blocked[:, None], 0.0, trans)
        cos_d = (n_geo * directions).sum(dim=-1)
        exiting = hit_in & is_trans & (cos_d > 0.0)
        entering = hit_in & is_trans & (cos_d <= 0.0)
        sig_t = mats.sigma_a[mat_id] + mats.sigma_s[mat_id][:, None]
        att = torch.exp(-sig_t * hit.t[:, None])
        trans = torch.where(exiting[:, None], trans * att, trans)
        pend_sig = torch.where(
            hit_in[:, None], torch.where(entering[:, None], sig_t, 0.0),
            pend_sig)
        step = hit.t + eps
        cur_o = torch.where(hit_in[:, None], hit_p + eps * directions, cur_o)
        remaining = torch.where(hit_in, remaining - step, remaining)
        marching = hit_in & is_trans
    still = marching & (remaining > 0.0)
    occ_tail = scene_occluded(scene, cur_o, directions, remaining,
                              ray_chunk=ray_chunk, active=still)
    trans = torch.where((still & occ_tail)[:, None], 0.0, trans)
    return torch.where((still & ~occ_tail)[:, None],
                       trans * torch.exp(-pend_sig * remaining[:, None]),
                       trans).detach()
