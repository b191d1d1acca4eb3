"""Intersector dispatch.

The counterpart of ``light_transport_tpu.ops.dispatch``, with the JAX
package's triangle thresholds.  One router (:func:`_route`) names the
route of a triangle query, nearest or any hit, from what the dispatch can
observe: the scene's watertight flag, BVH and treelet tables, the mesh's
size, the rays' device and the ``coherent`` hint.  The routes:

* ``"watertight"``: a watertight scene (``Scene.with_watertight()``)
  sends every triangle query to the watertight brute force of
  ``ops.intersect``, before any other route and on either device: a
  robustness mode that reaches no kernel, as in JAX;
* ``"brute"``: meshes of 48 triangles or fewer go to the brute force of
  ``ops.intersect`` on either device, and so does a mesh past
  ``MXU_MAX_TRIS`` without a BVH on the CPU (on the card it raises);
* ``"cluster"``: meshes up to ``MXU_MAX_TRIS`` triangles go to the
  cluster-culled intersector of ``ops.intersect_kernel`` (the CUDA kernels
  K3, or the cull kernel and K4, for tensors on the card, their plain
  versions for CPU tensors), through coherence sorting; so do coherent
  camera rays past it when the scene has no treelet tables, as in JAX;
* ``"bvh"``: past ``MXU_MAX_TRIS``, a BVH without treelet tables
  (``with_bvh(treelet=False)``, JAX's XLA-walk route) answers every other
  query by one K5 launch over the BVH's records (``ops.treelet_kernel``;
  the plain roped walk of ``accel.bvh`` for CPU tensors);
* ``"treelet"``: with treelet tables (``Scene.with_treelet``) every query,
  the camera grid and the bounce and shadow rays alike, takes one K5
  launch behind the coherence sort (``ops.raysort.sorted_apply``).

The single sorted launch is the treelet route because it beat JAX's
route, which sends all but the camera rays through the wavefront driver
on K5r: on an NVIDIA H100 80GB HBM3 (700 W power limit) the 4.2M-triangle
render of ``chip_smoke.py`` phase 12 (256x256x2, depth 3), the two routes
in turns, was busy 7.74-7.77 ms on the device against the wavefront's
13.90-13.91 ms, with 2,764 launches against 3,335 and the same 27 host
syncs, and bitwise the same image (PERF.md, section 6).  The wavefront
and queued drivers stay in ``ops.treelet_kernel``, held bitwise against
K5.

The other thresholds were tuned on a TPU and have not been measured on
the card.  Inactive lanes (``active``) get an empty ray interval on the
cluster and BVH routes (``t_max = -inf``) and on the watertight any-hit
route (``max_dist = 0``), and report no hit there; the brute forces test
them, as JAX's do, and callers mask them.

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


def _isect(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, an intersector call, in the ``lt.isect``
    span."""
    with profiling.span("lt.isect"):
        return fn(*args, **kwargs)


def _route(scene, device: torch.device, coherent: bool = False) -> str:
    """The route of a triangle query of rays on ``device``: one of
    ``"watertight"``, ``"brute"``, ``"cluster"``, ``"bvh"`` and
    ``"treelet"`` (see the module's docstring).  ``coherent`` counts only
    past ``MXU_MAX_TRIS``.  Raises there for a mesh without a BVH on the
    card, where the brute force would be plain PyTorch."""
    if scene.watertight:
        return "watertight"
    n = scene.mesh.num_triangles
    if n <= SMALL_MESH_TRIS:
        return "brute"
    if n <= MXU_MAX_TRIS or (coherent and scene.treelet is None):
        return "cluster"
    if scene.bvh is not None:
        return "bvh" if scene.treelet is None else "treelet"
    if device.type == "cuda":
        raise ValueError(
            f"a mesh of {n:,} triangles on the card "
            "needs a BVH: call Scene.with_bvh() first")
    return "brute"


def _t_max(origins, active, bound=float("inf")):
    """Per-ray upper bound: ``bound`` where active, -inf (dead) elsewhere."""
    n = origins.shape[0]
    t = lm.device_const(bound, origins.dtype, origins.device).expand(n)
    return t if active is None else torch.where(active, t, float("-inf"))


def _query(scene, origins, directions, active, any_hit: bool,
           max_dist=float("inf"), ray_chunk: Optional[int] = None,
           coherent: bool = False):
    """The triangle query on the scene's route: a :class:`Hit`, or with
    ``any_hit`` an occlusion mask against ``max_dist``."""
    # imported at each query, so a caller may swap these modules
    from light_transport_tpu_torch.ops import intersect_kernel as ik
    from light_transport_tpu_torch.ops import treelet_kernel as tk
    from light_transport_tpu_torch.ops.raysort import sorted_apply

    mesh = scene.mesh
    route = _route(scene, origins.device, coherent)
    if route == "watertight":
        if not any_hit:
            return _isect(intersect.intersect_rays_watertight, origins,
                          directions, mesh, ray_chunk=ray_chunk)
        md = _t_max(origins, None, max_dist)
        if active is not None:
            md = torch.where(active, md, 0.0)  # an empty interval
        return _isect(intersect.occluded_watertight, origins, directions,
                      mesh, md, ray_chunk=ray_chunk)
    if route == "brute":
        if any_hit:
            return _isect(intersect.occluded, origins, directions, mesh,
                          max_dist, ray_chunk=ray_chunk)
        return _isect(intersect.intersect_rays, origins, directions, mesh,
                      ray_chunk=ray_chunk)
    t_max = _t_max(origins, active, max_dist)
    if route == "bvh":
        return _isect(tk.intersect_bvh_treelet, origins, directions,
                      tk.TreeletTables.of(scene.bvh), t_max=t_max,
                      any_hit=any_hit)
    if route == "cluster":
        tables = ik.cluster_tables(mesh)

        def walk(o, d, t):
            return _isect(ik.intersect_rays_pallas, o, d, mesh, t_max=t,
                          any_hit=any_hit, **tables._asdict())
    elif route == "treelet":
        def walk(o, d, t):
            return _isect(tk.intersect_bvh_treelet, o, d, scene.treelet,
                          t_max=t, any_hit=any_hit)
    else:
        raise ValueError(f"no triangle query on route {route!r}")
    return sorted_apply(walk, mesh, origins, directions, t_max,
                        inactive=None if active is None else ~active)


@profiling.spanned("lt.query.nearest")
def scene_intersect(scene, origins, directions,
                    ray_chunk: Optional[int] = None, active=None,
                    coherent: bool = False):
    """Nearest hit against the scene.  ``active``: optional (N,) bool;
    inactive lanes get an empty interval on the cluster and BVH routes
    and report no hit.  ``coherent``: the batch is a coherent camera grid
    (bounce 0), which counts only past ``MXU_MAX_TRIS``."""
    origins, directions = origins.detach(), directions.detach()
    hit = _query(scene, origins, directions, active, False,
                 ray_chunk=ray_chunk, coherent=coherent)
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
    occ = _query(scene, origins, directions, active, True, max_dist,
                 ray_chunk=ray_chunk)
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
