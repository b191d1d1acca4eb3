"""Whitted-style ray tracer.

The counterpart of ``light_transport_tpu.integrators.whitted``: per hit,
Phong shading (ambient + diffuse + specular) toward every light row with a
shadow test, a Fresnel- or mirror-weighted reflection branch and a
refraction branch, and an optional hemisphere-sampled indirect diffuse
term.  Area lights are shaded at one fixed point per light triangle (its
centroid); point lights (``Scene.point_lights``) at their positions with
the table's light colors.  Analytic spheres and planes shade through
``scene.analytic.surface_attrs``.

Two tracers walk the reflect/refract tree:

* :func:`trace_whitted` unrolls it: every node is one full-width
  nearest-hit query plus one any-hit query per light row, with the
  children's lanes masked by ``active`` (2^(depth+1) - 1 nodes);
* :func:`trace_whitted_queue` follows the heavier branch of each lane and
  pushes the other onto a per-lane stack (``ops.lanestack``), dropping
  branches whose luminance weight is at or below ``weight_cutoff``
  (``WEIGHT_CUTOFF`` by default): one
  :func:`_queue_step` a superstep, with one host readback (are any lanes
  left?) each.

:func:`render_whitted` traces one ray a pixel through the pixel's corner
(no jitter): unrolled up to depth 4, the queue beyond.  The indirect term
draws its hemisphere uniforms from a ``torch.Generator`` seeded by
``core.rng.fold_seed`` (JAX draws them by ``jax.random.fold_in``); the
functions that draw (:func:`trace_whitted_queue`,
:func:`_indirect_diffuse`) take them pre-drawn instead through
``uniforms``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.ops import lanestack, sampling
from light_transport_tpu_torch.ops.dispatch import (
    scene_intersect,
    scene_occluded,
)
from light_transport_tpu_torch.scene.analytic import surface_attrs
from light_transport_tpu_torch.scene.material import BSDF_MIRROR

# the queue's default cutoff: it drops a branch whose weight's luminance
# is at or below it
WEIGHT_CUTOFF = 1e-3
# render_whitted unrolls the tree up to this depth, and queues it beyond
UNROLL_MAX_DEPTH = 4


def _where3(cond, a, b):
    return torch.where(cond[:, None], a, b)


def _hit(scene, o, d, ray_chunk, active=None):
    return scene_intersect(scene, o, d, ray_chunk=ray_chunk, active=active)


def trace_whitted(scene, o: torch.Tensor, d: torch.Tensor, depth: int,
                  ray_chunk: Optional[int] = None, active=None,
                  hit=None) -> torch.Tensor:
    """Shade a ray batch Whitted-style down to ``depth`` bounces through
    the unrolled tree; returns (N, 3) color.  ``active``: the lanes whose
    color the caller uses (the others are culled in the dispatch and come
    back 0).  ``hit``: the batch's nearest hit, if the caller has it."""
    if hit is None:
        hit = _hit(scene, o, d, ray_chunk, active=active)
    (color, hit_ok, hp, n_s, shifted, refl_coef, transmission, t_dir, tir,
     _) = _shade_local(scene, o, d, hit, ray_chunk, active)
    if depth > 0:
        r_col = trace_whitted(scene, shifted, lm.reflect(d, n_s), depth - 1,
                              ray_chunk, active=hit_ok)
        color = color + _where3(hit_ok, refl_coef[:, None] * r_col,
                                torch.zeros_like(r_col))
        t_active = hit_ok & ~tir & (transmission > 0)
        t_col = trace_whitted(scene, hp - 1e-3 * n_s, t_dir, depth - 1,
                              ray_chunk, active=t_active)
        t_w = torch.where(t_active, (1.0 - refl_coef) * transmission, 0.0)
        color = color + t_w[:, None] * t_col
    return color


def _shade_local(scene, o, d, hit, ray_chunk, active):
    """Phong-shade one traced batch.  Returns ``(color, hit_ok, hit point,
    shading normal, shifted point, reflection weight, transmission,
    refracted direction, total internal reflection, diffuse color)``, what
    the tracers need to spawn the children."""
    mats = scene.materials
    hit_ok = hit.valid if active is None else hit.valid & active
    # a miss's t is +inf: its point is set to 0 (its color is masked)
    hp = _where3(hit.valid, o + d * hit.t[:, None], torch.zeros_like(o))
    n_geo, mat_id, _ = surface_attrs(scene, hit, hp)
    inside = lm.dot(n_geo, d) > 0.0
    n_s = _where3(inside, -n_geo, n_geo)
    shifted = hp + 1e-4 * n_s

    lights = scene.lights
    lp = lights.v0 + (lights.e1 + lights.e2) / 3.0  # one point a row
    l_mat = lights.mat_id.long()
    l_amb, l_dif, l_spec = (mats.ambient[l_mat], mats.diffuse[l_mat],
                            mats.specular[l_mat])
    o_amb, o_dif, o_spec = (mats.ambient[mat_id], mats.diffuse[mat_id],
                            mats.specular[mat_id])
    shin_exp = (mats.shininess[mat_id] / 4.0)[:, None]
    to_cam = lm.normalize(scene.camera - hp)

    def phong_row(l_pos, amb_i, dif_i, spec_i):
        """One light row toward ``l_pos``: ambient, plus diffuse and
        specular where the shadow ray is clear."""
        to_l = l_pos - shifted
        dist = lm.norm(to_l)
        wi = to_l / torch.clamp(dist, min=1e-20)[:, None]
        shadowed = scene_occluded(scene, shifted, wi, dist * (1 - 1e-3),
                                  ray_chunk=ray_chunk, active=hit_ok)
        illum = o_amb * amb_i
        ndotl = torch.clamp(lm.dot(wi, n_s), min=0.0)
        diffuse = o_dif * dif_i * ndotl[:, None]
        h = lm.normalize(wi + to_cam)
        ndoth = torch.clamp(lm.dot(n_s, h), min=0.0)
        spec = o_spec * spec_i * ndoth[:, None] ** shin_exp
        return _where3(shadowed, illum, illum + diffuse + spec)

    color = torch.zeros_like(o)
    plt_ = scene.point_lights
    for li in range(lights.num):
        row = phong_row(lp[li], l_amb[li], l_dif[li], l_spec[li])
        if plt_ is not None:
            # with point lights present, an area row shades only if it
            # emits (a scene without emitters has one zero-radiance row)
            row = torch.any(lights.radiance[li] > 0).to(o.dtype) * row
        color = color + row
    if plt_ is None:
        color = color / max(lights.num, 1)
    else:
        for li in range(plt_.num):
            color = color + phong_row(plt_.position[li], plt_.ambient[li],
                                      plt_.diffuse[li], plt_.specular[li])
        emitting = (lights.radiance > 0).any(dim=-1).to(o.dtype).sum()
        color = color / torch.clamp(emitting + plt_.num, min=1.0)
    color = _where3(hit_ok, color, torch.zeros_like(color))

    is_mirror = mats.bsdf[mat_id] == BSDF_MIRROR
    ior = mats.ior[mat_id]
    n1 = torch.where(inside, ior, 1.0)
    n2 = torch.where(inside, 1.0, ior)
    fresnel_r = sampling.schlick_reflectance(sampling.schlick_r0(n1, n2),
                                             torch.abs(lm.dot(d, n_s)))
    refl_coef = torch.where(is_mirror, mats.reflection[mat_id], fresnel_r)
    t_dir, tir = lm.refract(d, n_s, n1 / n2)
    return (color, hit_ok, hp, n_s, shifted, refl_coef,
            mats.transmission[mat_id], t_dir, tir, o_dif)


def hemisphere_uniforms(seed: int, index: int, k: int, n: int,
                        like: torch.Tensor) -> torch.Tensor:
    """``(k, n, 2)`` uniforms in [0, 1) on ``like``'s device, from a
    generator seeded by ``core.rng.fold_seed(seed, index)``."""
    gen = torch.Generator(device=like.device)
    gen.manual_seed(rng.fold_seed(seed, index))
    return torch.rand((k, n, 2), generator=gen, dtype=like.dtype,
                      device=like.device)


def trace_whitted_queue(scene, o: torch.Tensor, d: torch.Tensor, depth: int,
                        ray_chunk: Optional[int] = None,
                        weight_cutoff: float = WEIGHT_CUTOFF,
                        max_iters: Optional[int] = None,
                        indirect_samples: int = 0, seed: int = 0,
                        uniforms: Optional[Sequence[torch.Tensor]] = None,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """Whitted through the weighted ray queue; returns (N, 3) color.

    Each lane shades one tree node a superstep, follows the heavier of its
    reflect and refract children and pushes the other if its weight's
    luminance is above ``weight_cutoff``; a lane without a child pops its
    latest deferred branch.  The image differs from :func:`trace_whitted`
    by the dropped subtrees only.  The stack holds ``depth + 1`` slots,
    and ``indirect_samples + depth`` more for the indirect children.

    ``indirect_samples`` > 0 adds the indirect diffuse term at every node:
    the primary node pushes ``indirect_samples`` hemisphere children of
    weight ``o_dif * cos * 0.1 / k``, each deeper node one.  Superstep
    ``it`` draws its children's uniforms by :func:`hemisphere_uniforms`
    ``(seed, it, ...)``, or takes ``uniforms[it]`` ((k, N, 2)) when given.
    At most ``max_iters`` supersteps, or if that is None
    ``2^(depth+1) - 1 + indirect_samples * (2 depth + 1)``; a run cut
    short returns the color gathered so far (``max_iters=0``: zeros).
    ``stats``, if given, receives ``supersteps``."""
    n = o.shape[0]
    gi = int(indirect_samples)
    S = depth + 1 + (gi + depth if gi else 0)
    kw = dict(dtype=o.dtype, device=o.device)
    dep = torch.full((n,), depth, dtype=torch.int32, device=o.device)
    color = torch.zeros((n, 3), **kw)
    cur = (o, d, torch.ones((n, 3), **kw), dep,
           torch.ones((n,), dtype=torch.bool, device=o.device))
    stack = lanestack.zeros((o, d, torch.zeros((n, 3), **kw), dep), S)
    top = torch.zeros_like(dep)
    iters = (max_iters if max_iters is not None
             else 2 ** (depth + 1) - 1 + gi * (2 * depth + 1))
    done = 0
    for it in range(iters):
        u_gi = None
        if gi:
            k_gi = gi if it == 0 else 1
            u_gi = (uniforms[it] if uniforms is not None
                    else hemisphere_uniforms(seed, it, k_gi, n, o))
        color, cur, stack, top, any_act = _queue_step(
            scene, color, cur, stack, top, ray_chunk, weight_cutoff, S, u_gi)
        done = it + 1
        if not bool(any_act):  # one readback a superstep
            break
    if stats is not None:
        stats["supersteps"] = done
    return color


def _queue_step(scene, color, cur, stack, top, ray_chunk, weight_cutoff, S,
                u_gi=None):
    """One superstep of :func:`trace_whitted_queue`: shade every active
    lane's node, push its indirect children (``u_gi``: (k, N, 2)
    uniforms, or None) and its lighter child whose weight's luminance is
    above ``weight_cutoff``, and move it to its heavier such child or its
    latest deferred branch.  Returns ``(color,
    cur, stack, top, any_act)``, the last a device bool."""
    cur_o, cur_d, cur_w, cur_dep, cur_act = cur
    hit = _hit(scene, cur_o, cur_d, ray_chunk, active=cur_act)
    (local, hit_ok, hp, n_s, shifted, refl_coef, transmission, t_dir, tir,
     o_dif) = _shade_local(scene, cur_o, cur_d, hit, ray_chunk, cur_act)
    color = color + cur_w * local

    can_recurse = hit_ok & (cur_dep > 0)
    zero = torch.zeros_like(cur_w)
    w_refl = _where3(can_recurse, cur_w * refl_coef[:, None], zero)
    w_refr = _where3(can_recurse & ~tir & (transmission > 0),
                     cur_w * ((1.0 - refl_coef) * transmission)[:, None],
                     zero)
    lum_refl, lum_refr = lm.luminance(w_refl), lm.luminance(w_refr)
    refl_sig = lum_refl > weight_cutoff
    refr_sig = lum_refr > weight_cutoff
    r_dir = lm.reflect(cur_d, n_s)
    t_o = hp - 1e-3 * n_s

    # indirect children, pushed like any deferred branch
    k_gi = 0 if u_gi is None else u_gi.shape[0]
    for s in range(k_gi):
        gdir, _ = sampling.uniform_hemisphere(n_s, u_gi[s][:, 0],
                                              u_gi[s][:, 1])
        cosg = torch.clamp(lm.dot(gdir, n_s), min=0.0)
        w_gi = cur_w * o_dif * (cosg * 0.1 / k_gi)[:, None]
        push_gi = can_recurse & (lm.luminance(w_gi) > weight_cutoff)
        stack, top = lanestack.push(stack, top, push_gi,
                                    (shifted, gdir, w_gi, cur_dep - 1), S)

    # follow the heavier branch, push the other if it is significant too
    refl_first = lum_refl >= lum_refr
    both = refl_sig & refr_sig
    stack, top = lanestack.push(stack, top, both & refl_first,
                                (t_o, t_dir, w_refr, cur_dep - 1), S)
    stack, top = lanestack.push(stack, top, both & ~refl_first,
                                (shifted, r_dir, w_refl, cur_dep - 1), S)
    take_refl = refl_sig & (refl_first | ~refr_sig)
    has_child = take_refl | refr_sig

    # lanes without a child pop their latest deferred branch
    can_pop = ~has_child & (top > 0)
    p_o, p_d, p_w, p_dep = lanestack.peek(stack, top, S)
    top = top - can_pop.to(top.dtype)
    new_o = _where3(has_child, _where3(take_refl, shifted, t_o), p_o)
    new_d = _where3(has_child, _where3(take_refl, r_dir, t_dir), p_d)
    new_w = _where3(has_child, _where3(take_refl, w_refl, w_refr), p_w)
    new_dep = torch.where(has_child, cur_dep - 1, p_dep)
    new_act = has_child | can_pop
    return (color, (new_o, new_d, new_w, new_dep, new_act), stack, top,
            new_act.any())


def _primary_rays(scene, cfg: RenderConfig):
    """One ray a pixel through the pixel's corner (no jitter)."""
    from light_transport_tpu_torch.integrators.path_tracer import camera_rays

    n = cfg.height * cfg.width
    u_aa = torch.zeros((n, 2), dtype=scene.camera.dtype,
                       device=scene.device)
    return camera_rays(scene, dataclasses.replace(cfg, spp=1), u_aa)


def _indirect_diffuse(scene, o, d, indirect_samples, trace_fn, ray_chunk,
                      hit=None, seed=0, uniforms=None):
    """The hemisphere-sampled indirect diffuse term at the primary hit,
    ``o_dif * L * cos * 0.1`` averaged over ``indirect_samples`` uniform
    directions, each traced by ``trace_fn(origins, directions)``.  The
    uniforms are :func:`hemisphere_uniforms` ``(seed, 0, ...)``, or
    ``uniforms`` ((k, N, 2)) when given.  ``hit``: the rays' nearest hit,
    if the caller has it."""
    n = o.shape[0]
    if hit is None:
        hit = _hit(scene, o, d, ray_chunk)
    hp = _where3(hit.valid, o + d * hit.t[:, None], torch.zeros_like(o))
    n_geo, mat_id, _ = surface_attrs(scene, hit, hp)
    n_s = _where3(lm.dot(n_geo, d) > 0, -n_geo, n_geo)
    o_dif = scene.materials.diffuse[mat_id]
    if uniforms is None:
        uniforms = hemisphere_uniforms(seed, 0, indirect_samples, n, o)
    acc = torch.zeros_like(o)
    for s in range(indirect_samples):
        gdir, _ = sampling.uniform_hemisphere(n_s, uniforms[s][:, 0],
                                              uniforms[s][:, 1])
        cos = torch.clamp(lm.dot(gdir, n_s), min=0.0)
        raw = trace_fn(hp + 1e-4 * n_s, gdir)
        acc = acc + o_dif * raw * cos[:, None] * 0.1
    return _where3(hit.valid, acc / indirect_samples, torch.zeros_like(acc))


def render_whitted(scene, cfg: RenderConfig, seed: int = 0,
                   ray_chunk: Optional[int] = None,
                   indirect_samples: int = 0,
                   indirect_mode: str = "primary") -> torch.Tensor:
    """Whitted render on the scene's device: one ray a pixel, ``(H, W,
    3)`` clipped to [0, 1].  Depth up to ``UNROLL_MAX_DEPTH`` runs the
    unrolled tree, deeper the queue.

    ``indirect_samples`` > 0 adds the indirect diffuse term:
    ``indirect_mode="primary"`` at the primary hit only, its secondary
    rays traced to ``max_depth - 1`` by the same tracer (none at depth 0);
    ``"full"`` at every node, through the queue; their uniforms are drawn
    from ``seed``."""
    if indirect_mode not in ("primary", "full"):
        raise ValueError(f"indirect_mode={indirect_mode!r}")
    o, d = _primary_rays(scene, cfg)
    depth = cfg.max_depth
    if indirect_mode == "full" and indirect_samples > 0:
        color = trace_whitted_queue(scene, o, d, depth, ray_chunk,
                                    indirect_samples=indirect_samples,
                                    seed=seed)
    elif depth > UNROLL_MAX_DEPTH:
        color = trace_whitted_queue(scene, o, d, depth, ray_chunk)
        if indirect_samples > 0:
            color = color + _indirect_diffuse(
                scene, o, d, indirect_samples,
                lambda oo, dd: trace_whitted_queue(scene, oo, dd, depth - 1,
                                                   ray_chunk),
                ray_chunk, seed=seed)
    else:
        hit0 = _hit(scene, o, d, ray_chunk)
        color = trace_whitted(scene, o, d, depth, ray_chunk, hit=hit0)
        if indirect_samples > 0 and depth > 0:
            color = color + _indirect_diffuse(
                scene, o, d, indirect_samples,
                lambda oo, dd: trace_whitted(scene, oo, dd, depth - 1,
                                             ray_chunk),
                ray_chunk, hit=hit0, seed=seed)
    return torch.clamp(color.reshape(cfg.height, cfg.width, 3), 0.0, 1.0)
