"""Bidirectional path tracing with multiple importance sampling.

The counterpart of ``light_transport_tpu.integrators.bdpt``, name for
name: camera and light subpaths are random walks stored in SoA vertex
tensors ``(lanes, max_len, ...)`` with validity masks; every connection
strategy (s light vertices, t camera vertices) is one masked batched op
over all lanes; MIS is the balance heuristic over forward and reverse
area densities, a delta density remapped to 1.

JAX's scope and contracts hold unchanged:

- ``light_tracing=False`` drops the t=1 strategies (light vertices
  splatted onto the film) from the sampled set and from every MIS
  denominator;
- at equal ``max_depth`` the estimator targets the path tracer's
  transport: at the depth cap the s'=0 alternative leaves the MIS
  denominators, and cap paths whose light-adjacent vertex is specular are
  excluded from the light-side strategies;
- the walks do not Russian-roulette;
- point (delta) lights: a point-only scene walks its light subpaths from
  the point table (uniform pick, isotropic emission) and connects every
  camera vertex to every light (s=1, deterministic); a scene with both
  an emitting-triangle table and point lights picks each light walk's
  family per lane with the power-proportional ``q_point`` of
  :func:`_light_family`, and every MIS density carries that pick;
- subpath segments inside transmissive objects attenuate by Beer-Lambert
  of the carried interior ``sigma_a``; connections use binary
  visibility.

Every nearest-hit and any-hit query goes through ``ops.dispatch``, so a
render reaches the scene's kernels as the path tracer does (K3, the cull
with K4, or K5 on the card).  At depth D a render of the area family
makes D nearest-hit queries for the camera walk and D for the light walk,
D any-hit queries for s=1, one for each (s>=2) connection within the
depth (D(D-1)/2) and, with light tracing, D for the splats; the point
family adds D any-hit queries a point light.  The splat adds into the
film by ``index_add_``: on the card in the order of its float atomics.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators.path_tracer import (
    _generator,
    camera_rays,
)
from light_transport_tpu_torch.ops import sampling
from light_transport_tpu_torch.ops.dispatch import (
    scene_intersect,
    scene_occluded,
)
from light_transport_tpu_torch.scene.analytic import surface_attrs
from light_transport_tpu_torch.scene.lights import sample_light_points
from light_transport_tpu_torch.scene.material import (
    BSDF_DIFFUSE,
    BSDF_GLOSSY,
    BSDF_MIRROR,
    BSDF_TRANSMISSIVE,
)

INV_PI = lm.INV_PI
INV_4PI = 1.0 / (4.0 * math.pi)
# the generator index of each part of a render's lanes:
# rng.fold_seed(seed, index), in JAX's key-split order
STREAM_AA, STREAM_CAM, STREAM_LIGHT, STREAM_ORIGIN, STREAM_NEE = range(5)
# the per-lane origin draws of each light family, in drawing order
FAMILY_DRAWS = {"point": (("lu_pick", 1), ("lu_d", 2)),
                "area": (("lu_pick", 1), ("lu_a", 2), ("lu_d", 2)),
                "mixed": (("lu_f", 1), ("lu_pick", 1), ("lu_a", 2),
                          ("lu_d", 2))}


class Vertices(NamedTuple):
    """SoA subpath vertex storage, each ``(N, L, ...)``."""

    pos: torch.Tensor  # (N, L, 3)
    ns: torch.Tensor  # (N, L, 3) shading normal, oriented against arrival
    diffuse: torch.Tensor  # (N, L, 3) BSDF albedo (kd)
    beta: torch.Tensor  # (N, L, 3) throughput up to and including this vertex
    pdf_fwd: torch.Tensor  # (N, L) forward area density of this vertex
    pdf_rev: torch.Tensor  # (N, L) reverse area density
    valid: torch.Tensor  # (N, L)
    is_light: torch.Tensor  # (N, L)
    is_delta: torch.Tensor  # (N, L) specular (mirror/transmissive) vertex
    emit: torch.Tensor  # (N, L, 3) emitted radiance if on a light
    # glossy (modified Phong): ks (zero at non-glossy vertices), exponent,
    # and the unit incoming direction (the lobe axis is reflect(win, ns))
    spec: torch.Tensor  # (N, L, 3)
    shin: torch.Tensor  # (N, L)
    win: torch.Tensor  # (N, L, 3)


def _hit(scene, o, d, ray_chunk, active=None):
    return scene_intersect(scene, o, d, ray_chunk=ray_chunk, active=active)


def _occluded(scene, o, d, dist, ray_chunk, active=None):
    return scene_occluded(scene, o, d, dist, ray_chunk=ray_chunk,
                          active=active)


def _where3(cond, a, b):
    return torch.where(cond[:, None], a, b)


def _scalar(x, like):
    """``x`` as a 0-d tensor like ``like``: a Python number is filled on
    the device, not copied there."""
    if torch.is_tensor(x):
        return x
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _lanes(x, like):
    """``x`` (a Python number, a 0-d or an (N,) tensor) as an (N,) tensor
    like ``like``; a number is filled on the device, not copied there."""
    if torch.is_tensor(x):
        return x.expand(like.shape[0])
    return torch.full(like.shape[:1], x, dtype=like.dtype,
                      device=like.device)


def _to_area(pdf_solid, from_pos, to_pos, to_ns):
    """Solid-angle density at ``from_pos`` -> area density at ``to_pos``."""
    v = to_pos - from_pos
    d2 = torch.clamp(lm.dot(v, v), min=1e-20)
    w = v / torch.sqrt(d2)[..., None]
    return pdf_solid * torch.abs(lm.dot(to_ns, w)) / d2


def random_walk(scene, origins, directions, beta0, pdf_dir0, uniforms,
                max_len: int, ray_chunk: Optional[int]) -> Vertices:
    """The camera and light subpath walker, unrolled over ``max_len``
    steps with an alive mask: each step one nearest-hit query (the last
    one included), the vertex recorded, then the continuation sampled
    from ``uniforms`` (N, L, >=2) by the path tracer's BSDF rules."""
    mats = scene.materials
    n = origins.shape[0]
    eps = lm.EPSILON
    kw = dict(dtype=origins.dtype, device=origins.device)
    rows = {k: [] for k in Vertices._fields}
    pdf_rev = [torch.zeros((n,), **kw) for _ in range(max_len)]

    o, d = origins, directions
    beta = beta0
    pdf_dir = pdf_dir0  # solid-angle pdf of the ray about to be traced
    alive = torch.ones((n,), dtype=torch.bool, device=origins.device)
    prev_pos = origins
    prev_ns = torch.zeros((n, 3), **kw)
    have_prev = torch.zeros_like(alive)
    # the carried interior absorption (one level of outer memory)
    sig_a = torch.zeros((n, 3), **kw)
    out_sig_a = torch.zeros((n, 3), **kw)

    for step in range(max_len):
        hit = _hit(scene, o, d, ray_chunk, active=alive)
        ok = alive & hit.valid
        hp = o + d * hit.t[:, None]
        # Beer-Lambert along the segment just traversed
        beta = beta * _where3(ok, torch.exp(-sig_a * hit.t[:, None]), 1.0)
        n_geo, mat_id, hit_is_light = surface_attrs(scene, hit, hp)
        inside = lm.dot(n_geo, d) > 0.0
        ns = _where3(inside, -n_geo, n_geo)
        bsdf = mats.bsdf[mat_id]
        is_delta = (bsdf == BSDF_MIRROR) | (bsdf == BSDF_TRANSMISSIVE)
        is_diffuse = bsdf == BSDF_DIFFUSE
        is_glossy = bsdf == BSDF_GLOSSY
        is_light = hit_is_light & ok
        emit = mats.emission_rgb[mat_id]
        kd = mats.diffuse[mat_id]
        ks = mats.specular[mat_id]
        shin_v = mats.shininess[mat_id]

        pdf_fwd = _to_area(pdf_dir, o, hp, ns)

        rows["pos"].append(_where3(ok, hp, 0.0))
        rows["ns"].append(_where3(ok, ns, 0.0))
        rows["diffuse"].append(_where3(ok, kd, 0.0))
        rows["beta"].append(_where3(ok, beta, 0.0))
        rows["pdf_fwd"].append(torch.where(ok, pdf_fwd, 0.0))
        rows["valid"].append(ok)
        rows["is_light"].append(is_light)
        rows["is_delta"].append(is_delta & ok)
        rows["emit"].append(_where3(is_light, emit, 0.0))
        rows["spec"].append(_where3(ok & is_glossy, ks, 0.0))
        rows["shin"].append(torch.where(ok, shin_v, 0.0))
        rows["win"].append(_where3(ok, d, 0.0))

        if step == max_len - 1:
            break

        u = uniforms[:, step]
        # --- the continuation: the path tracer's BSDF rules
        d_dir, d_pdf = sampling.cosine_weighted_hemisphere(ns, u[..., 0],
                                                           u[..., 1])
        m_dir = lm.reflect(d, ns)
        ior = mats.ior[mat_id]
        n1 = torch.where(inside, ior, 1.0)
        n2 = torch.where(inside, 1.0, ior)
        refl_p = sampling.schlick_reflectance(sampling.schlick_r0(n1, n2),
                                              -lm.dot(d, ns))
        t_dir, tir = lm.refract(d, ns, n1 / n2)
        refract_now = ((bsdf == BSDF_TRANSMISSIVE) & ~tir
                       & (u[..., 0] > refl_p))
        spec_dir = _where3(refract_now, t_dir, m_dir)

        # glossy: the path tracer's rescaled-u0 lobe mix (ks is zeroed at
        # non-glossy vertices, so kd-only rows reduce to the cosine lobe)
        ks_w = _where3(is_glossy, ks, 0.0)
        q_spec = sampling.glossy_mix(kd, ks_w)
        pick_spec = u[..., 0] < q_spec
        u0r = torch.clamp(torch.where(
            pick_spec, u[..., 0] / torch.clamp(q_spec, min=1e-12),
            (u[..., 0] - q_spec) / torch.clamp(1.0 - q_spec, min=1e-12)),
            0.0, 1.0)
        gd_dir, _ = sampling.cosine_weighted_hemisphere(ns, u0r, u[..., 1])
        gs_dir = sampling.sample_phong_lobe(m_dir, shin_v, u0r, u[..., 1])
        g_dir = _where3(pick_spec, gs_dir, gd_dir)
        g_pdf = sampling.glossy_pdf(kd, ks_w, shin_v, ns, m_dir, g_dir)
        g_ok = (g_pdf > 0.0) & (lm.dot(g_dir, ns) > 0.0)
        g_f = sampling.glossy_f(kd, ks_w, shin_v, m_dir, g_dir)

        new_dir = _where3(is_diffuse, d_dir, _where3(is_glossy, g_dir,
                                                     spec_dir))
        scatter = is_diffuse | is_glossy
        new_o = _where3(refract_now, hp - eps * ns,
                        _where3(scatter, hp + eps * new_dir, hp + eps * ns))

        # reverse density of the previous vertex: regenerating it from here
        # (diffuse |cos|/pi; glossy: the mixed lobe with the reversed
        # incoming -new_dir; delta 0, remapped to 1 in MIS)
        to_prev = prev_pos - hp
        dprev = torch.sqrt(torch.clamp(lm.dot(to_prev, to_prev), min=1e-20))
        w_prev = to_prev / dprev[:, None]
        rev_solid = torch.where(
            is_diffuse, torch.abs(lm.dot(ns, w_prev)) * INV_PI,
            torch.where(is_glossy,
                        _lobe_pdf_solid(kd, ks_w, shin_v, ns, -new_dir,
                                        w_prev),
                        0.0))
        rev_area = rev_solid * torch.abs(lm.dot(prev_ns, w_prev)) / (
            dprev * dprev)
        if step > 0:
            pdf_rev[step - 1] = torch.where(ok & have_prev, rev_area, 0.0)

        cos_o = torch.abs(lm.dot(new_dir, ns))
        pdf_ok = d_pdf > 0.0
        scale = _where3(
            is_diffuse,
            kd * INV_PI * (cos_o / torch.where(pdf_ok, d_pdf, 1.0))[:, None],
            _where3(is_glossy,
                    g_f * torch.where(
                        g_ok, cos_o / torch.where(g_ok, g_pdf, 1.0),
                        0.0)[:, None],
                    1.0))  # delta: f/pdf == 1 (the Fresnel pick sampled)
        beta = beta * _where3(ok, scale, 1.0)
        alive = ok & (is_diffuse & pdf_ok | is_glossy & g_ok | is_delta)

        # a followed refraction crosses the interface
        entering = ok & refract_now & ~inside
        exiting = ok & refract_now & inside
        new_sig = _where3(entering, mats.sigma_a[mat_id],
                          _where3(exiting, out_sig_a, sig_a))
        out_sig_a = _where3(entering, sig_a, _where3(exiting, 0.0,
                                                     out_sig_a))
        sig_a = new_sig

        prev_pos, prev_ns, have_prev = hp, ns, ok
        o, d = new_o, new_dir
        pdf_dir = torch.where(is_diffuse, d_pdf,
                              torch.where(is_glossy, g_pdf, 0.0))

    rows["pdf_rev"] = pdf_rev
    return Vertices(**{k: torch.stack(v, dim=1) for k, v in rows.items()})


def generate_camera_subpaths(scene, cfg: RenderConfig, origins, directions,
                             uniforms, ray_chunk=None) -> Vertices:
    """The camera walk; its first vertex's forward density is the camera's
    own sampling density (the t'=1 terms of the MIS weights need it)."""
    beta0 = torch.ones_like(origins)
    pdf0 = _camera_pdf_dir(scene, cfg, directions)
    return random_walk(scene, origins, directions, beta0, pdf0, uniforms,
                       cfg.max_depth, ray_chunk)


def _draw(gen, dtype, *shape):
    return torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)


def _origin_draws(gen, n, family, dtype):
    """The family's per-lane origin uniforms from ``gen``, in
    ``FAMILY_DRAWS`` order."""
    return {name: _draw(gen, dtype, n, k) if k > 1 else _draw(gen, dtype, n)
            for name, k in FAMILY_DRAWS[family]}


def generate_light_subpaths(scene, cfg: RenderConfig, gen, n, uniforms,
                            ray_chunk=None):
    """The area family's light walk, its origin draws from ``gen``: an
    area-uniform light point, a cosine-weighted emission direction."""
    u = _origin_draws(gen, n, "area", scene.camera.dtype)
    return _light_subpaths_area(scene, cfg, u["lu_pick"], u["lu_a"],
                                u["lu_d"], uniforms, ray_chunk)


def _light_subpaths_area(scene, cfg, u_pick, u_a, u_d, uniforms,
                         ray_chunk=None):
    """:func:`generate_light_subpaths` on pre-drawn origin uniforms."""
    lp, ln, lrad, pdf_pos = sample_light_points(scene.lights, u_pick,
                                                u_a[:, 0], u_a[:, 1])
    d0, pdf_dir = sampling.cosine_weighted_hemisphere(ln, u_d[:, 0],
                                                      u_d[:, 1])
    cos0 = torch.abs(lm.dot(d0, ln))
    safe = torch.clamp(pdf_pos * pdf_dir, min=1e-12)
    beta0 = lrad * (cos0 / safe)[:, None]
    o0 = lp + lm.EPSILON * d0
    verts = random_walk(scene, o0, d0, beta0, pdf_dir, uniforms,
                        cfg.max_depth, ray_chunk)
    return verts, dict(pos=lp, ns=ln, emit=lrad, pdf_pos=pdf_pos)


def generate_light_subpaths_point(scene, cfg: RenderConfig, gen, n,
                                  uniforms, ray_chunk=None):
    """The point family's light walk, its origin draws from ``gen``: one
    of the ``P`` lights picked uniformly, emitting isotropically (pdf
    1/4pi), so ``beta0 = I * P * 4pi``.  The origin has no area density
    and no normal (``l0['ns']`` is the emission direction, gated out of
    every density by ``origin_delta``)."""
    u = _origin_draws(gen, n, "point", scene.camera.dtype)
    return _light_subpaths_point(scene, cfg, u["lu_pick"], u["lu_d"],
                                 uniforms, ray_chunk)


def _sphere_dir(u_d):
    """Uniform sphere directions."""
    z = 1.0 - 2.0 * u_d[:, 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u_d[:, 1]
    return torch.stack([r * torch.cos(phi), z, r * torch.sin(phi)], -1)


def _point_pick(plt_, u_pick):
    idx = torch.clamp((u_pick * plt_.num).to(torch.int32), 0,
                      plt_.num - 1).long()
    return plt_.position[idx], plt_.intensity[idx]


def _light_subpaths_point(scene, cfg, u_pick, u_d, uniforms,
                          ray_chunk=None):
    """:func:`generate_light_subpaths_point` on pre-drawn uniforms."""
    plt_ = scene.point_lights
    n = u_pick.shape[0]
    lp, inten = _point_pick(plt_, u_pick)
    d0 = _sphere_dir(u_d)
    pdf_dir = torch.full((n,), INV_4PI, dtype=u_d.dtype, device=u_d.device)
    pick_p = 1.0 / plt_.num
    beta0 = inten / (pick_p * pdf_dir)[:, None]
    o0 = lp + lm.EPSILON * d0
    verts = random_walk(scene, o0, d0, beta0, pdf_dir, uniforms,
                        cfg.max_depth, ray_chunk)
    return verts, dict(pos=lp, ns=d0, emit=inten,
                       pdf_pos=torch.full_like(pdf_dir, pick_p))


def generate_light_subpaths_mixed(scene, cfg: RenderConfig, gen, n,
                                  uniforms, q_point, ray_chunk=None):
    """The light walk of a scene with both families, its draws from
    ``gen``: each lane picks the point family with probability
    ``q_point``, else the area family, and samples that family's origin;
    ``beta0`` divides by the whole pick density.  Returns ``(verts, l0,
    pick_point)``."""
    u = _origin_draws(gen, n, "mixed", scene.camera.dtype)
    return _light_subpaths_mixed(scene, cfg, u["lu_f"], u["lu_pick"],
                                 u["lu_a"], u["lu_d"], uniforms, q_point,
                                 ray_chunk)


def _light_subpaths_mixed(scene, cfg, u_f, u_pick, u_a, u_d, uniforms,
                          q_point, ray_chunk=None):
    """:func:`generate_light_subpaths_mixed` on pre-drawn uniforms; both
    families' origins are one masked select before one shared walk."""
    plt_ = scene.point_lights
    q_point = _scalar(q_point, u_f)
    q_area = 1.0 - q_point
    pick_point = u_f < q_point

    lp_a, ln_a, lrad, pdf_pos = sample_light_points(scene.lights, u_pick,
                                                    u_a[:, 0], u_a[:, 1])
    d_a, pdf_dir_a = sampling.cosine_weighted_hemisphere(ln_a, u_d[:, 0],
                                                         u_d[:, 1])
    cos0 = torch.abs(lm.dot(d_a, ln_a))
    beta_a = lrad * (cos0 / torch.clamp(q_area * pdf_pos * pdf_dir_a,
                                        min=1e-12))[:, None]

    # the point family reuses u_pick for its pick and u_d for its direction
    lp_p, inten = _point_pick(plt_, u_pick)
    d_p = _sphere_dir(u_d)
    pick_p = 1.0 / plt_.num
    beta_p = inten / torch.clamp(q_point * pick_p * INV_4PI, min=1e-12)

    pp = pick_point[:, None]
    o0 = torch.where(pp, lp_p + lm.EPSILON * d_p, lp_a + lm.EPSILON * d_a)
    d0 = torch.where(pp, d_p, d_a)
    beta0 = torch.where(pp, beta_p, beta_a)
    pdf_dir0 = torch.where(pick_point, INV_4PI, pdf_dir_a)
    verts = random_walk(scene, o0, d0, beta0, pdf_dir0, uniforms,
                        cfg.max_depth, ray_chunk)
    l0 = dict(pos=torch.where(pp, lp_p, lp_a),
              ns=torch.where(pp, d_p, ln_a),
              emit=torch.where(pp, inten, lrad),
              pdf_pos=torch.where(pick_point, pick_p, pdf_pos))
    return verts, l0, pick_point


def _remap(p):
    return torch.where(p == 0.0, 1.0, p)


def _camera_pdf_dir(scene, cfg: RenderConfig, directions):
    """Solid-angle density of the per-pixel primary-ray sampler: a screen
    point uniform over the pixel's jitter footprint (area 1/(W*H)),
    ``p(w) = r_s^2 / (a_samp * cos)``, r_s the distance to the screen
    plane along w."""
    a_samp = (1.0 / cfg.width) * (1.0 / cfg.height)
    cos_c = torch.clamp(torch.abs(directions[..., 2]), min=1e-6)
    r_s = torch.abs(scene.camera[2] - cfg.f_distance) / cos_c
    return r_s * r_s / (a_samp * cos_c)


def _diffuse_pdf_area(v_ns, from_pos, to_pos, to_ns):
    """Area density at ``to_pos`` of a cosine-sampled direction at
    ``from_pos`` about ``v_ns`` (the lights' emission densities)."""
    w = to_pos - from_pos
    d2 = torch.clamp(lm.dot(w, w), min=1e-20)
    wn = w / torch.sqrt(d2)[..., None]
    return _to_area(torch.abs(lm.dot(v_ns, wn)) * INV_PI, from_pos, to_pos,
                    to_ns)


def _lobe_pdf_solid(kd, ks, shin, ns, win, wn):
    """The MIS density model of the surface sampler: |cos|/pi mixed with
    the Phong lobe about ``reflect(win, ns)`` by the lobe weight (ks == 0
    gives the cosine model exactly)."""
    q = sampling.glossy_mix(kd, ks)
    p_diff = torch.abs(lm.dot(ns, wn)) * INV_PI
    m = lm.reflect(win, ns)
    return (1.0 - q) * p_diff + q * sampling.phong_pdf(m, wn, shin)


def _vertex_pdf_area(v: Vertices, k: int, to_pos, to_ns, w_in=None):
    """Area density of walk vertex ``k`` scattering toward ``to_pos``;
    ``w_in`` overrides the recorded incoming direction for a reversed
    (hypothetical) strategy."""
    win = v.win[:, k] if w_in is None else w_in
    w = to_pos - v.pos[:, k]
    d2 = torch.clamp(lm.dot(w, w), min=1e-20)
    wn = w / torch.sqrt(d2)[..., None]
    solid = _lobe_pdf_solid(v.diffuse[:, k], v.spec[:, k], v.shin[:, k],
                            v.ns[:, k], win, wn)
    return _to_area(solid, v.pos[:, k], to_pos, to_ns)


def _vertex_f(v: Vertices, k: int, w_out):
    """BSDF at walk vertex ``k`` toward unit ``w_out``: kd/pi plus the
    modified-Phong lobe."""
    m = lm.reflect(v.win[:, k], v.ns[:, k])
    return sampling.glossy_f(v.diffuse[:, k], v.spec[:, k], v.shin[:, k],
                             m, w_out)


def cam_side_mis(cam: Vertices, j: int, pt_rev, ptm_rev,
                 light_tracing: bool, s1_ratio=None):
    """Balance-heuristic denominator terms of the camera-side alternative
    strategies: ``sum_i r_i``, ``r_i`` the product of ``p_rev / p_fwd``
    down the camera subpath from junction vertex ``j``.  ``pt_rev`` and
    ``ptm_rev`` override the reverse densities at ``j`` and ``j - 1``;
    with ``light_tracing`` the recursion reaches the first vertex (the
    t'=1 alternative).  ``s1_ratio`` multiplies the ``i == j`` term only
    (mixed scenes' s=0 block, where that term is s'=1 NEE at 1/A)."""
    ref = cam.pdf_fwd[:, 0]
    ri = torch.ones_like(ref)
    total = torch.zeros_like(ref)
    stop = -1 if light_tracing else 0
    for i in range(j, stop, -1):
        rev = (_lanes(pt_rev, ref) if i == j
               else ptm_rev if i == j - 1 else cam.pdf_rev[:, i])
        ri = ri * _remap(rev) / _remap(cam.pdf_fwd[:, i])
        term = ri * s1_ratio if (i == j and s1_ratio is not None) else ri
        if i == 0:
            # t'=1: the camera vertex is not delta (film sampling)
            not_delta = ~cam.is_delta[:, 0]
        else:
            not_delta = ~cam.is_delta[:, i] & ~cam.is_delta[:, i - 1]
        total = total + torch.where(not_delta & cam.valid[:, i], term, 0.0)
    return total


def light_side_mis(lv: Vertices, l0: dict, pdf_area_light, end: int,
                   qs_rev, qsm_rev, skip_s0: bool = False,
                   origin_delta=False, nee_pick_ratio=1.0):
    """Balance-heuristic denominator terms of the light-side alternative
    strategies, s' = ``end`` .. 0 (light index 0 is the origin on the
    light, k >= 1 walk vertex k-1).  ``qs_rev`` and ``qsm_rev`` override
    the reverse densities at ``end`` and ``end - 1``.  ``skip_s0`` drops
    the s'=0 term (a camera walk of max_depth+1 vertices, never sampled);
    ``origin_delta`` (a bool or a per-lane mask) marks a point-light
    origin: no s'=0 term and a 0/remap reverse density there;
    ``nee_pick_ratio`` scales the s'=1 term (NEE's light-choice density
    over the walk's origin density); ``pdf_area_light`` is the walk's
    origin density, the family pick included."""
    ref = lv.pdf_fwd[:, 0]
    n = ref.shape[0]
    od = (origin_delta.expand(n) if torch.is_tensor(origin_delta)
          else torch.full((n,), bool(origin_delta), device=ref.device))
    ri = torch.ones_like(ref)
    total = torch.zeros_like(ref)
    for k in range(end, -1, -1):
        if k == end:
            rev = qs_rev
        elif k == end - 1:
            rev = qsm_rev
        elif k == 0:
            # walk vertex 0 scattering back to the origin (delta vertex or
            # delta origin: 0/remap); reached from lv[1] (end >= 2 here)
            diff0 = ~lv.is_delta[:, 0]
            v01 = lv.pos[:, 0] - lv.pos[:, 1]
            w01 = v01 / torch.sqrt(
                torch.clamp(lm.dot(v01, v01), min=1e-20))[..., None]
            rev = torch.where(
                diff0 & ~od,
                _vertex_pdf_area(lv, 0, l0["pos"], l0["ns"], w_in=w01), 0.0)
        else:
            rev = lv.pdf_rev[:, k - 1]
        fwd = _lanes(pdf_area_light, ref) if k == 0 else lv.pdf_fwd[:, k - 1]
        ri = ri * _remap(_lanes(rev, ref)) / _remap(fwd)
        if k == 0 and skip_s0:
            continue
        d_k = torch.zeros_like(od) if k == 0 else lv.is_delta[:, k - 1]
        d_km = torch.zeros_like(od) if k <= 1 else lv.is_delta[:, k - 2]
        term = ri * nee_pick_ratio if k == 1 else ri
        if k == 0:
            # a camera walk cannot hit a delta position
            term = torch.where(od, 0.0, term)
        total = total + torch.where(~d_k & ~d_km, term, 0.0)
    return total


def _light_family(scene):
    """The light walks' origin family, decided on the host from ``.cpu()``
    copies of the tables: ``("area", 0.0)``, ``("point", 1.0)`` or
    ``("mixed", q_point)`` with ``q_point`` power-proportional (point
    power 4pi sum|I|, area power pi sum(radiance * area)) and clamped to
    [0.05, 0.95] so neither family starves."""
    if scene.point_lights is None:
        return "area", 0.0
    rad = scene.lights.radiance.cpu().numpy().astype(np.float64)
    area = scene.lights.area.cpu().numpy().astype(np.float64)
    inten = scene.point_lights.intensity.cpu().numpy().astype(np.float64)
    area_power = float(np.pi * (rad * area[:, None]).sum())
    point_power = float(4.0 * np.pi * inten.sum())
    if area_power <= 0.0:
        return "point", 1.0
    if point_power <= 0.0:
        return "area", 0.0
    q = point_power / (point_power + area_power)
    return "mixed", float(np.clip(q, 0.05, 0.95))


def _bdpt_lane_uniforms(scene, cfg: RenderConfig, seed: int, mode: str):
    """Every per-lane random input of a render: the camera rays (jitter
    from the generator of ``fold_seed(seed, STREAM_AA)``), the walks'
    uniforms (``STREAM_CAM``, ``STREAM_LIGHT``), the NEE uniforms
    (``STREAM_NEE``), the family's origin uniforms (``STREAM_ORIGIN``, in
    ``FAMILY_DRAWS`` order) and ``mask``, the live lanes (every lane
    here)."""
    n = cfg.height * cfg.width * cfg.spp
    dt = scene.camera.dtype

    def gen(stream):
        return _generator(scene, rng.fold_seed(seed, stream))

    origins, directions = camera_rays(scene, cfg,
                                      _draw(gen(STREAM_AA), dt, n, 2))
    lanes = dict(
        o=origins, d=directions,
        cam_u=_draw(gen(STREAM_CAM), dt, n, cfg.max_depth, 2),
        light_u=_draw(gen(STREAM_LIGHT), dt, n, cfg.max_depth, 2),
        ul=_draw(gen(STREAM_NEE), dt, n, cfg.max_depth, 3),
        mask=torch.ones((n,), dtype=torch.bool, device=scene.device))
    lanes.update(_origin_draws(gen(STREAM_ORIGIN), n, mode, dt))
    return lanes


def _bdpt_assemble(cfg: RenderConfig, radiance, splat):
    """The film: the per-pixel sample mean plus the splat plane over the
    number of light paths, clipped to [0, 1]."""
    n = cfg.height * cfg.width * cfg.spp
    samples = radiance.reshape(cfg.spp, cfg.height, cfg.width, 3).permute(
        1, 2, 0, 3)
    image = samples.mean(dim=2) + splat.reshape(cfg.height, cfg.width, 3) / n
    return torch.clamp(image, 0.0, 1.0)


def render_bdpt(scene, cfg: RenderConfig, seed: int = 0,
                ray_chunk: Optional[int] = None, light_tracing: bool = True):
    """The BDPT render ``(H, W, 3)`` on the scene's device.
    ``light_tracing`` adds the t=1 strategies (light vertices splatted
    onto the film through the pixel-footprint importance); the family of
    the light walks is :func:`_light_family`'s."""
    mode, q_point = _light_family(scene)
    lanes = _bdpt_lane_uniforms(scene, cfg, seed, mode)
    radiance, splat = _bdpt_body(scene, cfg, lanes, ray_chunk,
                                 light_tracing, mode, q_point)
    return _bdpt_assemble(cfg, radiance, splat)


def _bdpt_body(scene, cfg: RenderConfig, lanes: dict, ray_chunk,
               light_tracing: bool, mode: str, q_point: float):
    """The per-lane estimator over a lanes dict of
    :func:`_bdpt_lane_uniforms` (or a shard of one): the lanes' radiance
    ``(n, 3)`` and the film's splat plane ``(H*W, 3)``.  ``lanes['mask']``
    gates the splats (a sharded render's padding lanes)."""
    n = lanes["o"].shape[0]
    kw = dict(dtype=lanes["o"].dtype, device=lanes["o"].device)
    lane_mask = lanes["mask"]
    cam = generate_camera_subpaths(scene, cfg, lanes["o"], lanes["d"],
                                   lanes["cam_u"], ray_chunk)
    # the family (static) sets the three delta-origin asymmetries of the
    # MIS densities: origin_delta, nee_pick_ratio and pdf_area_light
    has_area = mode != "point"
    has_point = mode != "area"
    pick_point = None
    q_point = _scalar(q_point, lanes["o"])
    q_area = 1.0 - q_point
    if mode == "point":
        lv, l0 = _light_subpaths_point(scene, cfg, lanes["lu_pick"],
                                       lanes["lu_d"], lanes["light_u"],
                                       ray_chunk)
        p_count = scene.point_lights.num
        # the discrete pick plays the origin density 1/A plays for areas
        pdf_area_light = 1.0 / p_count
        nee_ratio = float(p_count)
        origin_delta = True
    elif mode == "area":
        lv, l0 = _light_subpaths_area(scene, cfg, lanes["lu_pick"],
                                      lanes["lu_a"], lanes["lu_d"],
                                      lanes["light_u"], ray_chunk)
        total_area = torch.clamp(scene.lights.total_area, min=1e-12)
        pdf_area_light = 1.0 / total_area
        nee_ratio = 1.0
        origin_delta = False
    else:  # mixed
        lv, l0, pick_point = _light_subpaths_mixed(
            scene, cfg, lanes["lu_f"], lanes["lu_pick"], lanes["lu_a"],
            lanes["lu_d"], lanes["light_u"], q_point, ray_chunk)
        p_count = scene.point_lights.num
        inv_area = 1.0 / torch.clamp(scene.lights.total_area, min=1e-12)
        pdf_area_light = torch.where(pick_point, q_point / p_count,
                                     q_area * inv_area)
        nee_ratio = torch.where(pick_point, p_count / q_point, 1.0 / q_area)
        origin_delta = pick_point

    radiance = torch.zeros((n, 3), **kw)
    zeros = torch.zeros((n,), **kw)
    max_d = cfg.max_depth

    # ---- s = 0: the camera walk hits the light (area family only)
    for j in range(max_d if has_area else 0):
        hit_light = cam.valid[:, j] & cam.is_light[:, j]
        contrib = cam.beta[:, j] * cam.emit[:, j]
        if j == 0:
            w = torch.ones((n,), **kw)  # a directly seen light
        else:
            # pt rev: the light walk's origin density; ptMinus rev: the
            # light's cosine emission toward cam[j-1]
            ptm_rev = _diffuse_pdf_area(cam.ns[:, j], cam.pos[:, j],
                                        cam.pos[:, j - 1], cam.ns[:, j - 1])
            if mode == "mixed":
                denom_cam = cam_side_mis(cam, j, q_area * inv_area, ptm_rev,
                                         light_tracing,
                                         s1_ratio=1.0 / q_area)
            else:
                denom_cam = cam_side_mis(cam, j, pdf_area_light, ptm_rev,
                                         light_tracing)
            w = 1.0 / (1.0 + denom_cam)
        radiance = radiance + _where3(hit_light, contrib * w[:, None], 0.0)

    # ---- s = 1 (delta): a deterministic connection to every point light
    if has_point:
        plt_ = scene.point_lights
        p_count = plt_.num
        fam_p = q_point if mode == "mixed" else 1.0
        for j in range(max_d):
            ok0 = cam.valid[:, j] & ~cam.is_delta[:, j]
            cp = cam.pos[:, j]
            cns = cam.ns[:, j]
            for li in range(p_count):
                to_l = plt_.position[li].expand_as(cp) - cp
                d2 = torch.clamp(lm.dot(to_l, to_l), min=1e-20)
                dist = torch.sqrt(d2)
                wi = to_l / dist[:, None]
                cos_c = torch.abs(lm.dot(cns, wi))
                f_cam = _vertex_f(cam, j, wi)
                contrib = cam.beta[:, j] * f_cam * plt_.intensity[li] \
                    * (cos_c / d2)[:, None]
                blocked = _occluded(scene, cp + lm.EPSILON * cns, wi,
                                    dist * (1 - 1e-3), ray_chunk, active=ok0)
                ok = ok0 & ~blocked
                # only camera-side alternatives (s' >= 2 walks): pt rev is
                # the walk's density of generating cam[j]
                pt_rev = (fam_p / p_count) * INV_4PI * cos_c / d2
                ptm_rev = (_vertex_pdf_area(cam, j, cam.pos[:, j - 1],
                                            cam.ns[:, j - 1], w_in=-wi)
                           if j > 0 else zeros)
                denom_cam = cam_side_mis(cam, j, pt_rev, ptm_rev,
                                         light_tracing)
                w = 1.0 / (1.0 + denom_cam)
                radiance = radiance + _where3(ok, contrib * w[:, None], 0.0)

    # ---- s = 1: connect a camera vertex to a fresh light sample
    ul = lanes["ul"]
    for j in range(max_d if has_area else 0):
        ok = cam.valid[:, j] & ~cam.is_delta[:, j]
        lp, ln, lrad, pdf_pos = sample_light_points(
            scene.lights, ul[:, j, 0], ul[:, j, 1], ul[:, j, 2])
        cp = cam.pos[:, j]
        cns = cam.ns[:, j]
        to_l = lp - cp
        d2 = torch.clamp(lm.dot(to_l, to_l), min=1e-20)
        dist = torch.sqrt(d2)
        wi = to_l / dist[:, None]
        cos_c = lm.dot(cns, wi)
        cos_l = lm.dot(ln, -wi)
        g = torch.abs(cos_c * cos_l) / d2
        f_cam = _vertex_f(cam, j, wi)
        contrib = cam.beta[:, j] * f_cam * lrad * (g / pdf_pos)[:, None]
        blocked = _occluded(scene, cp + lm.EPSILON * cns, wi,
                            dist * (1 - 1e-3), ray_chunk, active=ok)
        ok = ok & ~blocked & (torch.abs(cos_l) > 1e-7)

        # qs rev: cam[j] scattering toward the light point; pt rev: the
        # light emitting toward cam[j]; ptMinus rev: cam[j] scattering
        # backward given incoming from the light (-wi)
        qs_rev = _vertex_pdf_area(cam, j, lp, ln)
        pt_rev = _diffuse_pdf_area(ln, lp, cp, cns)
        ptm_rev = (_vertex_pdf_area(cam, j, cam.pos[:, j - 1],
                                    cam.ns[:, j - 1], w_in=-wi)
                   if j > 0 else zeros)
        denom_cam = cam_side_mis(cam, j, pt_rev, ptm_rev, light_tracing)
        if mode == "mixed":
            # every camera-side alternative is a light walk, whose origin
            # density carries the family factor NEE lacks
            denom_cam = q_area * denom_cam
        # light side: s'=0 only, unreachable at j = max_d - 1
        if j == max_d - 1:
            denom_light = zeros
        else:
            denom_light = _remap(qs_rev) / _remap(pdf_pos)
        w = 1.0 / (1.0 + denom_cam + denom_light)
        radiance = radiance + _where3(ok, contrib * w[:, None], 0.0)

    # ---- s >= 2: connect camera vertex j with light walk vertex i
    for i in range(max_d):
        for j in range(max_d):
            # the surface-vertex count capped at max_depth (the path
            # tracer's deepest NEE-covered path)
            if (i + 1) + (j + 1) > max_d:
                continue
            ok = (cam.valid[:, j] & ~cam.is_delta[:, j]
                  & lv.valid[:, i] & ~lv.is_delta[:, i])
            if (i + 1) + (j + 1) == max_d and i > 0:
                # at the cap the path tracer reaches the path only by NEE
                # at a diffuse light-adjacent vertex
                ok = ok & ~lv.is_delta[:, 0]
            cp, cns = cam.pos[:, j], cam.ns[:, j]
            lp_, lns = lv.pos[:, i], lv.ns[:, i]
            to_l = lp_ - cp
            d2 = torch.clamp(lm.dot(to_l, to_l), min=1e-20)
            dist = torch.sqrt(d2)
            wi = to_l / dist[:, None]
            g = torch.abs(lm.dot(cns, wi) * lm.dot(lns, -wi)) / d2
            f_cam = _vertex_f(cam, j, wi)
            f_light = _vertex_f(lv, i, -wi)
            contrib = (cam.beta[:, j] * f_cam * f_light * lv.beta[:, i]
                       * g[:, None])
            blocked = _occluded(scene, cp + lm.EPSILON * cns, wi,
                                dist * (1 - 1e-3), ray_chunk, active=ok)
            ok = ok & ~blocked

            # the junction's reverse densities (the reversed walks reach
            # cam[j] along -wi and lv[i] along +wi)
            pt_rev = _vertex_pdf_area(lv, i, cp, cns)
            qs_rev = _vertex_pdf_area(cam, j, lp_, lns)
            ptm_rev = (_vertex_pdf_area(cam, j, cam.pos[:, j - 1],
                                        cam.ns[:, j - 1], w_in=-wi)
                       if j > 0 else zeros)
            if i > 0:
                qsm_rev = _vertex_pdf_area(lv, i, lv.pos[:, i - 1],
                                           lv.ns[:, i - 1], w_in=wi)
            elif mode == "point":
                qsm_rev = zeros  # a delta origin is not regenerated
            elif mode == "area":
                qsm_rev = _vertex_pdf_area(lv, i, l0["pos"], l0["ns"],
                                           w_in=wi)
            else:
                qsm_rev = torch.where(
                    pick_point, 0.0,
                    _vertex_pdf_area(lv, i, l0["pos"], l0["ns"], w_in=wi))

            denom_cam = cam_side_mis(cam, j, pt_rev, ptm_rev, light_tracing)
            denom_light = light_side_mis(
                lv, l0, pdf_area_light, i + 1, qs_rev, qsm_rev,
                skip_s0=(i + 1) + (j + 1) == max_d,
                origin_delta=origin_delta, nee_pick_ratio=nee_ratio)
            w = 1.0 / (1.0 + denom_cam + denom_light)
            radiance = radiance + _where3(ok, contrib * w[:, None], 0.0)

    # ---- t = 1: light tracing, light vertices splatted onto the film
    splat = torch.zeros((cfg.height * cfg.width, 3), **kw)
    if light_tracing:
        left, right, top, bottom = cfg.screen_bounds
        step_x = (right - left) / (cfg.width - 1)
        step_y = (top - bottom) / (cfg.height - 1)
        a_samp = (1.0 / cfg.width) * (1.0 / cfg.height)
        cam_pos = scene.camera
        for i in range(max_d):
            ok = lv.valid[:, i] & ~lv.is_delta[:, i] & lane_mask
            if i == max_d - 1 and i > 0:
                ok = ok & ~lv.is_delta[:, 0]  # the s>=2 block's cap rule
            p_pos = lv.pos[:, i]
            p_ns = lv.ns[:, i]
            to_c = cam_pos - p_pos
            r2 = torch.clamp(lm.dot(to_c, to_c), min=1e-20)
            dist = torch.sqrt(r2)
            w_dir = to_c / dist[:, None]  # P -> camera
            dir_cp = -w_dir  # camera -> P
            # the screen point S = cam + a * dir_cp with S_z = f
            dz = dir_cp[:, 2]
            ok = ok & (dz < -1e-6)  # P on the viewing side
            a = (cfg.f_distance - cam_pos[2]) / torch.where(dz == 0, 1.0, dz)
            sx = cam_pos[0] + a * dir_cp[:, 0]
            sy = cam_pos[1] + a * dir_cp[:, 1]
            # the pixel footprint [x_j, x_j + 1/W] x [y_i, y_i + 1/H]
            jx = torch.floor((sx - left) / step_x).to(torch.int32)
            in_x = (sx >= left + jx * step_x) & (
                sx <= left + jx * step_x + 1.0 / cfg.width)
            iy = torch.ceil((top - sy) / step_y).to(torch.int32)
            y_i = top - iy * step_y
            in_y = (sy >= y_i) & (sy <= y_i + 1.0 / cfg.height)
            ok = (ok & in_x & in_y & (jx >= 0) & (jx < cfg.width)
                  & (iy >= 0) & (iy < cfg.height))
            pix = (torch.clamp(iy, 0, cfg.height - 1) * cfg.width
                   + torch.clamp(jx, 0, cfg.width - 1))

            cos_c = torch.clamp(torch.abs(dz), min=1e-6)
            r_s = torch.abs(cam_pos[2] - cfg.f_distance) / cos_c
            we = r_s * r_s / (a_samp * cos_c)  # importance, solid angle
            cos_p = torch.abs(lm.dot(p_ns, w_dir))
            f_p = _vertex_f(lv, i, w_dir)
            contrib = lv.beta[:, i] * f_p * ((cos_p / r2) * we)[:, None]

            blocked = _occluded(scene, p_pos + lm.EPSILON * w_dir, w_dir,
                                dist * (1 - 1e-3), ray_chunk, active=ok)
            ok = ok & ~blocked

            # the camera generating P; P scattering back along the light
            # chain, reached along -w_dir by the reversed walk
            qs_rev = we * cos_p / r2
            if i > 0:
                qsm_rev = _vertex_pdf_area(lv, i, lv.pos[:, i - 1],
                                           lv.ns[:, i - 1], w_in=-w_dir)
            elif mode == "point":
                qsm_rev = zeros
            elif mode == "area":
                qsm_rev = _vertex_pdf_area(lv, i, l0["pos"], l0["ns"],
                                           w_in=-w_dir)
            else:
                qsm_rev = torch.where(
                    pick_point, 0.0,
                    _vertex_pdf_area(lv, i, l0["pos"], l0["ns"],
                                     w_in=-w_dir))
            denom = light_side_mis(lv, l0, pdf_area_light, i + 1, qs_rev,
                                   qsm_rev, skip_s0=i == max_d - 1,
                                   origin_delta=origin_delta,
                                   nee_pick_ratio=nee_ratio)
            w_mis = 1.0 / (1.0 + denom)
            add = _where3(ok, contrib * w_mis[:, None], 0.0)
            splat.index_add_(0, pix.long(), add)

    # the splats' 1/N (N the global light-path count) is _bdpt_assemble's
    return radiance, splat
