"""The camera path tracer with next-event estimation.

The counterpart of ``light_transport_tpu.integrators.path_tracer``: the
whole lane population (H*W*spp paths) advances one bounce per superstep
with an alive mask, BSDFs selected branchlessly by their integer code.  A
path is a pure function of its ``(N, max_depth, NUM_U)`` uniforms, so the
port and the JAX package trace the same paths from the same numbers.

Per bounce: hit -> interior-medium attenuation and in-scattering ->
emission (by ``emission_mode``) -> NEE shadow ray at diffuse and glossy
vertices -> BSDF sample (diffuse, glossy, mirror, transmissive) ->
Russian roulette after ``rr_start``.

``fresnel_mode="split"`` follows both Fresnel branches of a transmissive
hit (:func:`trace_paths_split`); :func:`render_progressive` averages
renders of per-pass seeds (with the Sobol' sampler, one point set over
all passes).

``shadow_mode="transmittance"`` attenuates every shadow ray by
``ops.dispatch.scene_transmittance`` instead of blocking it at glass.
``sampler="sobol"`` fills the same uniform tensors from ``ops.qmc``'s
scrambled Sobol' points, and ``aperture > 0`` moves each camera ray's
origin over a thin lens.

Point lights (``Scene.point_lights``) add a deterministic direct term at
each NEE vertex, and analytic spheres and planes shade through
``scene.analytic.surface_attrs``.

``RenderConfig.compact_tail`` renders through :func:`trace_paths_compact`,
which squeezes the live lanes to the front and halves the lane width
between bounce segments; every other entry point ignores the flag, as
JAX's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.ops import lanestack, qmc, sampling
from light_transport_tpu_torch.ops.dispatch import (
    scene_intersect,
    scene_occluded,
    scene_transmittance,
)
from light_transport_tpu_torch.scene.analytic import surface_attrs
from light_transport_tpu_torch.scene.lights import (
    geometry_term,
    sample_light_points,
)
from light_transport_tpu_torch.scene.material import (
    BSDF_DIFFUSE,
    BSDF_GLOSSY,
    BSDF_MIRROR,
    BSDF_TRANSMISSIVE,
)
from light_transport_tpu_torch.utils import profiling


class PathState(NamedTuple):
    """SoA per-lane path state carried across bounce supersteps."""

    origin: torch.Tensor  # (N, 3)
    direction: torch.Tensor  # (N, 3)
    throughput: torch.Tensor  # (N, 3)
    radiance: torch.Tensor  # (N, 3)
    alive: torch.Tensor  # (N,) bool
    # True when a light hit here could not have been sampled by NEE: at
    # bounce 0, or after an unbroken specular / medium-scatter chain
    emit_ok: torch.Tensor  # (N,) bool
    # solid-angle pdf of the previous vertex's sample if it was diffuse or
    # glossy, else 0 (the BSDF side of emission_mode="mis")
    prev_pdf: torch.Tensor  # (N,)
    # the medium the ray travels through, and one level of outer memory
    med_sig_a: torch.Tensor  # (N, 3)
    med_sig_s: torch.Tensor  # (N,)
    med_g: torch.Tensor  # (N,)
    out_sig_a: torch.Tensor  # (N, 3)
    out_sig_s: torch.Tensor  # (N,)
    out_g: torch.Tensor  # (N,)

    @staticmethod
    def initial(origins, directions):
        """Fresh camera-lane state: full throughput, vacuum medium."""
        n = origins.shape[0]
        kw = dict(dtype=origins.dtype, device=origins.device)
        z = torch.zeros((n,), **kw)
        z3 = torch.zeros((n, 3), **kw)
        return PathState(
            origin=origins, direction=directions,
            throughput=torch.ones((n, 3), **kw), radiance=z3,
            alive=torch.ones((n,), dtype=torch.bool, device=origins.device),
            emit_ok=torch.ones((n,), dtype=torch.bool, device=origins.device),
            prev_pdf=z, med_sig_a=z3, med_sig_s=z, med_g=z, out_sig_a=z3,
            out_sig_s=z, out_g=z)


class TraceRecord(NamedTuple):
    """Per-bounce telemetry, each ``(N, depth, ...)``."""

    log_pdf: torch.Tensor  # log of the BSDF pdf at diffuse/glossy bounces
    alive: torch.Tensor  # lane alive and hit at bounce b
    direct: torch.Tensor  # (N, depth, 3) NEE contribution at bounce b
    tri: torch.Tensor  # int32 triangle reached at bounce b (-1 none)
    incident: torch.Tensor  # luminance of the throughput at arrival


def surface_detector_tally(record: TraceRecord, num_triangles: int):
    """Per-surface detectors: incident path power and hit count per
    triangle, ``(energy (T,), hits (T,))``."""
    tri = record.tri.reshape(-1).long()
    ok = tri >= 0
    idx = torch.clamp(tri, min=0)
    w = torch.where(ok, record.incident.reshape(-1), 0.0)
    energy = torch.zeros((num_triangles,), dtype=w.dtype, device=w.device)
    energy.index_add_(0, idx, w)
    hits = torch.zeros((num_triangles,), dtype=torch.int32, device=w.device)
    hits.index_add_(0, idx, ok.to(torch.int32))
    return energy, hits


def _where3(cond, a, b):
    return torch.where(cond[:, None], a, b)


def _shadowed(scene, cfg, contrib, shadow_o, wi, max_dist, active,
              ray_chunk):
    """``contrib`` seen along the shadow segment: zero where it is blocked,
    or by ``cfg.shadow_mode="transmittance"`` attenuated by what it
    crosses."""
    if cfg.shadow_mode == "transmittance":
        return contrib * scene_transmittance(scene, shadow_o, wi, max_dist,
                                             ray_chunk=ray_chunk,
                                             active=active)
    blk = scene_occluded(scene, shadow_o, wi, max_dist, ray_chunk=ray_chunk,
                         active=active)
    return _where3(blk, torch.zeros_like(contrib), contrib)


@profiling.spanned("lt.nee")
def _direct_light(scene, cfg, u, shadow_o, n_s, m_dir, is_glossy,
                  diffuse_rgb, spec_rgb, shin, f_diffuse, nee_active,
                  ray_chunk):
    """The NEE estimate at each lane's vertex (zero where blocked), the
    point lights' deterministic term included."""
    direct = _area_light(scene, cfg, u, shadow_o, n_s, m_dir, is_glossy,
                         diffuse_rgb, spec_rgb, shin, f_diffuse, nee_active,
                         ray_chunk)
    plt_ = scene.point_lights
    if plt_ is None:
        return direct
    # f(wi) * I * cos(theta) / r^2 * V per point light: no pdf and no MIS
    # weight (BSDF sampling cannot hit a delta light), and no uniforms, so
    # a scene without point lights keeps its stream
    for li in range(plt_.num):
        to_l = plt_.position[li].expand_as(shadow_o) - shadow_o
        d2 = torch.clamp(lm.dot(to_l, to_l), min=1e-20)
        dist_i = torch.sqrt(d2)
        wi_i = to_l / dist_i[:, None]
        cos_i = torch.clamp(lm.dot(n_s, wi_i), min=0.0)
        f_i = _where3(is_glossy, sampling.glossy_f(
            diffuse_rgb, spec_rgb, shin, m_dir, wi_i), f_diffuse)
        contrib = plt_.intensity[li] * f_i * (cos_i / d2)[:, None]
        direct = direct + _shadowed(scene, cfg, contrib, shadow_o, wi_i,
                                    dist_i * (1.0 - 1e-3), nee_active,
                                    ray_chunk)
    return direct


def _area_light(scene, cfg, u, shadow_o, n_s, m_dir, is_glossy, diffuse_rgb,
                spec_rgb, shin, f_diffuse, nee_active, ray_chunk):
    """The area lights' NEE estimate (by ``cfg.nee_mode``)."""
    if cfg.nee_mode == "all":
        # one shadow ray per light triangle at its centroid, area-weighted
        lt_ = scene.lights
        lp_rows = lt_.v0 + (lt_.e1 + lt_.e2) / 3.0
        direct = torch.zeros_like(f_diffuse)
        for li in range(lt_.num):
            lp_i = lp_rows[li].expand_as(shadow_o)
            ln_i = lt_.normal[li].expand_as(shadow_o)
            g_i, wi_i, dist_i = geometry_term(shadow_o, n_s, lp_i, ln_i)
            f_i = _where3(is_glossy, sampling.glossy_f(
                diffuse_rgb, spec_rgb, shin, m_dir, wi_i), f_diffuse)
            contrib = lt_.radiance[li] * f_i * (g_i * lt_.area[li])[:, None]
            direct = direct + _shadowed(scene, cfg, contrib, shadow_o, wi_i,
                                        dist_i * (1.0 - 1e-3), nee_active,
                                        ray_chunk)
        return direct
    lp, ln, lrad, pdf_area = sample_light_points(
        scene.lights, u[:, rng.U_PICK], u[:, rng.U_LIGHT0],
        u[:, rng.U_LIGHT1])
    g_term, wi, dist = geometry_term(shadow_o, n_s, lp, ln)
    f_view = _where3(is_glossy, sampling.glossy_f(
        diffuse_rgb, spec_rgb, shin, m_dir, wi), f_diffuse)
    direct = lrad * f_view * (g_term / torch.clamp(pdf_area, min=1e-30))[
        :, None]
    if cfg.emission_mode == "mis":
        cos_phi_l = torch.abs(lm.dot(ln, -wi))
        p_nee_sa = pdf_area * dist * dist / torch.clamp(cos_phi_l, min=1e-12)
        p_b_hyp = torch.where(
            is_glossy,
            sampling.glossy_pdf(diffuse_rgb, spec_rgb, shin, n_s, m_dir, wi),
            torch.clamp(lm.dot(wi, n_s), min=0.0) * lm.INV_PI)
        w_nee = p_nee_sa * p_nee_sa / torch.clamp(
            p_nee_sa * p_nee_sa + p_b_hyp * p_b_hyp, min=1e-30)
        direct = direct * w_nee[:, None]
    return _shadowed(scene, cfg, direct, shadow_o, wi, dist * (1.0 - 1e-3),
                     nee_active, ray_chunk)


@profiling.spanned("lt.bounce")
def _bounce(scene, cfg: RenderConfig, state: PathState, u: torch.Tensor,
            bounce: Union[int, torch.Tensor],
            ray_chunk: Optional[int] = None, coherent: bool = False,
            split_ok: Optional[torch.Tensor] = None):
    """One superstep: ``u`` is this bounce's (N, NUM_U) uniforms and
    ``bounce`` the bounce index, an int or a per-lane (N,) tensor.
    Returns the new state and the bounce's record entries.  ``coherent``:
    the rays are the camera grid (see ``ops.dispatch.scene_intersect``).

    ``split_ok`` (N,) bool (``fresnel_mode="split"``): an allowed lane
    follows the refracted branch of a transmissive hit with weight
    ``1 - R``, and a third output ``defer`` returns the reflected branch
    (weight ``R``) for the caller to push: (mask, origin, direction,
    throughput, and the six pre-refraction medium fields).  Lanes not
    allowed (a full stack) keep the stochastic rule."""
    mats = scene.materials
    eps = lm.EPSILON
    profiling.count_lanes(state.alive.shape[0])

    hit = scene_intersect(scene, state.origin, state.direction,
                          ray_chunk=ray_chunk, active=state.alive,
                          coherent=coherent)
    hit_ok = hit.valid & state.alive
    hit_p = state.origin + state.direction * hit.t[:, None]
    hit_p = _where3(hit_ok, hit_p, torch.zeros_like(hit_p))

    n_geo, mat_id, is_light = surface_attrs(scene, hit, hit_p)
    cos_in = lm.dot(n_geo, state.direction)
    inside = cos_in > 0.0
    n_s = _where3(inside, -n_geo, n_geo)

    bsdf = mats.bsdf[mat_id]
    diffuse_rgb = mats.diffuse[mat_id]
    ior = mats.ior[mat_id]

    # --- interior participating medium (the carried medium) ---------------
    sig_a = state.med_sig_a
    sig_s = state.med_sig_s
    in_medium = hit_ok & torch.any(sig_a + sig_s[:, None] > 0.0, dim=-1)
    has_scat = hit_ok & (sig_s > 0.0)
    safe_ss = torch.where(has_scat, sig_s, 1.0)
    d_scat = -torch.log1p(-u[:, rng.U_MED]) / safe_ss
    scatter_evt = has_scat & (d_scat < hit.t)
    seg_len = torch.where(in_medium, torch.where(scatter_evt, d_scat, hit.t),
                          0.0)
    tp_arr = state.throughput * torch.exp(-sig_a * seg_len[:, None])

    hg_cos = sampling.sample_henyey_greenstein(state.med_g,
                                               u[:, rng.U_BSDF0])
    hg_dir = sampling.scatter_direction(state.direction, hg_cos,
                                        u[:, rng.U_BSDF1])
    scat_o = state.origin + state.direction * d_scat[:, None]

    # --- emission ----------------------------------------------------------
    lit = hit_ok & is_light
    if cfg.emission_mode == "first_hit":
        add_emit = lit & (bounce == 0)
    elif cfg.emission_mode == "nee":
        add_emit = lit & state.emit_ok
    elif cfg.emission_mode == "mis":
        add_emit = lit & (state.emit_ok | (state.prev_pdf > 0.0))
    else:
        add_emit = lit
    add_emit = add_emit & ~scatter_evt
    emit = mats.emission_rgb[mat_id] * tp_arr
    if cfg.emission_mode == "mis":
        inv_area = 1.0 / torch.clamp(scene.lights.total_area, min=1e-30)
        p_nee_hit = inv_area * hit.t * hit.t / torch.clamp(
            torch.abs(cos_in), min=1e-12)
        p_b = state.prev_pdf
        w_bsdf = p_b * p_b / torch.clamp(
            p_b * p_b + p_nee_hit * p_nee_hit, min=1e-30)
        emit = emit * torch.where(state.emit_ok, 1.0, w_bsdf)[:, None]
    radiance = state.radiance + _where3(add_emit, emit,
                                        torch.zeros_like(emit))

    # --- NEE at diffuse and glossy vertices --------------------------------
    shadow_o = hit_p + eps * n_s
    f_diffuse = diffuse_rgb * lm.INV_PI
    spec_rgb = mats.specular[mat_id]
    shin = mats.shininess[mat_id]
    is_glossy = bsdf == BSDF_GLOSSY
    m_dir = lm.reflect(state.direction, n_s)
    nee_active = hit_ok & ((bsdf == BSDF_DIFFUSE) | is_glossy) & ~scatter_evt
    direct = _direct_light(scene, cfg, u, shadow_o, n_s, m_dir, is_glossy,
                           diffuse_rgb, spec_rgb, shin, f_diffuse,
                           nee_active, ray_chunk)

    # --- diffuse branch: cosine bounce -------------------------------------
    d_dir, d_pdf = sampling.cosine_weighted_hemisphere(
        n_s, u[:, rng.U_BSDF0], u[:, rng.U_BSDF1])
    pdf_ok = d_pdf > 0.0
    cos_o = lm.dot(d_dir, n_s)
    safe_pdf = torch.where(pdf_ok, d_pdf, 1.0)
    diffuse_tp_scale = f_diffuse * (cos_o / safe_pdf)[:, None]
    diffuse_new_o = hit_p + eps * d_dir

    # --- glossy branch: u0 split at the specular probability ---------------
    q_spec = sampling.glossy_mix(diffuse_rgb, spec_rgb)
    u0 = u[:, rng.U_BSDF0]
    pick_spec = u0 < q_spec
    u0r = torch.clamp(torch.where(
        pick_spec, u0 / torch.clamp(q_spec, min=1e-12),
        (u0 - q_spec) / torch.clamp(1.0 - q_spec, min=1e-12)), 0.0, 1.0)
    gd_dir, _ = sampling.cosine_weighted_hemisphere(n_s, u0r,
                                                    u[:, rng.U_BSDF1])
    gs_dir = sampling.sample_phong_lobe(m_dir, shin, u0r, u[:, rng.U_BSDF1])
    g_dir = _where3(pick_spec, gs_dir, gd_dir)
    g_pdf = sampling.glossy_pdf(diffuse_rgb, spec_rgb, shin, n_s, m_dir,
                                g_dir)
    cos_g = lm.dot(g_dir, n_s)
    g_ok = (g_pdf > 0.0) & (cos_g > 0.0)
    g_f = sampling.glossy_f(diffuse_rgb, spec_rgb, shin, m_dir, g_dir)
    glossy_tp_scale = g_f * torch.where(
        g_ok, cos_g / torch.where(g_ok, g_pdf, 1.0), 0.0)[:, None]
    glossy_new_o = hit_p + eps * g_dir

    # --- mirror and transmissive branches ----------------------------------
    mirror_new_o = hit_p + eps * n_s
    n1 = torch.where(inside, ior, 1.0)
    n2 = torch.where(inside, 1.0, ior)
    r0 = sampling.schlick_r0(n1, n2)
    cos_i = -lm.dot(state.direction, n_s)
    refl_prob = sampling.schlick_reflectance(r0, cos_i)
    t_dir, tir = lm.refract(state.direction, n_s, n1 / n2)
    do_refract = (~tir) & (u[:, rng.U_BSDF0] > refl_prob)
    if split_ok is not None:
        do_refract = torch.where(split_ok, ~tir, do_refract)
    trans_dir = _where3(do_refract, t_dir, m_dir)
    trans_new_o = _where3(do_refract, hit_p - eps * n_s, hit_p + eps * n_s)

    # --- select by BSDF code -----------------------------------------------
    is_diffuse = bsdf == BSDF_DIFFUSE
    is_mirror = bsdf == BSDF_MIRROR
    is_trans = bsdf == BSDF_TRANSMISSIVE
    bsdf_ok = is_diffuse | is_glossy | is_mirror | is_trans
    new_dir = _where3(is_diffuse, d_dir, _where3(
        is_glossy, g_dir, _where3(is_mirror, m_dir, trans_dir)))
    new_o = _where3(is_diffuse, diffuse_new_o, _where3(
        is_glossy, glossy_new_o, _where3(is_mirror, mirror_new_o,
                                         trans_new_o)))
    new_dir = _where3(scatter_evt, hg_dir, new_dir)
    new_o = _where3(scatter_evt, scat_o, new_o)
    ones = torch.ones_like(diffuse_tp_scale)
    other_scale = ones
    if split_ok is not None:
        trans_scale = torch.where(split_ok & ~tir, 1.0 - refl_prob, 1.0)
        other_scale = _where3(is_trans, trans_scale[:, None].expand_as(ones),
                              ones)
    tp_scale = _where3(is_diffuse, diffuse_tp_scale,
                       _where3(is_glossy, glossy_tp_scale, other_scale))

    shade = hit_ok & (is_diffuse | is_glossy) & ~scatter_evt
    direct_contrib = _where3(shade, tp_arr * direct, torch.zeros_like(direct))
    radiance = radiance + direct_contrib
    new_tp = tp_arr * _where3(hit_ok & ~scatter_evt, tp_scale, ones)
    alive = state.alive & (scatter_evt | (hit_ok & bsdf_ok
                                          & (pdf_ok | ~is_diffuse)
                                          & (g_ok | ~is_glossy)))

    # --- Russian roulette (luminance-keyed) ---------------------------------
    rr_active = alive & (bounce > cfg.rr_start)
    r_r = torch.clamp(1.0 - lm.luminance(new_tp), min=cfg.rr_floor)
    rr_kill = rr_active & (u[:, rng.U_RR] < r_r)
    rr_scale = torch.where(rr_active & ~rr_kill, 1.0 / (1.0 - r_r), 1.0)
    new_tp = new_tp * rr_scale[:, None]
    alive = alive & ~rr_kill

    sample_pdf_ok = torch.where(is_glossy, g_ok, pdf_ok)
    sample_pdf = torch.where(is_glossy, g_pdf, safe_pdf)
    logged = shade & sample_pdf_ok
    log_pdf = torch.where(logged, torch.log(torch.where(logged, sample_pdf,
                                                        1.0)), 0.0)

    # --- carried-medium update: refraction crosses an interface ------------
    refracted = hit_ok & is_trans & do_refract & ~scatter_evt & state.alive
    entering = refracted & ~inside
    exiting = refracted & inside

    if cfg.shadow_mode == "transmittance":
        # the attenuated shadow ray already carries the light behind glass:
        # a transmissive hit passes the incoming emit_ok on, so that light
        # is not scored again by the refracted chain
        trans_emit = hit_ok & is_trans & state.emit_ok
    else:
        # opaque shadows cannot cross glass: the specular chain is the only
        # estimator of the light behind it
        trans_emit = hit_ok & is_trans

    def sel(enter_v, exit_v, keep_v):
        e, x = entering, exiting
        if keep_v.dim() == 2:
            e, x = e[:, None], x[:, None]
        return torch.where(e, enter_v, torch.where(x, exit_v, keep_v))

    new_state = PathState(
        origin=new_o, direction=new_dir, throughput=new_tp,
        radiance=radiance, alive=alive,
        emit_ok=scatter_evt | (hit_ok & is_mirror) | trans_emit,
        prev_pdf=torch.where(
            hit_ok & ~scatter_evt & (is_diffuse & pdf_ok | is_glossy & g_ok),
            sample_pdf, 0.0),
        med_sig_a=sel(mats.sigma_a[mat_id], state.out_sig_a,
                      state.med_sig_a),
        med_sig_s=sel(mats.sigma_s[mat_id], state.out_sig_s,
                      state.med_sig_s),
        med_g=sel(mats.medium_g[mat_id], state.out_g, state.med_g),
        out_sig_a=sel(state.med_sig_a, torch.zeros_like(state.out_sig_a),
                      state.out_sig_a),
        out_sig_s=sel(state.med_sig_s, torch.zeros_like(state.out_sig_s),
                      state.out_sig_s),
        out_g=sel(state.med_g, torch.zeros_like(state.out_g), state.out_g))
    reached = hit_ok & ~scatter_evt
    per_bounce = (log_pdf, hit_ok & state.alive, direct_contrib,
                  torch.where(reached, hit.tri, -1).to(torch.int32),
                  torch.where(reached, lm.luminance(tp_arr), 0.0))
    if split_ok is None:
        return new_state, per_bounce
    # the reflected sibling stays on the incoming side of the interface,
    # in the pre-refraction medium
    defer = (reached & is_trans & ~tir & split_ok & state.alive,
             hit_p + eps * n_s, m_dir, tp_arr * refl_prob[:, None],
             state.med_sig_a, state.med_sig_s, state.med_g,
             state.out_sig_a, state.out_sig_s, state.out_g)
    return new_state, per_bounce, defer


def _check_config(cfg: RenderConfig):
    if cfg.shadow_mode not in ("opaque", "transmittance"):
        raise ValueError(f"unknown shadow_mode {cfg.shadow_mode!r}")
    if cfg.sampler not in ("uniform", "sobol"):
        raise ValueError(f"unknown sampler {cfg.sampler!r} (expected "
                         "'uniform' or 'sobol')")
    if cfg.max_depth < 1:
        raise ValueError(f"max_depth={cfg.max_depth} must be at least 1")
    if cfg.fresnel_mode not in ("stochastic", "split"):
        raise ValueError(f"unknown fresnel_mode {cfg.fresnel_mode!r}")
    if cfg.emission_mode not in ("first_hit", "always", "nee", "mis"):
        raise ValueError(f"unknown emission_mode {cfg.emission_mode!r}")
    if cfg.nee_mode not in ("one", "all"):
        raise ValueError(f"unknown nee_mode {cfg.nee_mode!r}")
    if cfg.emission_mode == "mis" and cfg.nee_mode != "one":
        raise ValueError("emission_mode='mis' requires nee_mode='one'")


def trace_paths(scene, cfg: RenderConfig, origins: torch.Tensor,
                directions: torch.Tensor, uniforms: torch.Tensor,
                ray_chunk: Optional[int] = None
                ) -> Tuple[torch.Tensor, TraceRecord]:
    """Trace a lane population to completion; a pure function of
    ``uniforms`` (N, max_depth, NUM_U).  Returns ``(radiance (N, 3),
    TraceRecord)``.  The camera rays of bounce 0 go to the dispatch as a
    coherent batch."""
    _check_config(cfg)
    state = PathState.initial(origins, directions)
    recs = []
    for b in range(cfg.max_depth):
        state, rec = _bounce(scene, cfg, state, uniforms[:, b], b, ray_chunk,
                             coherent=b == 0)
        recs.append(rec)
    with profiling.span("lt.record"):
        record = TraceRecord(*(torch.stack(parts, dim=1)
                               for parts in zip(*recs)))
    return state.radiance, record


def camera_rays(scene, cfg: RenderConfig, u_aa: torch.Tensor,
                u_lens: Optional[torch.Tensor] = None):
    """Camera rays for every lane, s-major ``(s, i, j)``; ``u_aa`` (N, 2)
    jitters each ray within its pixel, and ``u_lens`` (N, 2), when
    ``cfg.aperture > 0``, places its origin on the lens.  Returns
    (origins, dirs)."""
    n_pix = cfg.height * cfg.width
    pixel_ids = torch.arange(n_pix, device=u_aa.device).repeat(cfg.spp)
    return _pixel_camera_rays(scene, cfg, pixel_ids, u_aa, u_lens)


def _linspace(start: float, stop: float, num: int, like: torch.Tensor):
    """``jnp.linspace``'s formula as JAX writes it: ``start * (1 - s) +
    stop * s`` with ``s = i / (num - 1)`` in float32, the last point
    exactly ``stop`` (``torch.linspace`` fills the second half from the
    end).  XLA's compiler may rewrite the JAX side (a multiply by the
    reciprocal of ``num - 1``, then reassociated), which moves a point by
    at most one ulp of the screen's extent."""
    kw = dict(dtype=like.dtype, device=like.device)
    if num == 1:
        return lm.device_const((start,), **kw)
    s = torch.arange(num - 1, **kw) / lm.device_const(float(num - 1), **kw)
    start_t = lm.device_const(start, **kw)
    stop_t = lm.device_const(stop, **kw)
    out = start_t * (1.0 - s) + stop_t * s
    return torch.cat([out, stop_t[None]])


def _pixel_camera_rays(scene, cfg: RenderConfig, pixel_ids: torch.Tensor,
                       u_aa: torch.Tensor,
                       u_lens: Optional[torch.Tensor] = None):
    """Camera rays for explicit row-major pixel ids ``i*W + j``.  With
    ``u_lens`` and ``cfg.aperture > 0``, a thin lens: each pinhole ray's
    point on the focal plane stays, and its origin moves to a point of
    the aperture disk (in the camera's xy plane); ``focus_distance <= 0``
    focuses on the screen plane."""
    origin, offset = _pixel_camera_offsets(scene, cfg, pixel_ids, u_aa)
    direction = lm.normalize(offset)
    if u_lens is None or cfg.aperture <= 0.0:
        return origin, direction
    # Python floats meet the tensors as scalars: no copy to the device
    focus = (cfg.focus_distance if cfg.focus_distance > 0.0
             else torch.abs(cfg.f_distance - scene.camera[2]))
    dz = torch.clamp(torch.abs(direction[:, 2]), min=1e-6)
    focal_pt = origin + direction * (focus / dz)[:, None]
    lx, ly = sampling.concentric_sample_disk(u_lens[:, 0], u_lens[:, 1])
    lens = cfg.aperture * torch.stack([lx, ly, torch.zeros_like(lx)], dim=-1)
    origin = origin + lens
    return origin, lm.normalize(focal_pt - origin)


def _pixel_camera_offsets(scene, cfg: RenderConfig, pixel_ids: torch.Tensor,
                          u_aa: torch.Tensor):
    """The camera and the unnormalised ray directions ``pixel - camera``
    of :func:`_pixel_camera_rays`."""
    left, right, top, bottom = cfg.screen_bounds
    xs = _linspace(left, right, cfg.width, scene.camera)
    ys = _linspace(top, bottom, cfg.height, scene.camera)
    px = xs[pixel_ids % cfg.width]
    py = ys[pixel_ids // cfg.width]
    jx = u_aa[:, 0] / cfg.width
    jy = u_aa[:, 1] / cfg.height
    pixel = torch.stack([px + jx, py + jy, torch.full_like(px, cfg.f_distance)],
                        dim=-1)
    origin = scene.camera.expand_as(pixel)
    return origin, pixel - origin


@profiling.spanned("lt.camera")
def _camera_lanes(scene, cfg: RenderConfig, seed: int,
                  sample_offset: int = 0):
    """Camera lanes and their path uniforms by ``cfg.sampler``.

    ``"uniform"`` draws from a generator seeded with ``seed`` on the
    scene's device: first the (N, 2) jitter, then the (N, depth, NUM_U)
    uniforms, then, only when ``cfg.aperture > 0``, the (N, 2) lens
    points, so a pinhole render keeps its stream.  ``"sobol"`` takes the
    same tensors from ``ops.qmc.render_uniforms`` over samples
    ``[sample_offset, sample_offset + spp)`` with the seed bits
    ``qmc.seed_bits(seed)``, and the lens points from ``qmc.LENS_PAIR``."""
    n = cfg.height * cfg.width * cfg.spp
    dt = scene.camera.dtype
    u_lens = None
    if cfg.sampler == "sobol":
        bits = qmc.seed_bits(seed)
        u_aa, uniforms = qmc.render_uniforms(
            bits, cfg.height, cfg.width, cfg.spp, cfg.max_depth, dtype=dt,
            sample_offset=sample_offset, device=scene.device)
        if cfg.aperture > 0.0:
            u_lens = qmc.render_pair(bits, cfg.height, cfg.width, cfg.spp,
                                     qmc.LENS_PAIR, dtype=dt,
                                     sample_offset=sample_offset,
                                     device=scene.device)
    else:
        gen = _generator(scene, seed)
        u_aa = torch.rand((n, 2), generator=gen, dtype=dt, device=gen.device)
        uniforms = rng.path_uniforms(gen, n, cfg.max_depth, dtype=dt)
        if cfg.aperture > 0.0:
            u_lens = torch.rand((n, 2), generator=gen, dtype=dt,
                                device=gen.device)
    origins, directions = camera_rays(scene, cfg, u_aa, u_lens)
    return origins, directions, uniforms


def _to_image(radiance: torch.Tensor, cfg: RenderConfig):
    """(N, 3) s-major lane radiance -> ((H, W, 3) image clipped to [0, 1],
    (H, W, spp, 3) raw samples)."""
    samples = radiance.reshape(cfg.spp, cfg.height, cfg.width, 3).permute(
        1, 2, 0, 3)
    return torch.clamp(samples.mean(dim=2), 0.0, 1.0), samples


def _generator(scene, seed: int) -> torch.Generator:
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(int(seed))
    return gen


def render_image(scene, cfg: RenderConfig, seed: int = 0,
                 ray_chunk: Optional[int] = None,
                 return_samples: bool = False, sample_offset: int = 0):
    """Render the scene on its device: ``image (H, W, 3)`` clipped to
    [0, 1], and optionally the raw samples ``(H, W, spp, 3)``.  With the
    Sobol' sampler the render covers samples ``[sample_offset,
    sample_offset + spp)`` of each pixel's sequence (the uniform sampler
    ignores it)."""
    _check_config(cfg)
    origins, directions, uniforms = _camera_lanes(scene, cfg, seed,
                                                  sample_offset)
    radiance, _ = trace_paths(scene, cfg, origins, directions, uniforms,
                              ray_chunk=ray_chunk)
    image, samples = _to_image(radiance, cfg)
    return (image, samples) if return_samples else image


def render_with_detectors(scene, cfg: RenderConfig, seed: int = 0,
                          ray_chunk: Optional[int] = None):
    """Render plus per-surface detectors: ``(image, energy (T,),
    hits (T,))``."""
    _check_config(cfg)
    origins, directions, uniforms = _camera_lanes(scene, cfg, seed)
    radiance, record = trace_paths(scene, cfg, origins, directions, uniforms,
                                   ray_chunk=ray_chunk)
    energy, hits = surface_detector_tally(record, scene.mesh.num_triangles)
    return _to_image(radiance, cfg)[0], energy, hits


# --------------------------------------------------------------------------
# compact_tail: the lane width halves as the paths die
# --------------------------------------------------------------------------

def _live_first(alive: torch.Tensor, n_alive: int) -> torch.Tensor:
    """The stable partition of the lanes: the live ones in lane order, then
    the dead ones in lane order (JAX's ``argsort(~alive, stable=True)``).
    ``n_alive`` is ``alive``'s count, already on the host, so the
    partition reads nothing back."""
    pos = torch.where(alive, torch.cumsum(alive, 0) - 1,
                      torch.cumsum(~alive, 0) - 1 + n_alive)
    order = torch.empty_like(pos)
    return order.scatter_(0, pos, torch.arange(pos.shape[0],
                                               device=pos.device))


def trace_paths_compact(scene, cfg: RenderConfig, origins: torch.Tensor,
                        directions: torch.Tensor, uniforms: torch.Tensor,
                        ray_chunk: Optional[int] = None, segment: int = 2,
                        min_width: int = 1 << 13,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """:func:`trace_paths` with tail compaction: ``radiance (N, 3)``, no
    TraceRecord.

    The lanes advance ``segment`` bounces at a time.  After a segment,
    unless the depth is reached or the width is at most ``min_width``, the
    host reads the live count once; while it is at most half the width
    (and the width above ``min_width``) the width halves.  On a shrink
    every lane's radiance is written to its own slot (a dead lane's is
    final), the live lanes go to the front in lane order, and the path
    state, the uniforms of the bounces still to come and the lane ids are
    gathered to the new width.  The radiance goes back to lane order at
    the end.

    A lane's radiance is bitwise :func:`trace_paths`'s: the bounce is
    elementwise over lanes and the dispatch answers each ray alone.  The
    host syncs are the live counts (one a segment) and the dispatch's own.
    ``stats``, if given, receives ``widths`` (each segment's lane width)
    and ``alive`` (each live count read)."""
    _check_config(cfg)
    n0 = origins.shape[0]
    state = PathState.initial(origins, directions)
    out = torch.zeros((n0, 3), dtype=origins.dtype, device=origins.device)
    lane_ids = torch.arange(n0, device=origins.device)
    widths, counts = [], []
    u0 = 0  # the bounce of uniforms[:, 0]
    b = 0
    while b < cfg.max_depth:
        width = state.alive.shape[0]
        widths.append(width)
        for k in range(b, min(b + segment, cfg.max_depth)):
            state, _ = _bounce(scene, cfg, state, uniforms[:, k - u0], k,
                               ray_chunk, coherent=k == 0)
        b = min(b + segment, cfg.max_depth)
        if b >= cfg.max_depth or width <= min_width:
            continue
        with profiling.span("lt.compact"):
            n_alive = int(state.alive.sum())  # the segment's one readback
            counts.append(n_alive)
            new_w = width
            while new_w > min_width and n_alive <= new_w // 2:
                new_w //= 2
            if new_w < width:
                out.index_copy_(0, lane_ids, state.radiance)
                order = _live_first(state.alive, n_alive)[:new_w]
                state = PathState(*(f[order] for f in state))
                uniforms = uniforms[order, b - u0:]
                u0 = b
                lane_ids = lane_ids[order]
    if stats is not None:
        stats["widths"] = widths
        stats["alive"] = counts
    return out.index_copy_(0, lane_ids, state.radiance)


def render_image_compact(scene, cfg: RenderConfig, seed: int = 0,
                         ray_chunk: Optional[int] = None,
                         return_samples: bool = False,
                         sample_offset: int = 0):
    """:func:`render_image` through :func:`trace_paths_compact` (the same
    lanes and uniforms, the same image bitwise)."""
    _check_config(cfg)
    origins, directions, uniforms = _camera_lanes(scene, cfg, seed,
                                                  sample_offset)
    radiance = trace_paths_compact(scene, cfg, origins, directions, uniforms,
                                   ray_chunk=ray_chunk)
    image, samples = _to_image(radiance, cfg)
    return (image, samples) if return_samples else image


# --------------------------------------------------------------------------
# fresnel_mode="split": deterministic both-branch Fresnel
# --------------------------------------------------------------------------

def trace_paths_split(scene, cfg: RenderConfig, origins: torch.Tensor,
                      directions: torch.Tensor, uniforms: torch.Tensor,
                      ray_chunk: Optional[int] = None,
                      stack_size: Optional[int] = None,
                      max_iters: Optional[int] = None,
                      stats: Optional[dict] = None) -> torch.Tensor:
    """Both-branch Fresnel path tracing: at a transmissive hit a lane
    follows the refracted branch with weight ``1 - R`` and pushes the
    reflected one (weight ``R``, resuming at ``bounce + 1``) onto its
    stack of ``S = stack_size`` slots (``min(depth, 6)`` if None); a lane
    that dies pops its latest deferred branch.  A lane whose stack is full
    samples one branch as :func:`trace_paths` does, so the estimator is
    unbiased at any stack size; the split only lowers the variance.

    Lanes carry their own bounce counter, and a branch reads the uniform
    rows of its own depth, so a deferred branch re-reads the rows its
    sibling read at that depth.  The loop runs one :func:`_split_step` an
    iteration with one host readback (are any lanes alive?), at most
    ``max_iters`` iterations, or if that is None or 0
    ``2 * sum_{k <= min(S, depth)} C(depth, k) + 1``: a lane visits at
    most that many nodes of its branch tree, and pops once per push.  A
    run cut by ``max_iters`` returns the radiance gathered so far and
    drops the branches left on the stacks.  Returns ``radiance (N, 3)``
    (no TraceRecord).  ``stats``, if given, receives ``iterations``."""
    _check_config(cfg)
    n = origins.shape[0]
    depth = cfg.max_depth
    S = stack_size if stack_size is not None else min(depth, 6)
    nodes = sum(math.comb(depth, k) for k in range(min(S, depth) + 1))
    iters = max_iters or 2 * nodes + 1

    state = PathState.initial(origins, directions)
    bounce_v = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    z = torch.zeros((n,), dtype=origins.dtype, device=origins.device)
    z3 = torch.zeros((n, 3), dtype=origins.dtype, device=origins.device)
    stack = lanestack.zeros((z3, z3, z3, z3, z, z, z3, z, z, bounce_v), S)
    top = torch.zeros_like(bounce_v)
    done = 0
    for it in range(iters):
        state, bounce_v, stack, top, any_alive = _split_step(
            scene, cfg, uniforms, state, bounce_v, stack, top, ray_chunk, S,
            coherent=it == 0)
        done = it + 1
        if not bool(any_alive):  # one readback an iteration
            break
    if stats is not None:
        stats["iterations"] = done
    return state.radiance


def _split_step(scene, cfg: RenderConfig, uniforms, state: PathState,
                bounce_v, stack, top, ray_chunk, S: int,
                coherent: bool = False):
    """One iteration of :func:`trace_paths_split`: a bounce of every lane
    at its own depth, the push of each split's reflected branch, and the
    pop of the latest deferred branch into each lane that died.  Returns
    ``(state, bounce_v, stack, top, any_alive)``, the last a device
    bool."""
    depth = cfg.max_depth
    lanes = torch.arange(bounce_v.shape[0], device=bounce_v.device)
    u = uniforms[lanes, torch.clamp(bounce_v, 0, depth - 1).long()]
    # a branch deferred at the last bounce would start dead: no split there
    split_ok = (top < S) & (bounce_v + 1 < depth)
    new_state, _, defer = _bounce(scene, cfg, state, u, bounce_v, ray_chunk,
                                  coherent=coherent, split_ok=split_ok)
    new_bounce = bounce_v + 1
    stack, top = lanestack.push(stack, top, defer[0],
                                defer[1:] + (new_bounce,), S)
    alive = new_state.alive & (new_bounce < depth)

    # dead lanes resume their latest deferred branch
    can_pop = ~alive & (top > 0)
    (p_o, p_d, p_tp, p_ma, p_ms, p_mg, p_oa, p_os, p_og,
     p_b) = lanestack.peek(stack, top, S)
    top = top - can_pop.to(top.dtype)

    def pick(pop_v, keep_v):
        c = can_pop[:, None] if keep_v.dim() == 2 else can_pop
        return torch.where(c, pop_v, keep_v)

    res_state = PathState(
        origin=pick(p_o, new_state.origin),
        direction=pick(p_d, new_state.direction),
        throughput=pick(p_tp, new_state.throughput),
        radiance=new_state.radiance,
        alive=alive | can_pop,
        # a popped branch leaves a specular (transmissive) vertex: emission
        # at its next hit was out of NEE's reach
        emit_ok=new_state.emit_ok | can_pop,
        prev_pdf=torch.where(can_pop, 0.0, new_state.prev_pdf),
        med_sig_a=pick(p_ma, new_state.med_sig_a),
        med_sig_s=pick(p_ms, new_state.med_sig_s),
        med_g=pick(p_mg, new_state.med_g),
        out_sig_a=pick(p_oa, new_state.out_sig_a),
        out_sig_s=pick(p_os, new_state.out_sig_s),
        out_g=pick(p_og, new_state.out_g))
    res_bounce = torch.where(can_pop, p_b, new_bounce)
    return res_state, res_bounce, stack, top, res_state.alive.any()


def render_image_split(scene, cfg: RenderConfig, seed: int = 0,
                       ray_chunk: Optional[int] = None,
                       sample_offset: int = 0):
    """:func:`render_image` through :func:`trace_paths_split` (the same
    lanes and uniforms): ``image (H, W, 3)`` clipped to [0, 1]."""
    _check_config(cfg)
    origins, directions, uniforms = _camera_lanes(scene, cfg, seed,
                                                  sample_offset)
    radiance = trace_paths_split(scene, cfg, origins, directions, uniforms,
                                 ray_chunk=ray_chunk)
    return _to_image(radiance, cfg)[0]


def pass_seed(seed: int, p: int) -> int:
    """Seed of pass ``p`` of a progressive render of ``seed``:
    ``core.rng.fold_seed(seed, p)``."""
    return rng.fold_seed(seed, p)


def render_progressive(scene, cfg: RenderConfig, seed: int = 0,
                       n_passes: int = 4, ray_chunk: Optional[int] = None):
    """Progressive refinement: the average of ``n_passes`` renders, each by
    ``cfg.fresnel_mode``.  With the uniform sampler pass ``p`` renders from
    seed :func:`pass_seed` ``(seed, p)``, so more passes only add samples.
    With the Sobol' sampler every pass keeps ``seed`` and pass ``p``
    covers samples ``[p * spp, (p + 1) * spp)``: the passes continue one
    point set, and their average equals the one-shot ``n_passes * spp``
    render up to the per-pass clip to [0, 1]."""
    _check_config(cfg)
    render_one = (render_image_split if cfg.fresnel_mode == "split"
                  else render_image)
    sobol = cfg.sampler == "sobol"
    acc = None
    for p in range(n_passes):
        img = render_one(scene, cfg, seed if sobol else pass_seed(seed, p),
                         ray_chunk=ray_chunk,
                         sample_offset=p * cfg.spp if sobol else 0)
        acc = img if acc is None else acc + img
    return acc / n_passes
