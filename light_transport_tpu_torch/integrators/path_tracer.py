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

Not ported yet (ROADMAP): ``fresnel_mode="split"``, tail compaction, the
Sobol sampler, thin-lens apertures, transmittance shadows, point lights.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.ops import dispatch, sampling
from light_transport_tpu_torch.ops.dispatch import (
    scene_intersect,
    scene_occluded,
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


def _direct_light(scene, cfg, u, shadow_o, n_s, m_dir, is_glossy,
                  diffuse_rgb, spec_rgb, shin, f_diffuse, nee_active,
                  ray_chunk):
    """The NEE estimate at each lane's vertex (zero where blocked)."""
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
            blk = scene_occluded(scene, shadow_o, wi_i,
                                 dist_i * (1.0 - 1e-3), ray_chunk=ray_chunk,
                                 active=nee_active)
            direct = direct + _where3(blk, torch.zeros_like(contrib),
                                      contrib)
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
    blocked = scene_occluded(scene, shadow_o, wi, dist * (1.0 - 1e-3),
                             ray_chunk=ray_chunk, active=nee_active)
    return _where3(blocked, torch.zeros_like(direct), direct)


def _bounce(scene, cfg: RenderConfig, state: PathState, u: torch.Tensor,
            bounce: int, ray_chunk: Optional[int] = None,
            coherent: bool = False):
    """One superstep: ``u`` is this bounce's (N, NUM_U) uniforms.  Returns
    the new state and the bounce's record entries.  ``coherent``: the
    rays are the camera grid (see ``ops.dispatch.scene_intersect``)."""
    mats = scene.materials
    eps = lm.EPSILON

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
        add_emit = lit if bounce == 0 else torch.zeros_like(lit)
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
    tp_scale = _where3(is_diffuse, diffuse_tp_scale,
                       _where3(is_glossy, glossy_tp_scale, ones))

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

    def sel(enter_v, exit_v, keep_v):
        e, x = entering, exiting
        if keep_v.dim() == 2:
            e, x = e[:, None], x[:, None]
        return torch.where(e, enter_v, torch.where(x, exit_v, keep_v))

    new_state = PathState(
        origin=new_o, direction=new_dir, throughput=new_tp,
        radiance=radiance, alive=alive,
        # block-mode shadows: a transmissive hit always grants emission,
        # since shadow rays cannot cross glass
        emit_ok=scatter_evt | (hit_ok & is_mirror) | (hit_ok & is_trans),
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
    return new_state, per_bounce


def _check_config(cfg: RenderConfig):
    unported = {
        "fresnel_mode": (cfg.fresnel_mode, "stochastic"),
        "shadow_mode": (cfg.shadow_mode, "opaque"),
        "sampler": (cfg.sampler, "uniform"),
        "aperture": (cfg.aperture, 0.0),
        "compact_tail": (cfg.compact_tail, False),
    }
    for name, (value, ported) in unported.items():
        if value != ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (ROADMAP); the port "
                f"renders {name}={ported!r}")
    if cfg.max_depth < 1:
        raise ValueError(f"max_depth={cfg.max_depth} must be at least 1")
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
    TraceRecord)``.  Past the dispatch's ``MXU_MAX_TRIS`` the camera rays
    of bounce 0 go to the dispatch as a coherent batch."""
    _check_config(cfg)
    state = PathState.initial(origins, directions)
    big = scene.mesh.num_triangles > dispatch.MXU_MAX_TRIS
    recs = []
    for b in range(cfg.max_depth):
        state, rec = _bounce(scene, cfg, state, uniforms[:, b], b, ray_chunk,
                             coherent=big and b == 0)
        recs.append(rec)
    return state.radiance, TraceRecord(
        *(torch.stack(parts, dim=1) for parts in zip(*recs)))


def camera_rays(scene, cfg: RenderConfig, u_aa: torch.Tensor):
    """Pinhole camera rays for every lane, s-major ``(s, i, j)``; ``u_aa``
    (N, 2) jitters each ray within its pixel.  Returns (origins, dirs)."""
    n_pix = cfg.height * cfg.width
    pixel_ids = torch.arange(n_pix, device=u_aa.device).repeat(cfg.spp)
    return _pixel_camera_rays(scene, cfg, pixel_ids, u_aa)


def _linspace(start: float, stop: float, num: int, like: torch.Tensor):
    """``jnp.linspace``'s formula as JAX writes it: ``start * (1 - s) +
    stop * s`` with ``s = i / (num - 1)`` in float32, the last point
    exactly ``stop`` (``torch.linspace`` fills the second half from the
    end).  XLA's compiler may rewrite the JAX side (a multiply by the
    reciprocal of ``num - 1``, then reassociated), which moves a point by
    at most one ulp of the screen's extent."""
    kw = dict(dtype=like.dtype, device=like.device)
    if num == 1:
        return torch.tensor([start], **kw)
    s = torch.arange(num - 1, **kw) / torch.tensor(float(num - 1), **kw)
    start_t = torch.tensor(start, **kw)
    stop_t = torch.tensor(stop, **kw)
    out = start_t * (1.0 - s) + stop_t * s
    return torch.cat([out, stop_t[None]])


def _pixel_camera_rays(scene, cfg: RenderConfig, pixel_ids: torch.Tensor,
                       u_aa: torch.Tensor):
    """Camera rays for explicit row-major pixel ids ``i*W + j``."""
    origin, offset = _pixel_camera_offsets(scene, cfg, pixel_ids, u_aa)
    return origin, lm.normalize(offset)


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


def _camera_lanes(scene, cfg: RenderConfig, gen: torch.Generator):
    """Jittered camera lanes and their path uniforms, drawn from ``gen``:
    first the (N, 2) jitter, then the (N, depth, NUM_U) uniforms."""
    n = cfg.height * cfg.width * cfg.spp
    dt = scene.camera.dtype
    u_aa = torch.rand((n, 2), generator=gen, dtype=dt, device=gen.device)
    uniforms = rng.path_uniforms(gen, n, cfg.max_depth, dtype=dt)
    origins, directions = camera_rays(scene, cfg, u_aa)
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
                 return_samples: bool = False):
    """Render the scene on its device: ``image (H, W, 3)`` clipped to
    [0, 1], and optionally the raw samples ``(H, W, spp, 3)``."""
    _check_config(cfg)
    origins, directions, uniforms = _camera_lanes(
        scene, cfg, _generator(scene, seed))
    radiance, _ = trace_paths(scene, cfg, origins, directions, uniforms,
                              ray_chunk=ray_chunk)
    image, samples = _to_image(radiance, cfg)
    return (image, samples) if return_samples else image


def render_with_detectors(scene, cfg: RenderConfig, seed: int = 0,
                          ray_chunk: Optional[int] = None):
    """Render plus per-surface detectors: ``(image, energy (T,),
    hits (T,))``."""
    _check_config(cfg)
    origins, directions, uniforms = _camera_lanes(
        scene, cfg, _generator(scene, seed))
    radiance, record = trace_paths(scene, cfg, origins, directions, uniforms,
                                   ray_chunk=ray_chunk)
    energy, hits = surface_detector_tally(record, scene.mesh.num_triangles)
    return _to_image(radiance, cfg)[0], energy, hits
