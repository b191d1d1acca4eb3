"""The plain path tracer of the render configurations: the pixels that
``api.render(integrator="path")`` draws, worked out again for a sample
of pixels of a frame.

The same estimator, lane by lane, from the same uniforms
(``reference.camera``): at each bounce the nearest hit by brute force;
emission by ``emission_mode`` (``first_hit``, ``nee`` or ``always``);
next-event estimation at every hit, one shadow ray to an area-uniform
point of a light triangle picked by area; a cosine-weighted diffuse
bounce; Russian roulette on the throughput's luminance after
``rr_start``.  The configurations it serves hold diffuse, non-scattering
materials only; it refuses any other setting.  A pixel is the mean of
its ``spp`` lanes, clipped to [0, 1].

``dtype``: float32, the configurations' precision, or a lower one for
the control (the uniforms are drawn in float32 and then cast)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ltbench.reference import camera as cam
from ltbench.reference.intersect import Triangles, nearest, occluded
from ltbench.reference.light_order import light_order

EPSILON = 1e-4  # offset of a new ray's origin from its surface
INV_PI = 1.0 / math.pi
LUMA = (0.2126, 0.7152, 0.0722)
# the settings this reference renders, and the values it accepts
SUPPORTED = {"sampler": ("uniform",), "shadow_mode": ("opaque",),
             "fresnel_mode": ("stochastic",), "nee_mode": ("one",),
             "emission_mode": ("first_hit", "nee", "always")}


class RefScene(NamedTuple):
    tris: Triangles
    normal: torch.Tensor  # (T, 3) unit geometric normals
    mat_id: torch.Tensor  # (T,) int64
    is_light: torch.Tensor  # (T,) bool
    diffuse: torch.Tensor  # (M, 3)
    emission: torch.Tensor  # (M, 3) emitted radiance
    light_v0: torch.Tensor  # (L, 3)
    light_e1: torch.Tensor
    light_e2: torch.Tensor
    light_normal: torch.Tensor
    light_radiance: torch.Tensor  # (L, 3)
    light_cdf: torch.Tensor  # (L,) area-weighted, inclusive upper edges
    total_area: torch.Tensor  # ()
    camera: torch.Tensor  # (3,)


def _bsdf(m: dict) -> str:
    if m["is_glossy"]:
        return "glossy"
    if m["is_diffuse"]:
        return "diffuse"
    if m["is_mirror"]:
        return "mirror"
    return "transmissive" if m["transmission"] > 0.0 else "none"


def build(arrays, device, dtype=torch.float32) -> RefScene:
    """The reference's tables from a configuration's ``SceneArrays``:
    edges and unit normals in float64, cast to float32 (then ``dtype``);
    the light triangles in the program's table order (``light_order``),
    their areas and pick CDF in float64."""
    used = np.unique(arrays.mat_id)
    for i in used:
        m = arrays.materials[i]
        if _bsdf(m) != "diffuse" or m["sigma_s"] > 0 or any(m["sigma_a"]):
            raise NotImplementedError(
                f"material {m.get('name')!r}: the reference renders "
                "diffuse, non-scattering materials only")
    v = arrays.vertices.astype(np.float64)
    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    f32 = [a.astype(np.float32) for a in (v0, e1, e2, n)]

    lights = np.nonzero(arrays.is_light)[0]
    lights = lights[light_order(arrays.vertices, arrays.is_light)]
    le1 = f32[1][lights].astype(np.float64)
    le2 = f32[2][lights].astype(np.float64)
    area = 0.5 * np.linalg.norm(np.cross(le1, le2), axis=-1)
    emis = np.asarray([[m["emission"] * c for c in m["emission_color"]]
                       for m in arrays.materials], np.float64)

    def t(a, dt=np.float32):
        return torch.as_tensor(np.asarray(a, dt), device=device)

    def f(a):
        return t(a).to(dtype)

    return RefScene(
        tris=Triangles(f(f32[0]), f(f32[1]), f(f32[2])), normal=f(f32[3]),
        mat_id=t(arrays.mat_id, np.int64), is_light=t(arrays.is_light, bool),
        diffuse=f([m["diffuse"] for m in arrays.materials]),
        emission=f(emis), light_v0=f(f32[0][lights]), light_e1=f(le1),
        light_e2=f(le2), light_normal=f(f32[3][lights]),
        light_radiance=f(emis[arrays.mat_id[lights]]),
        light_cdf=f(np.cumsum(area) / area.sum()), total_area=f(area.sum()),
        camera=f(arrays.camera))


def _check(render: dict):
    for key, ok in SUPPORTED.items():
        if render[key] not in ok:
            raise NotImplementedError(f"{key}={render[key]!r}: the reference "
                                      f"renders {ok}")
    if render["aperture"] > 0.0:
        raise NotImplementedError("aperture > 0: the reference renders a "
                                  "pinhole")


def _to_world(local, n):
    """Duff et al.'s branchless frame about unit ``n``."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bv = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return local[..., 0:1] * t + local[..., 1:2] * bv + local[..., 2:3] * n


def _cosine_hemisphere(n, u0, u1):
    """Malley's method over Shirley and Chiu's concentric disk:
    ``(direction, pdf)``, pdf = cos / pi."""
    ox = 2.0 * u0 - 1.0
    oy = 2.0 * u1 - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    num = torch.where(use_x, oy, ox)
    ratio = torch.where(r == 0.0, 0.0, num / torch.where(r == 0.0, 1.0, r))
    theta = torch.where(use_x, (math.pi / 4) * ratio,
                        math.pi / 2 - (math.pi / 4) * ratio)
    r = torch.where((ox == 0.0) & (oy == 0.0), 0.0, r)
    dx, dy = r * torch.cos(theta), r * torch.sin(theta)
    z2 = torch.clamp(1.0 - dx * dx - dy * dy, min=0.0)
    pos = z2 > 0.0
    z = torch.where(pos, torch.sqrt(torch.where(pos, z2, 1.0)), 0.0)
    return _to_world(torch.stack([dx, dy, z], dim=-1), n), z * INV_PI


def _nearest_active(o, d, alive, tris):
    t = torch.full(alive.shape, float("inf"), dtype=o.dtype, device=o.device)
    tri = torch.full(alive.shape, -1, dtype=torch.int64, device=o.device)
    idx = torch.nonzero(alive)[:, 0]
    if idx.numel():
        t[idx], tri[idx] = nearest(o[idx], d[idx], tris)
    return t, tri


def _occluded_active(o, d, max_dist, active, tris):
    out = torch.zeros(active.shape, dtype=torch.bool, device=o.device)
    idx = torch.nonzero(active)[:, 0]
    if idx.numel():
        out[idx] = occluded(o[idx], d[idx], max_dist[idx], tris)
    return out


def trace(scene: RefScene, render: dict, o, d, u):
    """Radiance (L, 3) of lanes starting at ``o``, ``d`` with their
    uniforms ``u`` (L, depth, 7)."""
    w3 = lambda c, a, b: torch.where(c[:, None], a, b)  # noqa: E731
    dt = o.dtype
    n = o.shape[0]
    tp = torch.ones((n, 3), dtype=dt, device=o.device)
    rad = torch.zeros_like(tp)
    alive = torch.ones((n,), dtype=torch.bool, device=o.device)
    emit_ok = alive.clone()
    luma = torch.tensor(LUMA, dtype=dt, device=o.device)
    mode = render["emission_mode"]
    for b in range(int(render["max_depth"])):
        ub = u[:, b]
        t, tri = _nearest_active(o, d, alive, scene.tris)
        hit = (tri >= 0) & alive
        hit_p = w3(hit, o + d * t[:, None], torch.zeros_like(o))
        k = torch.clamp(tri, min=0)
        n_geo, mat, lit = scene.normal[k], scene.mat_id[k], scene.is_light[k]
        n_s = w3(cam.dot(n_geo, d) > 0.0, -n_geo, n_geo)
        if mode == "first_hit":
            add = hit & lit & (b == 0)
        elif mode == "nee":
            add = hit & lit & emit_ok
        else:
            add = hit & lit
        rad = rad + w3(add, scene.emission[mat] * tp, torch.zeros_like(tp))

        # next-event estimation: one area-uniform point of a light
        shadow_o = hit_p + EPSILON * n_s
        f_d = scene.diffuse[mat] * INV_PI
        li = torch.searchsorted(scene.light_cdf, ub[:, cam.U_PICK].contiguous())
        li = torch.clamp(li, 0, scene.light_cdf.shape[0] - 1)
        sa = torch.sqrt(ub[:, cam.U_LIGHT0])
        b1 = sa * (1.0 - ub[:, cam.U_LIGHT1])
        b2 = ub[:, cam.U_LIGHT1] * sa
        lp = (scene.light_v0[li] + b1[:, None] * scene.light_e1[li]
              + b2[:, None] * scene.light_e2[li])
        to_l = lp - shadow_o
        dist2 = torch.clamp(cam.dot(to_l, to_l), min=1e-20)
        dist = torch.sqrt(dist2)
        wi = to_l / dist[:, None]
        g = torch.abs(cam.dot(n_s, wi)
                      * cam.dot(scene.light_normal[li], -wi)) / dist2
        pdf_area = 1.0 / torch.clamp(scene.total_area, min=1e-30)
        direct = (scene.light_radiance[li] * f_d
                  * (g / torch.clamp(pdf_area, min=1e-30))[:, None])
        blocked = _occluded_active(shadow_o, wi, dist * (1.0 - 1e-3), hit,
                                   scene.tris)
        direct = w3(blocked, torch.zeros_like(direct), direct)

        # the diffuse bounce
        d_new, pdf = _cosine_hemisphere(n_s, ub[:, cam.U_BSDF0],
                                        ub[:, cam.U_BSDF1])
        pdf_ok = pdf > 0.0
        cos_o = cam.dot(d_new, n_s)
        scale = f_d * (cos_o / torch.where(pdf_ok, pdf, 1.0))[:, None]
        rad = rad + w3(hit, tp * direct, torch.zeros_like(direct))
        tp = tp * w3(hit, scale, torch.ones_like(scale))
        alive = alive & hit & pdf_ok
        if b > int(render["rr_start"]):
            r_r = torch.clamp(1.0 - cam.dot(tp, luma),
                              min=float(render["rr_floor"]))
            kill = alive & (ub[:, cam.U_RR] < r_r)
            keep = alive & ~kill
            tp = tp * torch.where(keep, 1.0 / (1.0 - r_r), 1.0)[:, None]
            alive = keep
        # a diffuse vertex leaves no emission to a later light hit
        emit_ok = torch.zeros_like(emit_ok)
        o, d = hit_p + EPSILON * d_new, d_new
    return rad


def render_pixels(scene: RefScene, render: dict, seed: int, pixel_ids):
    """The clipped pixels ``(P, 3)`` (float32) of ``pixel_ids`` (row-major
    ``i * W + j``) in the frame rendered with ``seed``."""
    _check(render)
    dev = scene.camera.device
    hw = int(render["width"]) * int(render["height"])
    spp = int(render["spp"])
    u_aa, u = cam.draws(seed, hw * spp, int(render["max_depth"]), dev)
    pix = torch.as_tensor(pixel_ids, device=dev).long()
    lanes = (torch.arange(spp, device=dev)[:, None] * hw + pix[None, :])
    lanes = lanes.reshape(-1)  # s-major: (spp, P)
    dt = scene.camera.dtype
    o, d = cam.rays(scene.camera, render, pix.repeat(spp),
                    u_aa[lanes].to(dt))
    rad = trace(scene, render, o, d, u[lanes].to(dt))
    del u_aa, u
    rad = rad.float().reshape(spp, pix.shape[0], 3)
    return torch.clamp(rad.mean(dim=0), 0.0, 1.0)
