"""Sampling math — batched, branchless.

The counterpart of ``light_transport_tpu.ops.sampling``: the photon half
(launch specular reflectance, exact Fresnel reflectance, the
Henyey-Greenstein inverse CDF and pdf, and the scattering rotation) and
the render half (concentric disk, cosine and uniform hemisphere, the
modified-Phong lobe and Schlick).  Every function maps over leading
batch dims.
"""

from __future__ import annotations

import math

import torch

from light_transport_tpu_torch.core import math as lm


def concentric_sample_disk(u0: torch.Tensor, u1: torch.Tensor):
    """Shirley-Chiu concentric disk warp; returns (dx, dy)."""
    ox = 2.0 * u0 - 1.0
    oy = 2.0 * u1 - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    num = torch.where(use_x, oy, ox)
    safe = torch.where(r == 0.0, 1.0, r)
    ratio = torch.where(r == 0.0, 0.0, num / safe)
    theta = torch.where(use_x, lm.PI_OVER_4 * ratio,
                        lm.PI_OVER_2 - lm.PI_OVER_4 * ratio)
    r = torch.where((ox == 0.0) & (oy == 0.0), 0.0, r)
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_weighted_hemisphere(normal: torch.Tensor, u0, u1):
    """Cosine-weighted direction about ``normal`` (Malley's method), in the
    normal's own frame.  Returns ``(direction, pdf)``, pdf = cos/pi."""
    dx, dy = concentric_sample_disk(u0, u1)
    z2 = torch.clamp(1.0 - dx * dx - dy * dy, min=0.0)
    pos = z2 > 0.0
    z = torch.where(pos, torch.sqrt(torch.where(pos, z2, 1.0)), 0.0)
    local = torch.stack([dx, dy, z], dim=-1)
    return lm.to_world(local, normal), z * lm.INV_PI


def uniform_hemisphere(normal: torch.Tensor, u0, u1):
    """Uniform direction over the hemisphere about ``normal``, cos = u0.
    Returns ``(direction, pdf)``, pdf = 1/(2 pi)."""
    st = torch.sqrt(torch.clamp(1.0 - u0 * u0, min=0.0))
    phi = 2.0 * math.pi * u1
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), u0],
                        dim=-1)
    direction = lm.to_world(local, normal)
    return direction, torch.full_like(u0, lm.INV_2PI)


def sample_phong_lobe(axis: torch.Tensor, shininess, u0, u1):
    """Direction from the normalized Phong lobe about ``axis``,
    p(w) = (n+1)/(2 pi) cos^n; may fall below the horizon (callers zero
    those)."""
    cos_a = torch.pow(torch.clamp(u0, 1e-12, 1.0), 1.0 / (shininess + 1.0))
    s2 = torch.clamp(1.0 - cos_a * cos_a, min=0.0)
    pos = s2 > 0.0
    sin_a = torch.where(pos, torch.sqrt(torch.where(pos, s2, 1.0)), 0.0)
    phi = 2.0 * math.pi * u1
    local = torch.stack(
        [sin_a * torch.cos(phi), sin_a * torch.sin(phi), cos_a], dim=-1)
    return lm.to_world(local, axis)


def _pow_pos(c, shininess):
    pos = c > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, c, 1.0), shininess),
                       0.0)


def phong_pdf(axis: torch.Tensor, w: torch.Tensor, shininess):
    """Solid-angle pdf of :func:`sample_phong_lobe`."""
    cos_a = torch.clamp(lm.dot(axis, w), min=0.0)
    return (shininess + 1.0) * lm.INV_2PI * _pow_pos(cos_a, shininess)


def glossy_mix(kd_rgb: torch.Tensor, ks_rgb: torch.Tensor):
    """Specular-lobe probability q = lum(ks) / (lum(kd) + lum(ks))."""
    kd_l = lm.luminance(kd_rgb)
    ks_l = lm.luminance(ks_rgb)
    return ks_l / torch.clamp(kd_l + ks_l, min=1e-12)


def glossy_pdf(kd_rgb, ks_rgb, shininess, n_s, refl_dir, w):
    """Solid-angle pdf of the modified-Phong sampler (cosine lobe and Phong
    lobe mixed by :func:`glossy_mix`)."""
    q = glossy_mix(kd_rgb, ks_rgb)
    p_diff = torch.clamp(lm.dot(n_s, w), min=0.0) * lm.INV_PI
    return (1.0 - q) * p_diff + q * phong_pdf(refl_dir, w, shininess)


def glossy_f(kd_rgb, ks_rgb, shininess, refl_dir, w):
    """Modified-Phong BRDF: kd/pi + ks (n+2)/(2 pi) cos^n about the mirror
    direction."""
    cos_a = torch.clamp(lm.dot(refl_dir, w), min=0.0)
    spec = (shininess + 2.0) * lm.INV_2PI * _pow_pos(cos_a, shininess)
    return kd_rgb * lm.INV_PI + ks_rgb * spec[..., None]


def schlick_reflectance(r0, cos_i):
    """Schlick's approximation R = R0 + (1-R0)(1-|cos_i|)^5, the fifth
    power taken as XLA takes an integer power: m * ((m*m) * (m*m))."""
    m = torch.clamp(1.0 - torch.abs(cos_i), 0.0, 1.0)
    m2 = m * m
    return r0 + (1.0 - r0) * (m * (m2 * m2))


def schlick_r0(n1, n2):
    """R0 = ((n1-n2)/(n1+n2))^2."""
    r = (n1 - n2) / (n1 + n2)
    return r * r


def henyey_greenstein_pdf(cos_theta, g):
    """HG phase function (solid-angle pdf) of the scattering cosine
    ``cos_theta = dot(new_dir, old_dir)``: forward-peaked for g > 0,
    p = (1-g^2) / (4 pi (1+g^2-2g cos)^{3/2}), the denominator clamped at
    1e-12.

    The reference's never-called stub (src/medium_samples.py:14-16) has
    ``+2g cos`` in the denominator, the density of the negated cosine;
    this is the density that :func:`sample_henyey_greenstein` and
    :func:`scatter_direction` draw from."""
    denom = torch.clamp(1.0 + g * g - 2.0 * g * cos_theta, min=1e-12)
    return lm.INV_4PI * (1.0 - g * g) / (denom * torch.sqrt(denom))


def sample_henyey_greenstein(g, u):
    """Analytic inverse-CDF sample of the HG scattering cosine.

    cos(theta) = (1 + g^2 - ((1-g^2)/(1-g+2gu))^2) / (2g), with the
    isotropic limit cos = 2u - 1 taken branchlessly for |g| ~ 0.  ``g`` is
    clamped away from +/-1, where the inverse CDF is 0/0.
    """
    g = torch.clamp(g, -0.999999, 0.999999)
    iso = torch.abs(g) < 1e-3
    g_safe = torch.where(iso, torch.ones_like(g), g)
    frac = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
    cos_aniso = (1.0 + g * g - frac * frac) / (2.0 * g_safe)
    cos_iso = 2.0 * u - 1.0
    return torch.clamp(torch.where(iso, cos_iso, cos_aniso), -1.0, 1.0)


def orthonormal_frame(n: torch.Tensor):
    """Branchless orthonormal basis ``(t, b)`` perpendicular to unit ``n``
    (Duff et al.)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bvec = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bvec


def scatter_direction(direction, cos_theta, u_phi):
    """Rotate ``direction`` by the scattering angle (cos_theta,
    phi = 2 pi u_phi) in the orthonormal frame of the old direction."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u_phi
    lx = sin_theta * torch.cos(phi)
    ly = sin_theta * torch.sin(phi)
    t, b = orthonormal_frame(direction)
    return (lx[..., None] * t + ly[..., None] * b
            + cos_theta[..., None] * direction)


def fresnel_dielectric(cos_i, n1, n2):
    """Exact unpolarized Fresnel reflectance for a dielectric interface.
    Returns R in [0, 1]; total internal reflection gives 1."""
    cos_i = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    sin_t2 = (n1 / n2) ** 2 * (1.0 - cos_i * cos_i)
    tir = sin_t2 >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    rs = (n1 * cos_i - n2 * cos_t) / torch.clamp(n1 * cos_i + n2 * cos_t,
                                                 min=1e-12)
    rp = (n1 * cos_t - n2 * cos_i) / torch.clamp(n1 * cos_t + n2 * cos_i,
                                                 min=1e-12)
    r = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, torch.ones_like(r), torch.clamp(r, 0.0, 1.0))
