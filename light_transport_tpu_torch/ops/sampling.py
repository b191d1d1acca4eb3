"""Sampling math for photon transport — batched, branchless.

The photon half of ``light_transport_tpu.ops.sampling``: launch specular
reflectance, exact Fresnel reflectance, the Henyey-Greenstein inverse CDF
and the scattering rotation.  Every function maps over leading batch dims.
"""

from __future__ import annotations

import math

import torch


def schlick_r0(n1, n2):
    """R0 = ((n1-n2)/(n1+n2))^2."""
    r = (n1 - n2) / (n1 + n2)
    return r * r


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
