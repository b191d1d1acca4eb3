"""The camera lanes of a uniform-sampler render, frozen: the draw order
and the pinhole rays of ``api.render(integrator="path")``.

A render of ``H x W x spp`` lanes, s-major (lane ``s * H * W + i * W +
j``), seeds one ``torch.Generator`` on its device and draws first the
``(N, 2)`` pixel jitter, then the ``(N, depth, 7)`` path uniforms, in
float32, the uniforms clamped below to the smallest normal float.  A
lane's ray starts at the camera and points at its pixel's corner on the
screen plane ``z = f_distance`` plus its jitter over the pixel's
extent."""

from __future__ import annotations

import torch

# the path uniforms' slots at each bounce
U_BSDF0, U_BSDF1, U_LIGHT0, U_LIGHT1, U_PICK, U_RR, U_MED = range(7)
NUM_U = 7


def draws(seed: int, n: int, depth: int, device):
    """``(u_aa (n, 2), uniforms (n, depth, NUM_U))`` of a render seeded
    ``seed``, float32, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u_aa = torch.rand((n, 2), generator=gen, dtype=torch.float32,
                      device=device)
    u = torch.rand((n, depth, NUM_U), generator=gen, dtype=torch.float32,
                   device=device)
    return u_aa, u.clamp_(min=torch.finfo(torch.float32).tiny)


def linspace(start: float, stop: float, num: int, dtype, device):
    """``start * (1 - s) + stop * s`` with ``s = i / (num - 1)``, the last
    point exactly ``stop``."""
    kw = dict(dtype=dtype, device=device)
    if num == 1:
        return torch.tensor([start], **kw)
    s = torch.arange(num - 1, **kw) / torch.tensor(float(num - 1), **kw)
    out = (torch.tensor(start, **kw) * (1.0 - s)
           + torch.tensor(stop, **kw) * s)
    return torch.cat([out, torch.tensor([stop], **kw)])


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v, eps: float = 1e-20):
    return v * torch.sqrt(1.0 / torch.clamp(dot(v, v), min=eps))[..., None]


def rays(camera, render: dict, pixel_ids, u_aa):
    """Origins and unit directions of the lanes of ``pixel_ids`` (row-major
    ``i * W + j``) with their jitter ``u_aa``, in ``camera``'s dtype."""
    w, h = int(render["width"]), int(render["height"])
    ar = w / h
    left, right, top, bottom = -1.0, 1.0, 1.0 / ar, -1.0 / ar
    dt, dev = camera.dtype, camera.device
    xs = linspace(left, right, w, dt, dev)
    ys = linspace(top, bottom, h, dt, dev)
    px = xs[pixel_ids % w]
    py = ys[pixel_ids // w]
    jx = u_aa[:, 0] / w
    jy = u_aa[:, 1] / h
    pixel = torch.stack([px + jx, py + jy,
                         torch.full_like(px, float(render["f_distance"]))],
                        dim=-1)
    origin = camera.expand_as(pixel)
    return origin, normalize(pixel - origin)
