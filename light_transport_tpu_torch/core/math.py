"""Vector math over SoA ``(..., 3)`` tensors.

The counterpart of ``light_transport_tpu.core.math``: every op maps over
leading batch dims.  Dot products are written out component by component,
``(x0*y0 + x1*y1) + x2*y2``, the order in which XLA reduces a length-3
axis, so that both packages round alike.
"""

from __future__ import annotations

import collections
import math
import threading

import torch

# Ray-offset epsilon (100x the float64 reference's 1e-6: float32 offsets of
# 1e-6 re-intersect the spawning surface)
EPSILON = 1e-4

INV_PI = 1.0 / math.pi
INV_2PI = 0.5 / math.pi
INV_4PI = 0.25 / math.pi
PI_OVER_2 = math.pi / 2
PI_OVER_4 = math.pi / 4

_LUMA = (0.2126, 0.7152, 0.0722)

# the keys device_const keeps: a path-traced frame uses six (the screen
# bounds, the pixel count less one, the intervals' ends, the luma weights)
CONST_CACHE_SIZE = 128
_CONSTS: collections.OrderedDict = collections.OrderedDict()
_CONSTS_LOCK = threading.Lock()


def _exact(v):
    """``v`` as a key that ``==`` cannot blur: 0.0 and -0.0 differ, a NaN
    matches itself, a float32 and a float of one value differ."""
    if isinstance(v, tuple):
        return tuple(map(_exact, v))
    return type(v), repr(v)


def device_const(values, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(values, dtype=dtype, device=device)`` for a
    Python number or tuple of numbers, built on the first call per
    ``(values, dtype, device)`` and the same tensor object after it.

    On the card, building it is a pageable host-to-device copy, after
    which the host waits for every kernel queued before it; the cache
    pays that once per key, not once per call.  The tensor is shared by
    every caller: read it, index it, ``expand`` it or pass it to
    out-of-place ops, and never write it in place.  The
    ``CONST_CACHE_SIZE`` keys used last are kept.  A tensor ``values``
    passes through ``torch.as_tensor`` uncached (no copy when it already
    has the dtype and device)."""
    if isinstance(values, torch.Tensor):
        return torch.as_tensor(values, dtype=dtype, device=device)
    key = (_exact(values), dtype, device)
    with _CONSTS_LOCK:
        t = _CONSTS.get(key)
        if t is None:
            # an inference tensor could not be saved for another
            # caller's backward pass
            with torch.inference_mode(False):
                t = torch.as_tensor(values, dtype=dtype, device=device)
            _CONSTS[key] = t
            if len(_CONSTS) > CONST_CACHE_SIZE:
                _CONSTS.popitem(last=False)
        else:
            _CONSTS.move_to_end(key)
    return t


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis: ``(...,3),(...,3)->(...)``."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize; zero vectors map to zero instead of NaN."""
    n2 = torch.clamp(dot(v, v), min=eps)
    return v * torch.sqrt(1.0 / n2)[..., None]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction ``d`` about normal ``n``."""
    return normalize(d - 2.0 * dot(d, n)[..., None] * n)


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Snell refraction; ``n`` faces the incoming side and
    ``eta = n_incident / n_transmit``.  Returns ``(t, tir_mask)``."""
    cos_i = -dot(d, n)
    k = 1.0 - eta ** 2 * (1.0 - cos_i ** 2)
    tir = k <= 0.0
    pos = k > 0.0
    root = torch.where(pos, torch.sqrt(torch.where(pos, k, 1.0)), 0.0)
    t = d * eta[..., None] + n * (eta * cos_i - root)[..., None]
    return normalize(t), tir


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


def to_world(local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Rotate a local-frame direction (z along ``n``) into world space."""
    t, b = orthonormal_frame(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma; used for Russian-roulette survival weighting."""
    return dot(rgb, device_const(_LUMA, rgb.dtype, rgb.device))
