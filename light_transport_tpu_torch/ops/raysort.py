"""Coherence sorting for ray batches.

The counterpart of ``light_transport_tpu.ops.raysort``.  The cluster cull
(``ops.intersect_kernel``) works per 128-ray tile: a tile pays for the
union of its rays' cluster footprints.  Bounce and shadow rays arrive in
pixel order, so lanes are sorted by a direction-major locality key before
intersecting and the result is un-permuted after.  The order changes only
what the cull admits, never a result.

Key (30 bits, plus bit 31 for dead lanes):
``[6 bits: direction, 2 per axis][24 bits: origin Morton code, 8 per axis]``.
JAX builds it in uint32; here it is int64, since this torch build has no
uint32 right shift on the CPU.
"""

from __future__ import annotations

import torch

from light_transport_tpu_torch.utils import profiling

# below this lane count tiles are too few for sorting to change the cull
MIN_SORT_LANES = 4096


def _spread3_8(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 8 bits of ``x`` so consecutive bits land 3 apart."""
    x = x & 0xFF
    x = (x | (x << 8)) & 0xF00F
    x = (x | (x << 4)) & 0xC30C3
    x = (x | (x << 2)) & 0x249249
    return x


def scene_bounds(mesh):
    """(lo, hi) box of a TriangleMesh, padded by 0.1; computed once per
    mesh and kept in ``mesh.derived``."""
    if "bounds" not in mesh.derived:
        v0 = mesh.v0
        v1 = v0 + mesh.e1
        v2 = v0 + mesh.e2
        lo = torch.minimum(torch.minimum(v0, v1), v2).amin(dim=0) - 0.1
        hi = torch.maximum(torch.maximum(v0, v1), v2).amax(dim=0) + 0.1
        mesh.derived["bounds"] = (lo, hi)
    return mesh.derived["bounds"]


def ray_sort_key(origins, directions, lo, hi, inactive=None):
    """(N,) int64 direction-major locality key; ``inactive`` lanes get the
    top bit and sort last, into fully dead tiles the cull skips."""
    q = torch.clamp((origins - lo) / (hi - lo), 0.0, 1.0)
    q = (q * 255.0).to(torch.int64)
    m = ((_spread3_8(q[:, 0]) << 2) | (_spread3_8(q[:, 1]) << 1)
         | _spread3_8(q[:, 2]))
    qd = torch.clamp((directions + 1.0) * 0.5 * 3.999, 0.0, 3.0).to(
        torch.int64)
    key = (((qd[:, 0] << 4) | (qd[:, 1] << 2) | qd[:, 2]) << 24) | m
    if inactive is not None:
        key = key | (inactive.to(torch.int64) << 31)
    return key


@profiling.spanned("lt.sort")
def sorted_apply(fn, mesh, origins, directions, *per_ray, inactive=None):
    """Run ``fn(origins, directions, *per_ray)`` on coherence-sorted lanes
    (a stable sort) and return its result, a tensor or a tuple of
    tensors (None entries kept), in input order.  The ``lt.sort`` span
    covers the call, ``fn``'s included, and opens also where a batch under
    ``MIN_SORT_LANES`` goes unsorted."""
    if origins.shape[0] < MIN_SORT_LANES:
        return fn(origins, directions, *per_ray)
    lo, hi = scene_bounds(mesh)
    perm = torch.argsort(
        ray_sort_key(origins, directions, lo, hi, inactive=inactive),
        stable=True)
    out = fn(origins[perm], directions[perm], *(a[perm] for a in per_ray))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    if isinstance(out, torch.Tensor):
        return out[inv]
    parts = [None if x is None else x[inv] for x in out]
    return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
