"""Padded 2-D Sobol' points with hash-based Owen scrambling: the
``sampler="sobol"`` random inputs of the path tracer.

The counterpart of ``light_transport_tpu.ops.qmc``, bit for bit: the same
seed bits give the same uint32 values, so the same floats, as JAX's.
Each consecutive slot pair of a bounce (BSDF, light surface, pick and
roulette, medium) and the pixel jitter is a base-2 (0,2)-sequence; every
(pixel, pair) gets its own index shuffle and value scrambles (Burley,
"Practical Hash-based Owen Scrambling", JCGT 9(4), 2020).

The uint32 arithmetic runs in int64 tensors holding values in [0, 2^32),
masked with ``& 0xFFFFFFFF`` after every add, left shift and multiply:
torch has no uint32 right shift on the CPU.  A product of two 32-bit
values would pass int64's sign bit, so :func:`_mul` multiplies by the
constant's two 16-bit halves, whose products stay below 2^48.

Arguments ``pixel`` and ``sample`` are int tensors of broadcastable
shapes; ``pair`` and ``seed`` are Python ints.  The build is plain
PyTorch on the tensors' device: in JAX it is fused XLA, not a TPU
kernel.
"""

from __future__ import annotations

import torch

from light_transport_tpu_torch.core import rng as _rng

__all__ = [
    "sobol2d",
    "owen_scramble",
    "scrambled_pair",
    "lane_uniforms",
    "render_uniforms",
    "render_pair",
    "seed_bits",
]

M32 = 0xFFFFFFFF
# the fold_seed index of the seed bits (ASCII "Sobo")
SEED_TAG = 0x536F626F

# Sobol' dimension 1's generator-matrix columns, MSB-aligned: the Pascal
# matrix mod 2 by the recurrence v ^= v >> 1 (dimension 0 is the
# bit reversal)
_V1 = []
_v = 1 << 31
for _k in range(32):
    _V1.append(_v)
    _v ^= _v >> 1
del _v, _k


def seed_bits(seed: int) -> int:
    """The uint32 seed of a Sobol' render of ``seed``:
    ``core.rng.fold_seed(seed, SEED_TAG) & 0xFFFFFFFF``.  It stands where
    JAX takes ``jax.random.bits(key)`` of the render's key; the two
    packages draw different seed bits from one seed, and the same points
    from the same bits."""
    return _rng.fold_seed(seed, SEED_TAG) & M32


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _mul(x, c: int):
    """``x * c mod 2^32`` for ``x`` in [0, 2^32) and a constant ``c``."""
    if not isinstance(x, torch.Tensor):
        return (x * c) & M32
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _gf2_matvec(idx: torch.Tensor, cols) -> torch.Tensor:
    """y = M @ idx over GF(2): the XOR of the columns idx's bits pick."""
    y = torch.zeros_like(idx)
    for k in range(32):
        y = y ^ (((idx >> k) & 1) * cols[k])
    return y


def _reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & M32


def _laine_karras(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The LSB-up hash permutation (Burley 2020, listing 3's constants):
    each bit is perturbed only by lower bits."""
    x = (x + seed) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul(x, c)
    return x


def owen_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Nested uniform scramble of an MSB-first fraction (applied to a
    sample index: a shuffle that keeps aligned blocks)."""
    return _reverse_bits(_laine_karras(_reverse_bits(x), seed))


def _mix(x):
    """32-bit finalizer (lowbias32-style avalanche)."""
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash(a, b, c, d):
    """Seed-domain hash of (pixel, pair, seed, tag) -> uint32."""
    h = _mix(_u32(a) ^ 0x9E3779B9)
    h = _mix((h + _mul(_u32(b), 0x9E3779B9)) & M32)
    h = _mix((h + _mul(_u32(c), 0x85EBCA6B)) & M32)
    return _mix((h + _mul(_u32(d), 0xC2B2AE35)) & M32)


def sobol2d(idx: torch.Tensor):
    """Raw 32-bit Sobol' dimensions 0 and 1 at ``idx``: two MSB-first
    fractions.  First points: (0,0), (.5,.5), (.25,.75), (.75,.25), ..."""
    idx = _u32(idx)
    return _reverse_bits(idx), _gf2_matvec(idx, _V1)


def _to_unit(x: torch.Tensor, dtype) -> torch.Tensor:
    """The top 24 bits as a float in [tiny, 1) (exact in float32)."""
    f = (x >> 8).to(dtype) * (1.0 / (1 << 24))
    return torch.clamp(f, min=torch.finfo(dtype).tiny)


def scrambled_pair(pixel, sample, pair: int, seed: int,
                   dtype=torch.float32):
    """One padded Owen-scrambled Sobol' 2-D point per lane: the sample
    index shuffled, then each axis scrambled, all by hashes of
    ``(pixel, pair, seed)``."""
    shuffle = _hash(pixel, pair, seed, 0)
    sx = _hash(pixel, pair, seed, 1)
    sy = _hash(pixel, pair, seed, 2)
    x, y = sobol2d(owen_scramble(_u32(sample), shuffle))
    return (_to_unit(owen_scramble(x, sx), dtype),
            _to_unit(owen_scramble(y, sy), dtype))


def _scrambled_x(pixel, sample, pair: int, seed: int, dtype=torch.float32):
    """:func:`scrambled_pair`'s x alone (Sobol' dimension 0 is the bit
    reversal), for the last slot of a bounce, whose y is unused."""
    shuffle = _hash(pixel, pair, seed, 0)
    sx = _hash(pixel, pair, seed, 1)
    x = _reverse_bits(owen_scramble(_u32(sample), shuffle))
    return _to_unit(owen_scramble(x, sx), dtype)


# slot pairs a bounce: (BSDF0, BSDF1), (LIGHT0, LIGHT1), (PICK, RR),
# (MED, unused); pair 0 is the pixel jitter
_PAIRS_PER_BOUNCE = 4
# the thin lens's pair, above every bounce's pair at any depth
LENS_PAIR = 1 << 16


def _uniforms(seed: int, pixel, sample, max_depth: int, dtype):
    """``(u_aa (..., 2), uniforms (..., max_depth, NUM_U))`` over the
    broadcast shape of ``pixel`` and ``sample``."""
    assert _rng.NUM_U == 2 * _PAIRS_PER_BOUNCE - 1
    u_aa = torch.stack(scrambled_pair(pixel, sample, 0, seed, dtype), dim=-1)
    slots = []
    for b in range(max_depth):
        for p in range(_PAIRS_PER_BOUNCE - 1):
            slots.extend(scrambled_pair(
                pixel, sample, 1 + b * _PAIRS_PER_BOUNCE + p, seed, dtype))
        slots.append(_scrambled_x(
            pixel, sample, 1 + b * _PAIRS_PER_BOUNCE + _PAIRS_PER_BOUNCE - 1,
            seed, dtype))
    u = torch.stack(slots, dim=-1)
    return u_aa, u.reshape(u.shape[:-1] + (max_depth, _rng.NUM_U))


def lane_uniforms(seed: int, pixel: torch.Tensor, sample: torch.Tensor,
                  max_depth: int, dtype=torch.float32):
    """The random inputs of lanes at any ``(pixel, sample)`` pairs, each
    (N,): ``(u_aa (N, 2), uniforms (N, max_depth, NUM_U))``.  A point
    depends only on (seed, pixel, sample), so the adaptive renderer
    resumes each pixel's own sequence at its running count."""
    u_aa, u = _uniforms(seed, pixel, sample, max_depth, dtype)
    return u_aa.reshape(-1, 2), u.reshape(-1, max_depth, _rng.NUM_U)


def _render_grid(height: int, width: int, spp: int, sample_offset: int,
                 device):
    """The s-major lanes' (1, H*W) pixel ids and (spp, 1) sample ids: the
    hashes run once a pixel, the rest once a lane."""
    pixel = torch.arange(height * width, device=device)[None, :]
    sample = (sample_offset + torch.arange(spp, device=device))[:, None]
    return pixel, sample


def render_uniforms(seed: int, height: int, width: int, spp: int,
                    max_depth: int, dtype=torch.float32,
                    sample_offset: int = 0, device="cuda"):
    """A render's random inputs in the path tracer's s-major lane layout
    (lane ``s * H * W + pixel``): ``(u_aa (N, 2), uniforms (N, max_depth,
    NUM_U))``, in (0, 1) like the uniform draws they replace.  The render
    covers samples ``[sample_offset, sample_offset + spp)`` of each
    pixel's sequence, so passes at one seed continue one point set."""
    pixel, sample = _render_grid(height, width, spp, sample_offset, device)
    u_aa, u = _uniforms(seed, pixel, sample, max_depth, dtype)
    return u_aa.reshape(-1, 2), u.reshape(-1, max_depth, _rng.NUM_U)


def render_pair(seed: int, height: int, width: int, spp: int, pair: int,
                dtype=torch.float32, sample_offset: int = 0, device="cuda"):
    """One slot pair (the thin lens's ``LENS_PAIR``) of every lane of a
    render, s-major: ``(N, 2)``."""
    pixel, sample = _render_grid(height, width, spp, sample_offset, device)
    x, y = scrambled_pair(pixel, sample, pair, seed, dtype)
    return torch.stack([x, y], dim=-1).reshape(-1, 2)
