"""Per-bounce uniform slots of the camera path tracer.

A path is a pure function of its ``(lanes, max_depth, NUM_U)`` uniform
tensor, as in ``light_transport_tpu.core.rng``.  The port draws the tensor
from a ``torch.Generator`` on the device; JAX's threefry stream is not
reproduced, so tests hand both packages the same numbers.
:func:`fold_seed` derives the seeds of a run's parts (supersteps,
progressive passes) from the run's seed.  :func:`logit` and
:func:`sigmoid` map the BSDF slots to and from the control variates'
logit space.
"""

from __future__ import annotations

import numpy as np
import torch

U_BSDF0 = 0  # concentric-disk / first BSDF uniform; also reflect-vs-refract
U_BSDF1 = 1  # second BSDF uniform
U_LIGHT0 = 2  # light-surface barycentric u
U_LIGHT1 = 3  # light-surface barycentric v
U_PICK = 4  # light triangle pick
U_RR = 5  # Russian roulette
U_MED = 6  # interior-medium free-flight distance
NUM_U = 7


def path_uniforms(gen: torch.Generator, lanes: int, max_depth: int,
                  dtype=torch.float32) -> torch.Tensor:
    """The uniform tensor of a path population, ``(lanes, depth, NUM_U)``,
    on ``gen``'s device, in the open interval (0, 1): a zero draw becomes
    the smallest normal float, as JAX draws with ``minval=tiny``."""
    u = torch.rand((lanes, max_depth, NUM_U), generator=gen, dtype=dtype,
                   device=gen.device)
    return u.clamp_(min=torch.finfo(dtype).tiny)


def logit(u: torch.Tensor) -> torch.Tensor:
    """The reference's logit transform of uniforms, ``log(u) - log1p(-u)``
    (JAX's ``core.rng.logit``)."""
    return torch.log(u) - torch.log1p(-u)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The standard sigmoid, the inverse of :func:`logit` (JAX's
    ``core.rng.sigmoid``; the reference's own ``1/(1+exp(x))`` mirrors its
    uniforms, which JAX and the port do not)."""
    return torch.sigmoid(x)


def fold_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed mixed from ``(seed, index)`` by numpy's
    ``SeedSequence`` (the port's stand-in for ``jax.random.fold_in``).
    Every bit depends on both, so torch's CPU generator, which keeps only
    the low 32 bits of its seed, still draws a stream of its own for each
    pair."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF,
                                    int(index) & 0xFFFFFFFFFFFFFFFF])
    return int(state.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF
