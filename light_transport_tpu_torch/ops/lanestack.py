"""Per-lane fixed-depth stacks for lockstep deferred-branch traversal.

The counterpart of ``light_transport_tpu.ops.lanestack``: every lane keeps
a stack of ``size`` slots, one ``(N, size, ...)`` tensor per payload field,
and a ``(N,)`` int ``top``.  A push scatters each pushing lane's payload
into slot ``top``; a peek gathers slot ``top - 1``.  Both keep every
field's dtype (bool included) and make no host sync.  Used by
``integrators.path_tracer.trace_paths_split``, whose payload is the
deferred branch's ray, throughput, medium and bounce.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def zeros(payload_example: Sequence[torch.Tensor], size: int
          ) -> Tuple[torch.Tensor, ...]:
    """Empty stacks of ``size`` slots shaped after a payload example of
    ``(N, ...)`` tensors."""
    return tuple(torch.zeros((p.shape[0], size) + tuple(p.shape[1:]),
                             dtype=p.dtype, device=p.device)
                 for p in payload_example)


def _slots(top: torch.Tensor, size: int):
    lanes = torch.arange(top.shape[0], device=top.device)
    return lanes, torch.clamp(top, 0, size - 1).long()


def push(stack, top, lane_mask, payload, size: int):
    """Masked push: lanes in ``lane_mask`` write ``payload`` at their
    ``top`` slot and advance; the others are untouched.  The stack's
    tensors are updated in place and returned with the new ``top``.
    Callers gate ``lane_mask`` on ``top < size`` themselves."""
    if size == 0:  # no slot: the callers' gate leaves no lane to push
        return stack, top
    lanes, idx = _slots(top, size)
    for s, p in zip(stack, payload):
        m = lane_mask.reshape(lane_mask.shape + (1,) * (p.dim() - 1))
        s[lanes, idx] = torch.where(m, p.to(s.dtype), s[lanes, idx])
    return stack, top + lane_mask.to(top.dtype)


def peek(stack, top, size: int):
    """Payload at the top slot.  Lanes with an empty stack read slot 0,
    which holds whatever was last pushed there (a pop only decrements
    ``top``): callers mask the result with their own ``can_pop = top > 0``
    and decrement ``top`` themselves."""
    if size == 0:  # nothing to read: zeros, as JAX's empty select gives
        return tuple(s.new_zeros((s.shape[0],) + tuple(s.shape[2:]))
                     for s in stack)
    lanes, idx = _slots(top - 1, size)
    return tuple(s[lanes, idx] for s in stack)
