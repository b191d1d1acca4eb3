"""Faults planted in the program underneath a run, for the checks that the
output comparison catches them: each is a context manager that breaks
the timed path while it is open.

- ``state_unchanged``: the path tracer's bounce returns the state it was
  given (every bounce retraces the camera rays and adds nothing);
- ``half_batch``: half of each pixel's samples left out, the mean taken
  over the rest;
- ``altered_answer``: the intersector's answer altered where it is
  produced: every 8th ray of each nearest-hit query reports no hit.

A one-chip render exchanges nothing between chips, so it has no fault of
a left-out exchange."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patch(mod, attr, make):
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


@contextlib.contextmanager
def state_unchanged():
    from light_transport_tpu_torch.integrators import path_tracer as pt

    def make(orig):
        def bounce(scene, cfg, state, *args, **kw):
            out = orig(scene, cfg, state, *args, **kw)
            return (state,) + tuple(out[1:])
        return bounce

    with _patch(pt, "_bounce", make):
        yield


@contextlib.contextmanager
def half_batch():
    from light_transport_tpu_torch.integrators import path_tracer as pt

    def make(orig):
        def to_image(radiance, cfg):
            samples = radiance.reshape(cfg.spp, cfg.height, cfg.width,
                                       3).permute(1, 2, 0, 3)
            half = samples[:, :, :max(1, cfg.spp // 2)]
            return torch.clamp(half.mean(dim=2), 0.0, 1.0), samples
        return to_image

    with _patch(pt, "_to_image", make):
        yield


@contextlib.contextmanager
def altered_answer():
    from light_transport_tpu_torch.integrators import path_tracer as pt
    from light_transport_tpu_torch.ops import dispatch

    def make(orig):
        def intersect(scene, origins, *args, **kw):
            hit = orig(scene, origins, *args, **kw)
            drop = torch.zeros_like(hit.valid)
            drop[::8] = True
            return hit._replace(
                t=torch.where(drop, float("inf"), hit.t),
                tri=torch.where(drop, -1, hit.tri),
                valid=hit.valid & ~drop)
        return intersect

    with _patch(dispatch, "scene_intersect", make), \
            _patch(pt, "scene_intersect", make):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}
