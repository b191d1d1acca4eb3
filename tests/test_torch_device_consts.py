"""The render loop's constants (``core.math.device_const``): built once,
then shared, so no frame copies a host scalar to the device.

On the card a tensor built from a Python number or tuple is a pageable
host-to-device copy after which the host waits for every queued kernel.
Plain PyTorch, no JAX: the ``glass`` preset (414 triangles, the cluster
intersector's plain version) rendered on the CPU through ``api.render``,
with and without ``compact_tail``.

- Over a second frame, the render loop (``core/math.py``,
  ``ops/intersect_kernel.py``, ``ops/dispatch.py``,
  ``integrators/path_tracer.py``) builds no tensor from a host scalar
  (``torch.tensor`` and ``torch.as_tensor`` on a non-tensor, counted by
  their caller's file) and writes no cached tensor in place.
- The cache gives one object per ``(values, dtype, device)``, another
  for another dtype, the bits of ``torch.as_tensor``, and keeps at most
  ``CONST_CACHE_SIZE`` keys, passes a tensor through, and serves autograd
  after a build in inference mode; a render's image is bitwise the
  uncached one.
"""

import collections
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from light_transport_tpu_torch import api
from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.models import presets

torch.set_num_threads(1)

PKG = Path(lm.__file__).resolve().parent.parent
LOOP_FILES = {str(PKG / f) for f in (
    "core/math.py", "ops/intersect_kernel.py", "ops/dispatch.py",
    "integrators/path_tracer.py")}


def _cfg(compact):
    scene, cfg = presets.glass_scene(16, 16, 2, 3, device="cpu")
    if compact:
        cfg = dataclasses.replace(cfg, max_depth=8, compact_tail=True)
    return scene, cfg


@pytest.fixture(scope="module", params=[False, True],
                ids=["trace_paths", "compact_tail"])
def frames(request):
    """Two frames of the glass preset: the second one's host-scalar
    tensor builds by file and line, the cached tensors' versions around
    it, and both images."""
    scene, cfg = _cfg(request.param)
    first = api.render(scene, cfg, seed=7)
    versions = {id(t): (t, t._version) for t in lm._CONSTS.values()}
    builds = collections.Counter()
    real = {name: getattr(torch, name) for name in ("tensor", "as_tensor")}

    def counting(name):
        def build(data, *args, **kwargs):
            where = sys._getframe(1).f_code.co_filename
            if not isinstance(data, torch.Tensor) and where in LOOP_FILES:
                builds[f"{Path(where).name}:{sys._getframe(1).f_lineno}"
                       f" torch.{name}"] += 1
            return real[name](data, *args, **kwargs)
        return build

    with pytest.MonkeyPatch.context() as mp:
        for name in real:
            mp.setattr(torch, name, counting(name))
        second = api.render(scene, cfg, seed=7)
    return dict(first=first, second=second, builds=builds,
                versions=versions, scene=scene, cfg=cfg)


def test_second_frame_builds_no_tensor_and_writes_none(frames):
    assert frames["builds"] == {}
    assert frames["versions"]
    for t, version in frames["versions"].values():
        assert t._version == version
    assert torch.equal(frames["first"], frames["second"])


def test_cache_changes_no_bit_of_the_image(frames, monkeypatch):
    def uncached(values, dtype, device):
        return torch.as_tensor(values, dtype=dtype, device=device)

    monkeypatch.setattr(lm, "device_const", uncached)
    plain = api.render(frames["scene"], frames["cfg"], seed=7)
    assert torch.equal(plain, frames["second"])


def test_cache_keeps_one_object_per_key_with_the_bits_of_as_tensor():
    cpu = torch.device("cpu")
    for values in (1e-5, float("inf"), float("-inf"), 0.1, 399.0, 1,
                   -1.4142, lm._LUMA, (0.1,)):
        a = lm.device_const(values, torch.float32, cpu)
        assert lm.device_const(values, torch.float32, cpu) is a
        assert a.dtype == torch.float32 and a.device == cpu
        want = torch.as_tensor(values, dtype=torch.float32, device=cpu)
        assert a.shape == want.shape
        assert torch.equal(a.view(torch.int32), want.view(torch.int32))
        b = lm.device_const(values, torch.float64, cpu)
        assert b is not a and b.dtype == torch.float64
        assert torch.equal(b, torch.as_tensor(values, dtype=torch.float64))


def test_cache_tells_apart_what_equality_merges():
    cpu = torch.device("cpu")
    neg, pos = (lm.device_const(v, torch.float32, cpu) for v in (-0.0, 0.0))
    assert neg is not pos
    assert math.copysign(1.0, float(neg)) == -1.0
    assert math.copysign(1.0, float(pos)) == 1.0
    nan = lm.device_const(float("nan"), torch.float32, cpu)
    assert lm.device_const(float("nan"), torch.float32, cpu) is nan
    # a tensor is the caller's own: passed through, not cached
    t = torch.linspace(0.0, 1.0, 5)
    n = len(lm._CONSTS)
    assert lm.device_const(t, t.dtype, t.device) is t
    assert len(lm._CONSTS) == n


def test_cache_is_bounded_and_keeps_the_keys_used_last(monkeypatch):
    monkeypatch.setattr(lm, "_CONSTS", collections.OrderedDict())
    cpu = torch.device("cpu")
    kept = lm.device_const(-1.0, torch.float32, cpu)
    for k in range(2 * lm.CONST_CACHE_SIZE):
        lm.device_const(float(k), torch.float32, cpu)
        lm.device_const(-1.0, torch.float32, cpu)  # used last every time
    assert len(lm._CONSTS) == lm.CONST_CACHE_SIZE
    assert lm.device_const(-1.0, torch.float32, cpu) is kept
    first = lm.device_const(0.0, torch.float32, cpu)  # evicted, built anew
    assert torch.equal(first, torch.tensor(0.0))


def test_constant_built_in_inference_mode_serves_autograd(monkeypatch):
    monkeypatch.setattr(lm, "_CONSTS", collections.OrderedDict())
    rgb = torch.tensor([[0.5, 0.25, 2.0]])
    with torch.inference_mode():
        lm.luminance(rgb)
    x = rgb.clone().requires_grad_()
    lm.luminance(x).sum().backward()
    want = torch.tensor([lm._LUMA], dtype=torch.float32)
    assert torch.equal(x.grad, want)
