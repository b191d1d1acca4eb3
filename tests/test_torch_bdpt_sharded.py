"""The sharded BDPT render (``parallel.mesh.render_bdpt_sharded``) on a CPU
mesh against the port's own ``integrators.bdpt.render_bdpt``, on the
cases of JAX's ``tests/test_sharding.py``: the Cornell box at 1, 2 and 8
virtual shards, the point-light scene with 7 pad lanes over 8 shards, the
mixed family, and light tracing off.

The lanes are drawn at full width, so every lane's radiance row is the
unsharded render's bitwise; the splat planes are summed over the shards,
so the image is held within JAX's 5e-6.  No JAX: the port's BDPT is held
against JAX's in ``tests/test_torch_bdpt.py``.
"""

import numpy as np
import pytest
import torch

from light_transport_tpu_torch.integrators import bdpt as B
from light_transport_tpu_torch.models.presets import point_light_scene
from light_transport_tpu_torch.parallel import mesh as pm
from light_transport_tpu_torch.scene.cornell import cornell_box_scene

torch.set_num_threads(1)

ATOL = 5e-6  # tests/test_sharding.py:76


def cornell():
    return cornell_box_scene(width=12, height=12, spp=2, max_depth=3,
                             device="cpu")


@pytest.fixture
def captured(monkeypatch):
    """The radiance rows and splat plane each render hands to
    ``_bdpt_assemble``, in call order."""
    calls = []
    orig = B._bdpt_assemble

    def spy(cfg, radiance, splat):
        calls.append((radiance, splat))
        return orig(cfg, radiance, splat)

    monkeypatch.setattr(B, "_bdpt_assemble", spy)
    return calls


def check(scene, cfg, seed, shards, captured, light_tracing=True):
    ref = B.render_bdpt(scene, cfg, seed, light_tracing=light_tracing)
    got = pm.render_bdpt_sharded(scene, cfg, seed,
                                 mesh=pm.make_mesh(shards, device_type="cpu"),
                                 light_tracing=light_tracing)
    (r_rad, r_splat), (s_rad, s_splat) = captured
    assert torch.equal(s_rad, r_rad)
    np.testing.assert_allclose(s_splat.numpy(), r_splat.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    assert got.shape == (cfg.height, cfg.width, 3)
    return got, r_splat


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_cornell_matches_unsharded(shards, captured):
    """Area family, 288 lanes; one shard is the unsharded render
    bitwise."""
    scene, cfg = cornell()
    got, splat = check(scene, cfg, 5, shards, captured)
    assert float(splat.abs().sum()) > 0.0  # light tracing splatted
    if shards == 1:
        assert torch.equal(got, B.render_bdpt(scene, cfg, 5))


def test_point_lights_pad_lanes(captured, monkeypatch):
    """Point family on 13*5*1 = 65 lanes over 8 shards: 7 pad lanes with
    ``mask`` False, zero uniforms and direction (0, 0, 1), which neither
    splat nor reach the radiance rows."""
    scene, cfg = point_light_scene(width=13, height=5, spp=1, max_depth=3,
                                   device="cpu")
    shards = []
    orig = B._bdpt_body

    def spy(scene_, cfg_, lanes, *a):
        shards.append(lanes)
        return orig(scene_, cfg_, lanes, *a)

    monkeypatch.setattr(B, "_bdpt_body", spy)
    check(scene, cfg, 6, 8, captured)
    assert [s["o"].shape[0] for s in shards] == [65] + [9] * 8
    last = shards[-1]
    pad = ~last["mask"]
    assert int(pad.sum()) == 7 and not pad[:2].any()
    assert torch.equal(last["d"][pad],
                       torch.tensor([[0.0, 0.0, 1.0]]).expand(7, 3))
    for k, v in last.items():
        if k not in ("mask", "d"):
            assert not v[pad].any(), k
    # the pad lanes alone splat nothing
    pad_only = {k: v[pad] for k, v in last.items()}
    mode, q_point = B._light_family(scene)
    _, splat = orig(scene, cfg, pad_only, None, True, mode, q_point)
    assert not splat.any()


def test_mixed_family_matches_unsharded(captured):
    """Area and point lights: the per-lane family pick and its MIS
    densities ride the shard (3 shards, 288 lanes)."""
    scene, cfg = cornell()
    scene = scene.with_point_lights([[0.0, 3.0, 0.0]], [[30.0, 30.0, 30.0]])
    assert B._light_family(scene)[0] == "mixed"
    check(scene, cfg, 7, 3, captured)


def test_light_tracing_off(captured):
    """``light_tracing=False`` reaches every shard: no splat at all."""
    scene, cfg = cornell()
    _, splat = check(scene, cfg, 8, 2, captured, light_tracing=False)
    assert not captured[1][1].any() and not splat.any()


def test_mesh_on_another_device_raises():
    """Every shard traces on the scene's device."""
    scene, cfg = cornell()
    mesh = pm.Mesh(devices=(torch.device("meta"),))
    with pytest.raises(ValueError, match="scene's device"):
        pm.render_bdpt_sharded(scene, cfg, 0, mesh=mesh)
