"""The plain reference against the program's plain CPU route, whole
frames of small cuts of each configuration: the same pixels."""

import json

import numpy as np
import pytest
import torch

import tiny
from tiny import REPO
from ltbench.reference.light_order import light_order
from ltbench.registry import Registry

CELLS = ["soft_shadow_123k.frames_d3", "soft_shadow_123k.frames_d8_compact"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _session(reg, cell):
    spec = reg.cell(cell)
    traffic = reg.traffic(spec["traffic"])
    return reg.module("entries", traffic["entry"]).Session(
        reg, reg.config(spec["config"]), traffic, "cpu")


def _whole_frame(sess, seed):
    got = sess.job(seed).reshape(1, -1, 3)
    ids = torch.arange(sess.pixels)
    return sess.compare(got, sess.reference_pixels([seed], ids))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_the_plain_route(root, cell):
    reg = Registry(root)
    numbers = _whole_frame(_session(reg, cell), 12345)
    assert numbers["pixels_off"] == 0.0
    assert numbers["gap_p95"] < 1e-6


def test_reference_matches_the_cull_and_gather_route(tmp_path):
    """From 16 clusters of 512 triangles the program culls and gathers (K4
    on the card): the sphere at 88 x 176 bands (30,628 triangles)."""
    reg = Registry(tiny.make_root(tmp_path))
    cfg = tiny.tiny_config("soft_shadow_123k")
    cfg["shapes"][0].update(n_theta=88, n_phi=176)
    (reg.root / reg.config_entry("soft_shadow_123k")["file"]).write_text(
        json.dumps(cfg))
    numbers = _whole_frame(_session(reg, "soft_shadow_123k.frames_d3"), 777)
    assert numbers["pixels_off"] == 0.0
    assert numbers["gap_p95"] < 1e-6


def test_reference_matches_the_treelet_route(root, monkeypatch):
    """The route of the program's large meshes, in plain form: treelet
    tables and one sorted walk a query, forced below the crossover."""
    from light_transport_tpu_torch.ops import dispatch
    from light_transport_tpu_torch.scene import scene as scene_mod

    monkeypatch.setattr(dispatch, "MXU_MAX_TRIS", 64)
    monkeypatch.setattr(scene_mod, "_auto_treelet", lambda s: True)
    sess = _session(Registry(root), "soft_shadow_123k.frames_d3")
    assert sess.scene.treelet is not None
    numbers = _whole_frame(sess, 4242)
    assert numbers["pixels_off"] == 0.0
    assert numbers["gap_p95"] < 1e-6


def _program_lights(root, cut):
    """A scene's triangles, its light flags and the program's light table:
    a small cut, the configuration as it is run, or 146 light triangles
    scattered among 3,000, where the order of the partition's swaps shows
    (a stable partition orders 4 of them otherwise)."""
    if cut != "scattered":
        sess = _session(Registry(root if cut == "tiny" else REPO),
                        "soft_shadow_123k.frames_d3")
        return sess.arrays.vertices, sess.arrays.is_light, sess.scene.lights
    from light_transport_tpu_torch.scene.geometry import TriangleMesh
    from light_transport_tpu_torch.scene.material import MaterialTable
    from light_transport_tpu_torch.scene.scene import Scene

    from ltbench.entries.render import _material

    rng = np.random.default_rng(0)
    verts = rng.normal(size=(3000, 3, 3))
    is_light = rng.random(3000) < 0.05
    cfg = tiny.tiny_config("soft_shadow_123k")
    mats = MaterialTable.build([_material(m) for m in cfg["materials"]],
                               device="cpu")
    mesh = TriangleMesh.build(verts, np.where(is_light, 2, 0), is_light,
                              device="cpu")
    scene = Scene.build(mesh, mats, camera=cfg["camera"]).with_bvh()
    return verts, is_light, scene.lights


@pytest.mark.parametrize("cut", ["tiny", "full", "scattered"])
def test_light_order_follows_the_program(root, cut):
    """The reference's own light order is the program's light table's."""
    verts, is_light, table = _program_lights(root, cut)
    order = light_order(verts, is_light)
    assert sorted(order) == list(range(int(is_light.sum())))
    lights = verts[np.nonzero(is_light)[0]][order]
    np.testing.assert_array_equal(lights[:, 0].astype(np.float32),
                                  table.v0.numpy())
