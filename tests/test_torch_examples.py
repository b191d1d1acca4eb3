"""The port's example drivers (``examples_torch/``) on the CPU at a cut
size, and the scenes they build by hand against the JAX package's.

- Each driver's ``run(...)`` at a few pixels, samples and photons, into
  ``tmp_path``: its JSON lines carry the JAX driver's keys in the JAX
  driver's order (``examples/<name>.py``'s ``report`` calls), every number
  in them is finite, and every PNG it names is there.
- The scenes the drivers build by hand (hard shadow, ray tracing, soft
  shadow at a small ``n_theta``/``n_phi``, the glossy plate) have tables
  (mesh, materials, lights, camera, BVH) bitwise equal to the JAX
  package's scene built with the same arguments, written here with the
  JAX package's modules: no test imports ``examples/*.py`` or
  ``scripts/*.py`` (``examples/_common.py`` turns on a persistent JAX
  compile cache in the importing process).
- Every JAX driver has a port of the same name, with a ``main()`` whose
  device is the card unless ``--device cpu`` is given, and no driver
  imports anything of ``light_transport_tpu``, ``examples`` or
  ``scripts``.
"""

import ast
import math
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from light_transport_tpu.core.config import RenderConfig as JRenderConfig
from light_transport_tpu.scene import cornell as jcornell
from light_transport_tpu.scene import geometry as jgeo
from light_transport_tpu.scene import material as jmat
from light_transport_tpu.scene.scene import Scene as JScene
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.utils import interop
from light_transport_tpu_torch.utils.png import decode_png
from test_torch_analytic import jax_scene_tables
from test_torch_glossy import jax_plate

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples_torch"))
import _torch_common as common  # noqa: E402

# each JSON line's keys, in the order the JAX drivers print them
KEYS = {
    "adaptive_compare": ["spp", "uniform_mse", "adaptive_mse", "mse_ratio",
                         "uniform_seconds", "counts_min", "counts_max"],
    "path_tracer": ["steady_seconds", "mean"],
    "bdpt_light_tracing": ["steady_seconds", "mean", "pt_mean",
                           "abs_mean_diff"],
    "dof_compare": ["focus_cone_center_mse", "focus_cone_border_mse",
                    "focus_near_center_mse", "focus_near_border_mse"],
    "glossy_mis": ["truth_mean", "rmse_ratio", "nee", "mis"],
    "hard_shadow": ["steady_seconds", "mean", "image"],
    "lts_cornell": ["steady_seconds", "mean_plain", "mean_cv",
                    "sample_variance", "images"],
    "lts_cornell_pixel_dive": [],
    "photon_van_de_hulst": ["n_photons", "R_d", "T_t", "R_total", "golden"],
    "photon_mcml_slab": ["n_photons", "R_d", "T_t", "R_total", "golden"],
    "photon_giovanelli": ["n_photons", "R_d", "T_t", "R_total", "golden"],
    "photon_fluence": ["n_photons", "grid", "image"],
    "point_light": ["path", "whitted", "bdpt", "area_path", "mixed_bdpt"],
    "ray_tracing": ["steady_seconds", "tris", "mean", "image"],
    "refraction": ["steady_seconds", "tris", "mean", "image"],
    "sampler_compare": ["spp", "uniform_mse", "sobol_mse",
                        "sobol_progressive_mse", "mse_ratio"],
    "soft_shadow": ["steady_seconds", "tris", "pixels", "spp", "mean",
                    "image", "reference_seconds"],
}

# driver -> its run()'s arguments at the cut size, grouped by what they
# exercise
CUT = {
    "paths": {
        "adaptive_compare": dict(width=8, height=8, spp=4, max_depth=3,
                                 ref_passes=2),
        "sampler_compare": dict(width=8, height=8, spp=4, max_depth=2,
                                ref_passes=2),
        "dof_compare": dict(width=8, height=8, spp=4, max_depth=2),
        "refraction": dict(width=8, height=8, spp=2, max_depth=3),
        "glossy_mis": dict(width=8, height=8, spp=4, max_depth=2,
                           truth_spp=4, truth_seeds=2),
    },
    "bidirectional": {
        "bdpt_cornell": dict(width=6, height=6, spp=2, max_depth=3),
        "point_light": dict(width=6, height=6, spp=2, max_depth=3),
        "lts_cornell": dict(width=8, height=8, spp=2, max_depth=3,
                            pixels=((1, 1), (6, 5)), n_samples=8),
    },
    "meshes": {
        "hard_shadow": dict(width=12, height=12, spp=2),
        "ray_tracing": dict(width=12, height=12, indirect_samples=2),
        "soft_shadow": dict(size=dict(width=8, height=8, spp=2,
                                      max_depth=2), n_theta=8, n_phi=16),
    },
    "photon": {
        "photon_mcml": dict(n_photons=2_000, fluence_grid=(16, 16)),
    },
}


def leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from leaves(v)
    else:
        yield x


@pytest.mark.parametrize("group", sorted(CUT))
def test_drivers_at_a_cut_size(group, tmp_path, capsys):
    for name, kw in CUT[group].items():
        lines = common.load(name).run(**kw, device="cpu",
                                      out_dir=str(tmp_path))
        printed = capsys.readouterr().out
        for line in lines:
            ex = line["example"]
            assert list(line) == ["example", "seconds"] + KEYS[ex], ex
            assert f'"example": "{ex}"' in printed
            for v in leaves([v for k, v in line.items() if k != "example"]):
                if isinstance(v, str):  # the PNGs it wrote
                    assert pathlib.Path(v).parent == tmp_path, (ex, v)
                    assert decode_png(pathlib.Path(v).read_bytes()).ndim == 3
                elif v is not None:
                    assert math.isfinite(v), (ex, line)
    pngs = sorted(p.name for p in tmp_path.iterdir())
    assert pngs and all(p.endswith(".png") for p in pngs), pngs


def jax_hard_shadow(light_half_size, emission):
    """``examples/hard_shadow.py:28-54`` with the JAX package's modules."""
    cone_t = jcornell.cone_triangles(
        radius=1.5, height=3.5, center=(0.0, 0.0, 0.0),
        direction=(0.0, 1.0, 0.0), resolution=48)
    cone = jgeo.TriangleMesh.build(cone_t, np.zeros(len(cone_t), np.int32))
    floor = jgeo.TriangleMesh.build(
        jgeo.quad_triangles((-10, -1.75, -10), (-10, -1.75, 10),
                            (10, -1.75, 10), (10, -1.75, -10)),
        np.asarray([1, 1], np.int32))
    s = light_half_size
    lq = jgeo.quad_triangles((-s + 3, 7.25, -s), (s + 3, 7.25, -s),
                             (s + 3, 7.25, s), (-s + 3, 7.25, s))
    lights = jgeo.TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                                     np.asarray([True, True]))
    P = jmat.presets
    mats = jmat.MaterialTable.build([
        jmat.Material(color=P.TURQUOISE), jmat.Material(color=P.WHITE_2),
        jmat.Material(color=P.WHITE, emission=emission)])
    mesh = jgeo.concat_meshes([cone, floor, lights])
    scene = JScene.build(mesh, mats, camera=[0.0, 0.0, 12.0]).with_bvh()
    return scene, JRenderConfig(width=200, height=200, spp=16, max_depth=2,
                                f_distance=9.6)


def jax_ray_tracing():
    """``examples/ray_tracing.py:30-69`` on its procedural cone, with the
    JAX package's modules."""
    tris = np.asarray(jcornell.cone_triangles(
        radius=2.0, height=3.0, center=(0, 1.5, 0),
        direction=(0.0, -1.0, 0.0), resolution=24), np.float64)
    mid_y = 0.5 * (tris[..., 1].min() + tris[..., 1].max())
    floor_y = tris[..., 1].min() - mid_y
    tris[..., 1] -= mid_y
    body = jgeo.TriangleMesh.build(tris, np.zeros(len(tris), np.int32))
    floor = jgeo.TriangleMesh.build(
        jgeo.quad_triangles((-20, floor_y, -20), (-20, floor_y, 20),
                            (20, floor_y, 20), (20, floor_y, -20)),
        np.asarray([1, 1], np.int32))
    lq = jgeo.quad_triangles((-1.5, 9, -1.5), (1.5, 9, -1.5), (1.5, 9, 1.5),
                             (-1.5, 9, 1.5))
    lights = jgeo.TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                                     np.asarray([True, True]))
    P = jmat.presets
    mats = jmat.MaterialTable.build([
        jmat.Material(color=P.BRONZE, shininess=64, reflection=0.3),
        jmat.Material(color=P.WHITE_2, shininess=128),
        jmat.Material(color=P.WHITE, emission=30.0)])
    mesh = jgeo.concat_meshes([body, floor, lights])
    scene = JScene.build(mesh, mats, camera=[0.0, 0.0, 9.0]).with_bvh()
    return scene, JRenderConfig(width=192, height=192, spp=1, max_depth=2,
                                f_distance=7.0)


def jax_soft_shadow(n_theta, n_phi):
    """``examples/soft_shadow.py:28-46`` with the JAX package's modules."""
    sph = jcornell.sphere_triangles(center=(0, 1, 0), radius=1.5,
                                    n_theta=n_theta, n_phi=n_phi)
    floor = jgeo.quad_triangles((-8, -0.5, -8), (-8, -0.5, 8), (8, -0.5, 8),
                                (8, -0.5, -8))
    lq = jgeo.quad_triangles((-1.5, 6, -1.5), (1.5, 6, -1.5), (1.5, 6, 1.5),
                             (-1.5, 6, 1.5))
    mesh = jgeo.concat_meshes([
        jgeo.TriangleMesh.build(sph, np.zeros(len(sph), np.int32)),
        jgeo.TriangleMesh.build(floor, np.asarray([1, 1], np.int32)),
        jgeo.TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                                np.asarray([True, True])),
    ])
    P = jmat.presets
    mats = jmat.MaterialTable.build([
        jmat.Material(color=P.TURQUOISE), jmat.Material(color=P.WHITE_2),
        jmat.Material(color=P.WHITE, emission=8.0)])
    return JScene.build(mesh, mats, camera=[0.0, 1.0, 7.0]).with_bvh()


# scene -> (the JAX package's scene, the driver's scene on the CPU)
HAND_BUILT = {
    "hard_shadow": (
        lambda: jax_hard_shadow(0.12, 5000.0)[0],
        lambda: common.load("hard_shadow").build_scene(
            0.12, 5000.0, device="cpu")[0]),
    "ray_tracing": (
        lambda: jax_ray_tracing()[0],
        lambda: common.load("ray_tracing").build_scene(device="cpu")[0]),
    "soft_shadow": (
        lambda: jax_soft_shadow(12, 24),
        lambda: common.load("soft_shadow").build_scene(12, 24,
                                                       device="cpu")),
    "glossy_plate": (
        lambda: jax_plate(96, 96, 16, 3)[0],
        lambda: presets.glossy_plate_scene(shininess=400.0,
                                           device="cpu")[0]),
}


@pytest.mark.parametrize("name", sorted(HAND_BUILT))
def test_hand_built_scenes_match_jax(name):
    jax_build, port_build = HAND_BUILT[name]
    theirs = jax_scene_tables(jax_build())
    ours = interop.scene_to_numpy(port_build())
    for table in ("mesh", "materials", "lights"):
        for k, v in theirs[table].items():
            a = ours[table][k]
            assert a.dtype == v.dtype and a.shape == v.shape, (table, k)
            np.testing.assert_array_equal(a, v, err_msg=f"{table}.{k}")
    np.testing.assert_array_equal(ours["camera"], theirs["camera"])
    assert (ours["bvh"] is None) == ("bvh" not in theirs)
    if ours["bvh"] is not None:
        for k, v in theirs["bvh"].items():
            np.testing.assert_array_equal(ours["bvh"][k], v, err_msg=k)


def imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_every_driver_ported_and_on_the_card_by_default():
    jax_drivers = sorted(p.stem for p in (ROOT / "examples").glob("*.py")
                         if not p.stem.startswith("_"))
    assert sorted(common.DRIVERS) == jax_drivers
    here = ROOT / "examples_torch"
    assert sorted(p.stem for p in here.glob("*.py")) == sorted(
        common.DRIVERS + ("_torch_common",))
    for path in here.glob("*.py"):
        for mod in imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("light_transport_tpu", "jax", "examples",
                               "scripts", "_common", "bench_mis_ab"), (
                path.name, mod)
    args = common.parse_args([])
    assert args.device == "cuda"
    assert pathlib.Path(args.out_dir) == ROOT / "artifacts" / "examples_torch"
    assert common.parse_args(["--device", "cpu"]).device == "cpu"
    assert common.load("soft_shadow") is common.load("soft_shadow")
    # photon_mcml holds its runs to the golden values
    check = common.load("photon_mcml").check_golden
    check("van_de_hulst", {"R_d": 0.4161}, {"R_d": 0.41550}, 10 ** 6)
    with pytest.raises(RuntimeError, match="golden"):
        check("van_de_hulst", {"R_d": 0.4185}, {"R_d": 0.41550}, 10 ** 6)
    for name in common.DRIVERS:
        module = common.load(name)
        assert callable(module.main) and callable(module.run), name
        if not torch.cuda.is_available():
            # no fallback: without a card the default device raises
            with pytest.raises((AssertionError, RuntimeError)):
                module.main([])
    assert os.path.isdir(ROOT / "examples")  # the JAX drivers stay
