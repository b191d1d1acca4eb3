"""Runnable presets: callables returning ``(medium, cfg)`` for the photon
engine or ``(scene, cfg)`` for the render, as the JAX package's presets
do."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from light_transport_tpu_torch.core.config import (
    MediumConfig,
    PhotonRunConfig,
    RenderConfig,
)
from light_transport_tpu_torch.scene.cornell import cornell_box_scene
from light_transport_tpu_torch.scene.medium import LayeredMedium


def demo_homogeneous(device="cuda"):
    """~1e5 photons, homogeneous absorbing/scattering medium, reflectance +
    fluence tallies."""
    medium = LayeredMedium.build(
        [MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)], device=device)
    cfg = PhotonRunConfig(n_photons=100_000, nr=64, nz=64, dr=0.02, dz=0.02)
    return medium, cfg


def hg_sweep(g_values=(0.0, 0.5, 0.9), mu_a_values=(0.1, 1.0, 10.0),
             mu_s_values=(10.0, 90.0), device="cuda"):
    """Anisotropic Henyey-Greenstein sweep in a semi-infinite, index-matched
    medium, 1e5 photons a configuration.  Yields ``(label, medium, cfg)``
    triples, g slowest and mu_s fastest."""
    for g in g_values:
        for mu_a in mu_a_values:
            for mu_s in mu_s_values:
                medium = LayeredMedium.build(
                    [MediumConfig(mu_a=mu_a, mu_s=mu_s, g=g, n=1.0)],
                    device=device)
                cfg = PhotonRunConfig(n_photons=100_000, nr=64, nz=64,
                                      dr=0.02, dz=0.02)
                yield f"g={g}_mua={mu_a}_mus={mu_s}", medium, cfg


def multilayer_mismatch(device="cuda"):
    """Layered slab with refractive-index mismatch (Fresnel/TIR at the
    interfaces, layered fluence depth profile)."""
    medium = LayeredMedium.build(
        [
            MediumConfig(mu_a=1.0, mu_s=100.0, g=0.9, n=1.4, thickness=0.1),
            MediumConfig(mu_a=1.0, mu_s=10.0, g=0.0, n=1.0, thickness=0.1),
            MediumConfig(mu_a=2.0, mu_s=10.0, g=0.7, n=1.37, thickness=0.2),
        ],
        n_above=1.0, n_below=1.0, device=device)
    cfg = PhotonRunConfig(n_photons=200_000, nr=64, nz=100, dr=0.01, dz=0.005)
    return medium, cfg


def full_scale(device="cuda"):
    """1e8 photons into a 512x512 (r,z) grid, a 512x512 exit-detector image
    and a 128^3 absorption volume (0.2 mm pitch, +/-1.28 cm around the beam
    axis and 2.56 cm deep).  The spatial tallies are strided (unbiased
    stratified thinning): the (r,z) grid takes every 32nd step's deposit,
    the volume every 64th; exits, the detector and all counters are exact
    every step.  Dead lanes respawn at every stride window."""
    medium = LayeredMedium.build(
        [MediumConfig(mu_a=0.5, mu_s=50.0, g=0.9, n=1.37)], device=device)
    cfg = PhotonRunConfig(n_photons=100_000_000, nr=512, nz=512,
                          dr=0.005, dz=0.005,
                          detector_nx=512, detector_extent=1.28,
                          vol_nx=128, vol_ny=128, vol_nz=128,
                          vol_dx=0.02, vol_dy=0.02, vol_dz=0.02,
                          tally_stride=32, vol_stride=64,
                          respawn_windows=1)
    return medium, cfg


def mesh_scene(device="cuda"):
    """The LTS Cornell + cone scene at its notebook settings, with a BVH
    (the per-surface detector configuration)."""
    scene, cfg = cornell_box_scene(width=150, height=150, spp=12, max_depth=4,
                                   device=device)
    return scene.with_bvh(), cfg


def lts_scene(device="cuda", **kw):
    """The flagship notebook scene: Cornell box, glass cone, area light."""
    return cornell_box_scene(device=device, **kw)


def point_light_scene(width=150, height=150, spp=12, max_depth=4,
                      device="cuda"):
    """The LTS Cornell box lit by one point (delta) light instead of its
    panel: the panel's emission is 0 (it stays as dark geometry) and a
    bare bulb hangs mid-room at (0, 3, 0) with I = 200, the panel's total
    power (a one-sided Lambertian panel emits pi L A; an isotropic point
    of equal power has I = L A / 4 = 200 * 4 / 4)."""
    scene, cfg = cornell_box_scene(width=width, height=height, spp=spp,
                                   max_depth=max_depth, emission=0.0,
                                   device=device)
    scene = scene.with_point_lights([[0.0, 3.0, 0.0]],
                                    [[200.0, 200.0, 200.0]])
    return scene, cfg


def hard_shadow_scene(width=400, height=400, device="cuda"):
    """The reference's hard_shadow notebook scene, the Whitted golden
    image's: a 2-unit cube at [0, 2]^3 on a green floor (y = -2, x +-52,
    z +-7), the light a tiny emissive quad at (3, 5, 3) (Whitted shades
    from light-row centroids), the camera at (0, 0, 3.5) with the screen
    plane at z = 3, 400x400, depth 3."""
    from light_transport_tpu_torch.scene.geometry import (
        TriangleMesh,
        concat_meshes,
        quad_triangles,
    )
    from light_transport_tpu_torch.scene.material import (
        Material,
        MaterialTable,
        presets,
    )
    from light_transport_tpu_torch.scene.scene import Scene

    # the unit-2 cube, its quad faces fanned like the reference loader
    v = np.array([[0, 2, 2], [0, 0, 2], [2, 0, 2], [2, 2, 2],
                  [0, 2, 0], [0, 0, 0], [2, 0, 0], [2, 2, 0]], np.float64)
    faces = [(0, 1, 2, 3), (7, 6, 5, 4), (3, 2, 6, 7),
             (4, 0, 3, 7), (4, 5, 1, 0), (1, 5, 6, 2)]
    cube_t = np.concatenate(
        [quad_triangles(v[a], v[b], v[c], v[d]) for a, b, c, d in faces])
    cube = TriangleMesh.build(cube_t, np.zeros(len(cube_t), np.int32),
                              device=device)
    floor = TriangleMesh.build(
        quad_triangles((-52, -2, -7), (-52, -2, 7), (52, -2, 7),
                       (52, -2, -7)),
        np.asarray([1, 1], np.int32), device=device)
    s = 0.01  # the notebook's point light as a tiny quad
    lq = quad_triangles((3 - s, 5, 3 - s), (3 + s, 5, 3 - s),
                        (3 + s, 5, 3 + s), (3 - s, 5, 3 + s))
    lights = TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                                np.asarray([True, True]), device=device)
    green = Material(color=presets.GREEN, shininess=90, reflection=0.1)
    source = Material(color=presets.WHITE, shininess=1, reflection=0.9,
                      emission=1.0)
    mats = MaterialTable.build([presets.BRONZE_MAT, green, source],
                               device=device)
    mesh = concat_meshes([cube, floor, lights])
    scene = Scene.build(mesh, mats, camera=[0.0, 0.0, 3.5])
    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=3,
                       f_distance=3.0)
    return scene, cfg


def glass_scene(width=100, height=100, spp=4, max_depth=3, device="cuda"):
    """The whisky glass (body, liquid, ice; 414 triangles with the box)
    standing in the Cornell box, rendered with emission_mode="nee" since
    specular chains carry most of its light."""
    from light_transport_tpu_torch.scene.geometry import concat_meshes
    from light_transport_tpu_torch.scene.glass import (
        design_glass,
        glass_materials,
    )
    from light_transport_tpu_torch.scene.cornell import cornell_materials
    from light_transport_tpu_torch.scene.material import MaterialTable
    from light_transport_tpu_torch.scene.scene import Scene

    base, cfg = cornell_box_scene(width=width, height=height, spp=spp,
                                  max_depth=max_depth, include_cone=False,
                                  device=device)
    cfg = dataclasses.replace(cfg, emission_mode="nee")
    dim = 7.5
    # scale the tumbler into the box and stand its base on the floor
    glass = design_glass(mat_offset=5, device=device).scaled(0.85)
    y_min = float(glass.vertices()[..., 1].min())
    glass = glass.translated((0.0, -dim + 0.01 - y_min, 0.0))
    mats = MaterialTable.build(cornell_materials() + glass_materials(),
                               device=device)
    mesh = concat_meshes([base.mesh, glass])
    scene = Scene.build(mesh, mats, camera=[0.0, 0.0, dim + 0.5]).with_bvh()
    return scene, cfg


PRESETS: Dict[str, Callable] = {
    "demo": demo_homogeneous,
    "multilayer": multilayer_mismatch,
    "mesh": mesh_scene,
    "full_scale": full_scale,
    "lts": lts_scene,
    "glass": glass_scene,
    "point": point_light_scene,
}
