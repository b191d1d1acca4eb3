"""Procedural scenes: Cornell box, cone, sphere, floor.

The counterpart of ``light_transport_tpu.scene.cornell``, the same
triangles from the same numpy code: a Cornell box of half-extent ``dim``
with a 4-panel top wall leaving a 2x2 light cutout, two emissive triangles
in the cutout, and a glass cone in the middle.
"""

from __future__ import annotations

import numpy as np

from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.scene.geometry import TriangleMesh, quad_triangles
from light_transport_tpu_torch.scene.material import (
    Material,
    MaterialTable,
    presets,
)
from light_transport_tpu_torch.scene.scene import Scene


def cornell_box_triangles(dim: float):
    """The 5 walls (top wall as 4 panels with a 2x2 cutout).

    Returns (verts (16,3,3), wall_kind (16,) with 0=surface,1=left,2=right).
    """
    d = float(dim)
    a = (-d, -d, -d)
    b = (-d, -d, d)
    c = (d, -d, d)
    dd = (d, -d, -d)
    e = (-d, d, -d)
    f = (-d, d, d)
    g = (d, d, d)
    h = (d, d, -d)

    quads = [
        ((dd, c, g, h), 2),  # right wall (src/cornell_box.py:22)
        ((f, b, a, e), 1),  # left wall (:39)
        ((e, a, dd, h), 0),  # back wall (:56)
        ((a, b, c, dd), 0),  # bottom (:73)
    ]
    # top-wall panels around the 2x2 light cutout (:89-164)
    i = (-1, d, -d)
    j = (-1, d, -1)
    k = (-1, d, 1)
    l = (-1, d, d)
    m = (1, d, d)
    n = (1, d, 1)
    o = (1, d, -1)
    p = (1, d, -d)
    quads += [
        ((h, g, m, p), 0),
        ((n, m, l, k), 0),
        ((p, o, j, i), 0),
        ((i, l, f, e), 0),
    ]
    verts = np.concatenate([quad_triangles(*q) for q, _ in quads])
    kind = np.repeat([kk for _, kk in quads], 2)
    return verts, kind


def light_triangles(dim: float):
    """The two emissive triangles filling the top cutout (LTS.ipynb cell 16)."""
    d = float(dim)
    tri1 = np.asarray([[-1, d, -1], [1, d, 1], [-1, d, 1]], dtype=np.float64)
    tri2 = np.asarray([[-1, d, -1], [1, d, -1], [1, d, 1]], dtype=np.float64)
    return np.stack([tri1, tri2])


def cone_triangles(radius=2.0, height=5.0, center=(0.0, 0.0, 0.0),
                   direction=(1.0, 0.0, 0.0), resolution=6):
    """Triangulated capped cone, matching pyvista's ``pv.Cone`` defaults as
    used in LTS.ipynb cell 11 (apex-fan sides + fan-triangulated base)."""
    center = np.asarray(center, dtype=np.float64)
    direction = np.asarray(direction, dtype=np.float64)
    direction = direction / np.linalg.norm(direction)
    apex = center + direction * (height / 2.0)
    base_center = center - direction * (height / 2.0)
    # frame perpendicular to direction
    up = np.array([0.0, 0.0, 1.0]) if abs(direction[2]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(direction, up)
    u /= np.linalg.norm(u)
    v = np.cross(direction, u)
    ang = 2 * np.pi * np.arange(resolution) / resolution
    ring = base_center + radius * (np.outer(np.cos(ang), u) + np.outer(np.sin(ang), v))
    tris = []
    for t in range(resolution):
        t2 = (t + 1) % resolution
        tris.append([apex, ring[t], ring[t2]])  # side
    for t in range(1, resolution - 1):
        tris.append([ring[0], ring[t], ring[t + 1]])  # base fan
    return np.asarray(tris, dtype=np.float64)


def sphere_triangles(center=(0.0, 0.0, 0.0), radius=1.0, n_theta=16,
                     n_phi=32):
    """UV-sphere triangulation.

    Scene-level counterpart of the reference's ``Sphere`` primitive
    (src/primitives.py:41-52) — the analytic ray-sphere test lives in
    ops/intersect.sphere_intersect; meshes keep the render path uniform.
    """
    center = np.asarray(center, np.float64)
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    pts = np.zeros((n_theta + 1, n_phi, 3))
    pts[..., 0] = np.sin(th)[:, None] * np.cos(ph)[None, :]
    pts[..., 1] = np.cos(th)[:, None] * np.ones_like(ph)[None, :]
    pts[..., 2] = np.sin(th)[:, None] * np.sin(ph)[None, :]
    pts = center + radius * pts
    tris = []
    for i in range(n_theta):
        for j in range(n_phi):
            j2 = (j + 1) % n_phi
            a, b = pts[i, j], pts[i, j2]
            c, d = pts[i + 1, j2], pts[i + 1, j]
            if i > 0:  # skip degenerate pole quads' zero-area half
                tris.append([a, b, c])
            if i < n_theta - 1:
                tris.append([a, c, d])
    return np.asarray(tris, dtype=np.float64)


def floor_triangles(x_dim, y_dim, z_dim):
    """Reference ``get_floor`` (src/cornell_box.py:195-222)."""
    a = (-x_dim, -y_dim, -z_dim)
    b = (-x_dim, -y_dim, z_dim)
    c = (x_dim, -y_dim, z_dim)
    d = (x_dim, -y_dim, -z_dim)
    return quad_triangles(a, b, c, d)


def cornell_materials(emission: float = 200.0, cone_material=None):
    """The five LTS Cornell material rows in mesh-id order: surface, left
    (red), right (green), cone glass, emissive source (LTS.ipynb cell 13).
    Shared by the lts and glass presets so the definitions cannot drift."""
    glass = cone_material if cone_material is not None else presets.GLASS_MAT
    return [
        Material(color=presets.WHITE_2, shininess=30, reflection=0.1,
                 ior=1.5210, transmission=1),
        Material(color=presets.RED, shininess=30, reflection=0.1,
                 ior=1.5210, transmission=1),
        Material(color=presets.GREEN, shininess=30, reflection=0.1,
                 ior=1.5210, transmission=1),
        glass,
        Material(color=presets.WHITE, shininess=1, reflection=0.9,
                 ior=1.5, emission=emission),
    ]


def cornell_box_scene(
    dim: float = 7.5,
    width: int = 150,
    height: int = 150,
    spp: int = 12,
    max_depth: int = 4,
    emission: float = 200.0,
    include_cone: bool = True,
    cone_material: Material = None,
    dtype=np.float32,
    device="cuda",
):
    """The flagship LTS parity scene: Cornell box + glass cone + area light.

    Material values match LTS.ipynb cells 14-16: calcium-sulphate-ish walls
    (ior 1.5210, transmission=1 but is_diffuse=True so they shade diffuse),
    GLASS_MAT cone, emissive source material with emission=200.  ``dim``
    defaults to the notebook's derived depth = cone half-extent 2.5 + 5.

    Returns ``(scene, render_config)``.
    """
    glass = cone_material if cone_material is not None else presets.GLASS_MAT
    mats = MaterialTable.build(cornell_materials(emission, glass), dtype=dtype,
                               device=device)
    MAT_SURFACE, MAT_LEFT, MAT_RIGHT, MAT_GLASS, MAT_SOURCE = range(5)

    wall_verts, wall_kind = cornell_box_triangles(dim)
    wall_ids = np.where(wall_kind == 1, MAT_LEFT,
                        np.where(wall_kind == 2, MAT_RIGHT, MAT_SURFACE))
    verts = [wall_verts]
    ids = [wall_ids]
    lights = [np.zeros(len(wall_verts), dtype=bool)]
    if include_cone:
        cone = cone_triangles()
        verts.append(cone)
        ids.append(np.full(len(cone), MAT_GLASS, dtype=np.int32))
        lights.append(np.zeros(len(cone), dtype=bool))
    lv = light_triangles(dim)
    verts.append(lv)
    ids.append(np.full(len(lv), MAT_SOURCE, dtype=np.int32))
    lights.append(np.ones(len(lv), dtype=bool))

    mesh = TriangleMesh.build(
        np.concatenate(verts),
        np.concatenate(ids),
        np.concatenate(lights),
        dtype=dtype,
        device=device,
    )
    camera = np.asarray([0.0, 0.0, dim + 0.5], dtype=dtype)  # LTS.ipynb cell 18
    scene = Scene.build(mesh, mats, camera, dtype=dtype)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth, f_distance=float(dim))
    return scene, cfg
