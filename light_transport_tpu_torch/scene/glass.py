"""Whisky-glass demo scene.

The counterpart of ``light_transport_tpu.scene.glass``: a glass body tube
(radius 6->7, height 12), a base cylinder (r=7, h=1), a whisky liquid
cylinder (r=6, h=8) and a 5-unit ice cube, with GLASS_MAT body and base,
whisky (YELLOW, ior 1.356, transmission 0.75) and ice (WHITE, ior 1.310).
"""

from __future__ import annotations

import numpy as np

from light_transport_tpu_torch.scene.geometry import (
    TriangleMesh,
    concat_meshes,
    quad_triangles,
)
from light_transport_tpu_torch.scene.material import Material, presets


def cylinder_triangles(radius, height, center, resolution=24, capped=True):
    """Capped cylinder around the y axis (the reference's
    direction=[0,1,0] convention).  Wound so every normal points OUT of
    the solid — the convention the tracer's inside/outside test
    (path_tracer: ``inside = dot(n_geo, dir) > 0``) and the interior-media
    logic rely on (inward winding would invert the IOR ratio and the
    Beer-Lambert attribution on every interface)."""
    cx, cy, cz = center
    ang = 2 * np.pi * np.arange(resolution) / resolution
    x = radius * np.cos(ang)
    z = radius * np.sin(ang)
    y0, y1 = cy - height / 2.0, cy + height / 2.0
    tris = []
    for i in range(resolution):
        j = (i + 1) % resolution
        a = (cx + x[i], y0, cz + z[i])
        b = (cx + x[j], y0, cz + z[j])
        c = (cx + x[j], y1, cz + z[j])
        d = (cx + x[i], y1, cz + z[i])
        tris.append([a, c, b])
        tris.append([a, d, c])
    if capped:
        bot = (cx, y0, cz)
        top = (cx, y1, cz)
        for i in range(resolution):
            j = (i + 1) % resolution
            tris.append([bot, (cx + x[i], y0, cz + z[i]), (cx + x[j], y0, cz + z[j])])
            tris.append([top, (cx + x[j], y1, cz + z[j]), (cx + x[i], y1, cz + z[i])])
    return np.asarray(tris, dtype=np.float64)


def tube_triangles(r_in, r_out, height, center, resolution=24):
    """Annular tube (inner + outer walls + top/bottom rings) — the glass
    body, standing in for pyvista's CylinderStructured surface."""
    cx, cy, cz = center
    ang = 2 * np.pi * np.arange(resolution) / resolution
    y0, y1 = cy - height / 2.0, cy + height / 2.0
    tris = []
    # normals point OUT of the annular material: the outer wall radially
    # out, the inner wall radially in (toward the axis, into the cavity)
    for r, flip in ((r_out, True), (r_in, False)):
        x = r * np.cos(ang)
        z = r * np.sin(ang)
        for i in range(resolution):
            j = (i + 1) % resolution
            a = (cx + x[i], y0, cz + z[i])
            b = (cx + x[j], y0, cz + z[j])
            c = (cx + x[j], y1, cz + z[j])
            d = (cx + x[i], y1, cz + z[i])
            if flip:
                tris += [[a, c, b], [a, d, c]]
            else:
                tris += [[a, b, c], [a, c, d]]
    # annular rings: bottom faces -y, top faces +y
    xi = r_in * np.cos(ang)
    zi = r_in * np.sin(ang)
    xo = r_out * np.cos(ang)
    zo = r_out * np.sin(ang)
    for y, down in ((y0, True), (y1, False)):
        for i in range(resolution):
            j = (i + 1) % resolution
            a = (cx + xi[i], y, cz + zi[i])
            b = (cx + xi[j], y, cz + zi[j])
            c = (cx + xo[j], y, cz + zo[j])
            d = (cx + xo[i], y, cz + zo[i])
            if down:
                tris += [[a, c, b], [a, d, c]]
            else:
                tris += [[a, b, c], [a, c, d]]
    return np.asarray(tris, dtype=np.float64)


def box_triangles(center, lengths):
    cx, cy, cz = center
    hx, hy, hz = (l / 2.0 for l in lengths)
    a = (cx - hx, cy - hy, cz - hz)
    b = (cx - hx, cy - hy, cz + hz)
    c = (cx + hx, cy - hy, cz + hz)
    d = (cx + hx, cy - hy, cz - hz)
    e = (cx - hx, cy + hy, cz - hz)
    f = (cx - hx, cy + hy, cz + hz)
    g = (cx + hx, cy + hy, cz + hz)
    h = (cx + hx, cy + hy, cz - hz)
    # outward winding (see cylinder_triangles): reversed vertex order
    # relative to the original inward quads
    quads = [(d, c, b, a), (e, f, g, h), (b, f, e, a),
             (h, g, c, d), (c, g, f, b), (e, h, d, a)]
    return np.concatenate([quad_triangles(*q) for q in quads])


# material rows appended by design_glass, in order
GLASS_BODY = 0
WHISKY = 1
ICE = 2


def glass_materials():
    """GLASS_MAT / whisky / ice materials (examples/obj/glass.py:21-23)."""
    return [
        presets.GLASS_MAT,
        Material(color=presets.YELLOW, shininess=1, reflection=0.9,
                 ior=1.356, transmission=0.75, is_diffuse=False),
        Material(color=presets.WHITE, shininess=1, reflection=0.9,
                 ior=1.310, transmission=1.0, is_diffuse=False),
    ]


def design_glass(resolution: int = 24, mat_offset: int = 0,
                 device="cuda") -> TriangleMesh:
    """The whisky glass: body tube + base + liquid + ice cube.

    ``mat_offset`` shifts the three material ids so the mesh can be merged
    into a scene whose MaterialTable has other rows first.
    """
    body = tube_triangles(6.0, 7.0, 12.0, (0, 6.5, 0), resolution)
    base = cylinder_triangles(7.0, 1.0, (0, 0.0, 0), resolution)
    liquid = cylinder_triangles(6.0, 8.0, (0, 4.5, 0), resolution)
    ice = box_triangles((0, 3.0, 0), (5, 5, 5))
    parts = [
        (body, GLASS_BODY), (base, GLASS_BODY),
        (liquid, WHISKY), (ice, ICE),
    ]
    meshes = [
        TriangleMesh.build(v, np.full(len(v), mat_offset + m, np.int32),
                           device=device)
        for v, m in parts
    ]
    return concat_meshes(meshes)
