"""Wavefront OBJ loading.

The counterpart of ``light_transport_tpu.scene.objio``, after the
reference's ``load_obj`` (src/io.py:11-40): load the faces, give them one
material, and size the scene by the largest |coordinate|.  A parser of
its own (v / f records, the v/vt/vn index syntax, negative indices,
polygon fans) in place of pywavefront.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from light_transport_tpu_torch.scene.geometry import TriangleMesh
from light_transport_tpu_torch.scene.material import Material


def parse_obj(path: str) -> np.ndarray:
    """Parse an OBJ file to a (T, 3, 3) triangle vertex array (float64).
    Polygons with more than 3 vertices are fan-triangulated."""
    vertices = []
    tris = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                vertices.append(
                    (float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    s = tok.split("/")[0]
                    if not s:
                        continue
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                for k in range(1, len(idx) - 1):  # fan
                    tris.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(vertices, dtype=np.float64)
    f = np.asarray(tris, dtype=np.int64)
    if len(f) == 0:
        return np.zeros((0, 3, 3), dtype=np.float64)
    return v[f]


def load_obj(path: str, material: Optional[Material] = None, mat_id: int = 0,
             dtype=torch.float32, device="cuda") -> Tuple[TriangleMesh, float]:
    """Load an OBJ into a TriangleMesh with a single material id on
    ``device``.

    Returns ``(mesh, dimension)`` where dimension = max |coordinate|, the
    reference's scene-sizing rule (src/io.py:24-27).  The material binds
    through the scene's MaterialTable (the reference hard-codes a red
    default, src/io.py:33), so ``material`` is not used here."""
    del material
    verts = parse_obj(path)
    dim = float(np.abs(verts).max()) if verts.size else 0.0
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    mesh = TriangleMesh.build(verts,
                              np.full((verts.shape[0],), mat_id, np.int32),
                              dtype=np_dtype, device=device)
    return mesh, dim


def reference_obj_path(name: str) -> Optional[str]:
    """Path to one of the reference repo's example OBJ assets (cow, teapot,
    cube, ...) in the reference checkout that ``LTS_REFERENCE_ROOT``
    names, if it holds it; None otherwise."""
    root = os.environ.get("LTS_REFERENCE_ROOT")
    if not root:
        return None
    p = os.path.join(root, "light_transport", "examples", "obj", name)
    return p if os.path.exists(p) else None
