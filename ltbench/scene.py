"""A configuration's scene as plain arrays: the triangles, their
materials and light flags, the material rows and the camera.  Both sides
start from these: the program's entry hands them to its own scene
builder, and the reference computes its tables from them itself.  Imports
nothing of the program."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# every field of a material row, as the configuration files spell them
MATERIAL_KEYS = ("ambient", "diffuse", "specular", "shininess",
                 "reflection", "ior", "emission", "emission_color",
                 "transmission", "is_diffuse", "is_mirror", "sigma_a",
                 "sigma_s", "medium_g", "is_glossy")


class SceneArrays(NamedTuple):
    vertices: np.ndarray  # (T, 3, 3) float64
    mat_id: np.ndarray  # (T,) int32
    is_light: np.ndarray  # (T,) bool
    materials: list  # dicts with MATERIAL_KEYS
    camera: np.ndarray  # (3,) float64


def scene_arrays(registry, config: dict) -> SceneArrays:
    """The configuration's ``shapes`` in order, each built by
    ``shapes/<shape>.py``, with its ``material`` and ``light`` flag."""
    verts, mats, lights = [], [], []
    for spec in config["shapes"]:
        tris = registry.module("shapes", spec["shape"]).triangles(spec)
        verts.append(tris)
        mats.append(np.full(len(tris), int(spec["material"]), np.int32))
        lights.append(np.full(len(tris), bool(spec.get("light", False))))
    for m in config["materials"]:
        missing = [k for k in MATERIAL_KEYS if k not in m]
        if missing:
            raise ValueError(f"material {m.get('name')!r} lacks {missing}")
    return SceneArrays(np.concatenate(verts), np.concatenate(mats),
                       np.concatenate(lights), list(config["materials"]),
                       np.asarray(config["camera"], np.float64))


def render_settings(config: dict, traffic: dict) -> dict:
    """Every render setting of a cell: the configuration's frame
    (``width``, ``height``, ``spp``, ``f_distance``) and the traffic's
    path settings; each is stated in the files, none is a default."""
    out = dict(config["render"])
    out.update(traffic["render"])
    return out
