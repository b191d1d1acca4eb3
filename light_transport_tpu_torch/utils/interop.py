"""Carry media, tallies, engine state, scenes, uniforms and hits across
from the JAX package.

Every function takes or returns the JAX side as numpy arrays, so this
module needs neither JAX nor the JAX package: tests convert with
``np.asarray`` on their side.

* The JAX tallies keep ``launched`` / ``steps`` as two-word float32
  counters ``hi * 2**16 + lo``; here they are int64.
* Arrays are copied: a tensor never aliases a numpy (or JAX) buffer.
* The JAX kernel state is 9 arrays of shape ``(n_tiles * 64, 128)``; the
  port's is flat ``(lanes,)`` in the same row-major lane order.
* A scene is a dict of dicts of the JAX ``Scene``'s fields: ``mesh``
  (``MESH_FIELDS``, in the BVH-reordered order when the scene has one),
  ``materials``, ``lights``, ``camera`` and optionally ``bvh`` (the flat
  node arrays and fused records of ``BVH_FIELDS``; ``max_leaf`` is read
  back from the leaf record's width) and ``treelet`` (``{"T": ...}``:
  the port's treelet tables are the BVH's records cut into treelets of
  ``T`` nodes).
"""

from __future__ import annotations

import numpy as np
import torch

from light_transport_tpu_torch.accel.bvh import (
    BVH,
    _compute_skip,
    node_records32,
)
from light_transport_tpu_torch.ops.intersect import Hit
from light_transport_tpu_torch.ops.photon_kernel import KernelState
from light_transport_tpu_torch.scene.geometry import MESH_FIELDS, TriangleMesh
from light_transport_tpu_torch.scene.lights import LIGHT_FIELDS, LightTable
from light_transport_tpu_torch.scene.material import (
    MATERIAL_FIELDS,
    MaterialTable,
)
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.scene.scene import Scene
from light_transport_tpu_torch.tally.tallies import PhotonTallies
from light_transport_tpu_torch.transport.photon import PhotonState

COUNTER_BASE = 2 ** 16
MEDIUM_FIELDS = ("mu_a", "mu_s", "mu_t", "g", "n", "z_top", "z_bot",
                 "n_above", "n_below")
TALLY_FIELDS = ("refl_r", "trans_r", "absorb_rz", "specular", "launched",
                "steps", "detector_xy", "absorb_xyz", "absorbed")
_COUNTERS = ("launched", "steps")
_F64 = ("refl_r", "trans_r", "specular", "absorbed")
BVH_FIELDS = ("bounds_min", "bounds_max", "right", "first", "count", "axis",
              "node_rec", "leaf_rec")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def counter_to_int(c) -> int:
    """Exact value of a two-word ``(hi, lo)`` counter."""
    c = np.asarray(c, np.float64)
    return int(c[0]) * COUNTER_BASE + int(c[1])


def int_to_counter(v: int) -> np.ndarray:
    hi, lo = divmod(int(v), COUNTER_BASE)
    return np.asarray([hi, lo], np.float32)


def medium_from_numpy(d: dict, device="cuda") -> LayeredMedium:
    """LayeredMedium from the nine fields of the JAX ``LayeredMedium``."""
    return LayeredMedium(**{
        k: _tensor(d[k], np.float32, device)
        for k in MEDIUM_FIELDS})


def medium_to_numpy(m: LayeredMedium) -> dict:
    return {k: getattr(m, k).cpu().numpy() for k in MEDIUM_FIELDS}


def tallies_from_numpy(d: dict, device="cuda") -> PhotonTallies:
    out = {}
    for k in TALLY_FIELDS:
        if k in _COUNTERS:
            out[k] = torch.tensor(counter_to_int(d[k]), dtype=torch.int64,
                                  device=device)
        else:
            dt = np.float64 if k in _F64 else np.float32
            out[k] = _tensor(d[k], dt, device)
    return PhotonTallies(**out)


def tallies_to_numpy(t: PhotonTallies) -> dict:
    """The JAX field layout: float32 arrays, two-word counters."""
    return {k: (int_to_counter(int(getattr(t, k))) if k in _COUNTERS
                else getattr(t, k).cpu().numpy().astype(np.float32))
            for k in TALLY_FIELDS}


def kernel_state_from_numpy(arrays, device="cuda") -> KernelState:
    """KernelState from the JAX engine's 9 ``(rows, 128)`` state arrays
    (px, py, pz, dx, dy, dz, w, tau, layer)."""
    arrays = list(arrays)
    if len(arrays) != 9:
        raise ValueError(f"expected 9 state arrays, got {len(arrays)}")
    return KernelState(*(
        _tensor(a, np.int32 if i == 8 else np.float32, device).reshape(-1)
        for i, a in enumerate(arrays)))


def kernel_state_to_numpy(state: KernelState, lanes_per_row: int = 128):
    return tuple(t.cpu().numpy().reshape(-1, lanes_per_row) for t in state)


def photon_state_from_numpy(pos, dir, w, layer, tau, alive,
                            device="cuda") -> PhotonState:
    """PhotonState from the superstep engine's arrays."""
    f32 = np.float32
    return PhotonState(
        pos=_tensor(pos, f32, device), dir=_tensor(dir, f32, device),
        w=_tensor(w, f32, device), layer=_tensor(layer, np.int32, device),
        tau=_tensor(tau, f32, device), alive=_tensor(alive, bool, device))


def photon_state_to_numpy(s: PhotonState) -> dict:
    return {k: getattr(s, k).cpu().numpy()
            for k in ("pos", "dir", "w", "layer", "tau", "alive")}


def _tensors(d: dict, fields, device) -> dict:
    return {k: torch.from_numpy(np.array(d[k], copy=True)).to(device)
            for k in fields}


def _arrays(obj, fields) -> dict:
    return {k: getattr(obj, k).cpu().numpy() for k in fields}


def scene_from_numpy(d: dict, device="cuda") -> Scene:
    """Scene from the JAX ``Scene``'s tables (see the module docstring);
    dtypes are kept as given."""
    bvh = None
    if d.get("bvh") is not None:
        b = _tensors(d["bvh"], BVH_FIELDS, device)
        skip = _compute_skip(np.asarray(d["bvh"]["right"]),
                             np.asarray(d["bvh"]["count"]))
        # the leaf record holds 8 * ceil(9 * max_leaf / 8) floats, which is
        # 8 * (max_leaf + 1) for max_leaf <= 8
        bvh = BVH(**b, skip=torch.from_numpy(skip).to(device),
                  node32=node_records32(b["node_rec"]),
                  max_leaf=b["leaf_rec"].shape[1] // 8 - 1)
    scene = Scene(
        mesh=TriangleMesh(**_tensors(d["mesh"], MESH_FIELDS, device)),
        materials=MaterialTable(**_tensors(d["materials"], MATERIAL_FIELDS,
                                           device)),
        lights=LightTable(**_tensors(d["lights"], LIGHT_FIELDS, device)),
        camera=_tensor(d["camera"], np.asarray(d["camera"]).dtype, device),
        bvh=bvh)
    if d.get("treelet") is not None:
        scene = scene.with_treelet(T=int(d["treelet"]["T"]))
    return scene


def scene_to_numpy(scene: Scene) -> dict:
    return {"mesh": _arrays(scene.mesh, MESH_FIELDS),
            "materials": _arrays(scene.materials, MATERIAL_FIELDS),
            "lights": _arrays(scene.lights, LIGHT_FIELDS),
            "camera": scene.camera.cpu().numpy(),
            "bvh": (None if scene.bvh is None
                    else _arrays(scene.bvh, BVH_FIELDS)),
            "treelet": (None if scene.treelet is None
                        else {"T": scene.treelet.T})}


def uniforms_from_numpy(u_aa, uniforms, device="cuda"):
    """The camera jitter ``(N, 2)`` and path uniforms ``(N, depth, NUM_U)``
    as float32 tensors."""
    return (_tensor(u_aa, np.float32, device),
            _tensor(uniforms, np.float32, device))


def hit_from_numpy(t, tri, valid, device="cuda") -> Hit:
    return Hit(t=_tensor(t, np.float32, device),
               tri=_tensor(tri, np.int32, device),
               valid=_tensor(valid, bool, device))


def hit_to_numpy(hit: Hit) -> dict:
    return {k: getattr(hit, k).cpu().numpy() for k in ("t", "tri", "valid")}
