"""Soft shadows from a large area light over a dense mesh, the port of
examples/soft_shadow.py.

The reference's heaviest published workload: a 123,204-triangle scene at
400x400, 10 spp, depth 3, which it renders in 525 s on a CPU.  On the
card the same mesh goes through the cluster cull and the gather kernel
(K4).  Pass --quick for a 200x200x4 spp variant.
"""

import numpy as np

from _torch_common import (
    OUT_DIR,
    parse_args,
    report,
    save_image,
    timed_twice,
    to_numpy,
)

from light_transport_tpu_torch.api import render
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.scene.cornell import sphere_triangles
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

FULL = dict(width=400, height=400, spp=10, max_depth=3)
QUICK = dict(width=200, height=200, spp=4, max_depth=3)


def build_scene(n_theta=176, n_phi=352, device="cuda"):
    sph = sphere_triangles(center=(0, 1, 0), radius=1.5, n_theta=n_theta,
                           n_phi=n_phi)  # 123,200 triangles at the default
    floor = quad_triangles((-8, -0.5, -8), (-8, -0.5, 8), (8, -0.5, 8),
                           (8, -0.5, -8))
    lq = quad_triangles((-1.5, 6, -1.5), (1.5, 6, -1.5), (1.5, 6, 1.5),
                        (-1.5, 6, 1.5))
    mesh = concat_meshes([
        TriangleMesh.build(sph, np.zeros(len(sph), np.int32), device=device),
        TriangleMesh.build(floor, np.asarray([1, 1], np.int32),
                           device=device),
        TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                           np.asarray([True, True]), device=device),
    ])
    mats = MaterialTable.build([
        Material(color=presets.TURQUOISE),
        Material(color=presets.WHITE_2),
        Material(color=presets.WHITE, emission=8.0),
    ], device=device)
    return Scene.build(mesh, mats, camera=[0.0, 1.0, 7.0]).with_bvh()


def run(quick=False, size=None, n_theta=176, n_phi=352, seed=0,
        device="cuda", out_dir=OUT_DIR):
    """``size``, if given, is a dict of width, height, spp and max_depth
    that replaces the full or quick one."""
    scene = build_scene(n_theta, n_phi, device)
    cfg = RenderConfig(**(size or (QUICK if quick else FULL)),
                       f_distance=3.5)
    img, t_first, t_steady = timed_twice(
        lambda: to_numpy(render(scene, cfg, seed=seed)))
    p = save_image(img, "soft_shadow.png", gamma=2.2, out_dir=out_dir)
    return [report("soft_shadow", t_first, steady_seconds=round(t_steady, 3),
                   tris=int(scene.mesh.num_triangles),
                   pixels=cfg.width * cfg.height, spp=cfg.spp,
                   mean=float(img.mean()), image=p,
                   reference_seconds=525.0 if not quick else None)]


def main(argv=None):
    args = parse_args(argv, __doc__, quick=True)
    return run(quick=args.quick, device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
