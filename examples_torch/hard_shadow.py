"""Hard shadows from a tiny emitter, the port of examples/hard_shadow.py.

A cone on a floor lit by a very small area light: the penumbra collapses
and the shadow edge goes hard.  Compare with soft_shadow.py, which
enlarges the emitter.
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
from light_transport_tpu_torch.scene.cornell import cone_triangles
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


def build_scene(light_half_size: float, emission: float, width=200,
                height=200, spp=16, max_depth=2, resolution=48,
                device="cuda"):
    # the scene is centred at y = 0: the camera window is fixed at x, y in
    # [-1, 1] at z = f_distance, so the camera sits at y = 0
    cone_t = cone_triangles(radius=1.5, height=3.5, center=(0.0, 0.0, 0.0),
                            direction=(0.0, 1.0, 0.0), resolution=resolution)
    cone = TriangleMesh.build(cone_t, np.zeros(len(cone_t), np.int32),
                              device=device)
    floor = TriangleMesh.build(
        quad_triangles((-10, -1.75, -10), (-10, -1.75, 10), (10, -1.75, 10),
                       (10, -1.75, -10)),
        np.asarray([1, 1], np.int32), device=device)
    s = light_half_size
    lq = quad_triangles((-s + 3, 7.25, -s), (s + 3, 7.25, -s),
                        (s + 3, 7.25, s), (-s + 3, 7.25, s))
    lights = TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                                np.asarray([True, True]), device=device)
    mats = MaterialTable.build([
        Material(color=presets.TURQUOISE),
        Material(color=presets.WHITE_2),
        Material(color=presets.WHITE, emission=emission),
    ], device=device)
    mesh = concat_meshes([cone, floor, lights])
    # frustum half-width at the cone plane: 12 / (12 - 9.6) = 5 world units
    scene = Scene.build(mesh, mats, camera=[0.0, 0.0, 12.0]).with_bvh()
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth, f_distance=9.6)
    return scene, cfg


def run(width=200, height=200, spp=16, max_depth=2, resolution=48, seed=0,
        device="cuda", out_dir=OUT_DIR):
    # emission scales as 1/area so total light power stays comparable
    scene, cfg = build_scene(0.12, 5000.0, width, height, spp, max_depth,
                             resolution, device)
    img, t_first, t_steady = timed_twice(
        lambda: to_numpy(render(scene, cfg, seed=seed)))
    p = save_image(img, "hard_shadow.png", gamma=2.2, out_dir=out_dir)
    return [report("hard_shadow", t_first,
                   steady_seconds=round(t_steady, 3),
                   mean=float(img.mean()), image=p)]


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
