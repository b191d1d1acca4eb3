"""Whitted-style ray tracing of the teapot, the port of
examples/ray_tracing.py.

Deterministic primary rays, Phong shading against every light sample,
recursive mirror reflection and refraction (the unrolled tree), and the
hemisphere-sampled indirect diffuse term at the primary hit.  Without
the reference's teapot OBJ (``objio.reference_obj_path`` returns None)
the body is a procedural cone.
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

from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators.whitted import render_whitted
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
from light_transport_tpu_torch.scene.objio import (
    parse_obj,
    reference_obj_path,
)
from light_transport_tpu_torch.scene.scene import Scene


def build_scene(width=192, height=192, max_depth=2, resolution=24,
                device="cuda"):
    path = reference_obj_path("teapot.obj")
    if path is None:  # no reference assets: a procedural cone
        tris = cone_triangles(radius=2.0, height=3.0, center=(0, 1.5, 0),
                              direction=(0.0, -1.0, 0.0),
                              resolution=resolution)
    else:
        tris = parse_obj(path)
    tris = np.asarray(tris, np.float64)
    # centre the body on the view axis: the screen window is fixed at x, y
    # in [-1, 1] at z = f_distance, so the camera sits at y = 0 looking
    # through it
    mid_y = 0.5 * (tris[..., 1].min() + tris[..., 1].max())
    floor_y = tris[..., 1].min() - mid_y
    tris[..., 1] -= mid_y
    body = TriangleMesh.build(tris, np.zeros(len(tris), np.int32),
                              device=device)
    floor = TriangleMesh.build(
        quad_triangles((-20, floor_y, -20), (-20, floor_y, 20),
                       (20, floor_y, 20), (20, floor_y, -20)),
        np.asarray([1, 1], np.int32), device=device)
    lq = quad_triangles((-1.5, 9, -1.5), (1.5, 9, -1.5), (1.5, 9, 1.5),
                        (-1.5, 9, 1.5))
    lights = TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                                np.asarray([True, True]), device=device)
    # Phong materials: shininess sharpens the specular lobe (the default
    # shininess=1 lobe is nearly flat and washes the image to white)
    mats = MaterialTable.build([
        Material(color=presets.BRONZE, shininess=64, reflection=0.3),
        Material(color=presets.WHITE_2, shininess=128),
        Material(color=presets.WHITE, emission=30.0),
    ], device=device)
    mesh = concat_meshes([body, floor, lights])
    # frustum half-width at the model plane = cam_z / (cam_z - f_distance)
    scene = Scene.build(mesh, mats, camera=[0.0, 0.0, 9.0]).with_bvh()
    cfg = RenderConfig(width=width, height=height, spp=1,
                       max_depth=max_depth, f_distance=7.0)
    return scene, cfg


def run(width=192, height=192, max_depth=2, resolution=24,
        indirect_samples=4, seed=0, device="cuda", out_dir=OUT_DIR):
    scene, cfg = build_scene(width, height, max_depth, resolution, device)
    img, t_first, t_steady = timed_twice(lambda: to_numpy(render_whitted(
        scene, cfg, seed, indirect_samples=indirect_samples)))
    p = save_image(img, "ray_tracing_teapot.png", out_dir=out_dir)
    return [report("ray_tracing", t_first, steady_seconds=round(t_steady, 3),
                   tris=int(scene.mesh.num_triangles),
                   mean=float(img.mean()), image=p)]


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
