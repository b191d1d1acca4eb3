"""Point (delta) lights: the Cornell box under a point source, the port of
examples/point_light.py.

The path tracer adds the exact delta-light direct term f I cos / r^2 V
(no pdf: BSDF sampling cannot hit a delta light), Whitted Phong-shades
toward the position, and BDPT starts its light walks at the point.  The
hallmark of a point source is the hard shadow.  Artifacts:
point_light_path.png, point_light_whitted.png, point_light_bdpt.png,
area_light_path.png (the same box under its area panel) and
mixed_light_bdpt.png (the panel and the point in one render).
"""

from _torch_common import (
    OUT_DIR,
    parse_args,
    report,
    save_image,
    timer,
    to_numpy,
)

from light_transport_tpu_torch.api import render
from light_transport_tpu_torch.models.presets import point_light_scene
from light_transport_tpu_torch.scene.cornell import cornell_box_scene


def run(width=192, height=192, spp=16, max_depth=4, seed=0, device="cuda",
        out_dir=OUT_DIR):
    scene, cfg = point_light_scene(width=width, height=height, spp=spp,
                                   max_depth=max_depth, device=device)
    area_scene, area_cfg = cornell_box_scene(width=width, height=height,
                                             spp=spp, max_depth=max_depth,
                                             device=device)
    # the mixed family: the area panel and the point light in one render;
    # the light walks pick their origin family per lane by power
    mixed_scene = area_scene.with_point_lights([[0.0, 3.0, 0.0]],
                                               [[40.0, 40.0, 40.0]])
    renders = (
        ("path", scene, cfg, "path", "point_light_path.png"),
        ("whitted", scene, cfg, "whitted", "point_light_whitted.png"),
        ("bdpt", scene, cfg, "bdpt", "point_light_bdpt.png"),
        ("area_path", area_scene, area_cfg, "path", "area_light_path.png"),
        ("mixed_bdpt", mixed_scene, area_cfg, "bdpt",
         "mixed_light_bdpt.png"),
    )
    out = {}
    for key, s, c, integrator, png in renders:
        with timer() as t:
            img = to_numpy(render(s, c, seed=seed, integrator=integrator))
        save_image(img, png, out_dir=out_dir)
        out[key] = {"seconds": round(t.seconds, 3), "mean": float(img.mean())}
    return [report("point_light", sum(v["seconds"] for v in out.values()),
                   **out)]


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
