"""Refraction through a whisky glass (glass, liquid and ice, iors
1.5/1.356/1.310), the port of examples/refraction.py.

The procedurally designed tumbler under an area light, path-traced so the
transmissive chains (air -> glass -> whisky -> glass -> air) resolve by
stochastic Fresnel reflect-or-refract at every interface.
"""

from _torch_common import (
    OUT_DIR,
    parse_args,
    report,
    save_image,
    timed_twice,
    to_numpy,
)

from light_transport_tpu_torch.api import render
from light_transport_tpu_torch.models.presets import glass_scene


def run(width=160, height=160, spp=32, max_depth=6, seed=0, device="cuda",
        out_dir=OUT_DIR):
    scene, cfg = glass_scene(width=width, height=height, spp=spp,
                             max_depth=max_depth, device=device)
    img, t_first, t_steady = timed_twice(
        lambda: to_numpy(render(scene, cfg, seed=seed)))
    p = save_image(img, "refraction_glass.png", gamma=2.2, out_dir=out_dir)
    return [report("refraction", t_first, steady_seconds=round(t_steady, 3),
                   tris=int(scene.mesh.num_triangles),
                   mean=float(img.mean()), image=p)]


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
