"""Thin-lens depth of field A/B on the Cornell parity scene, the port of
examples/dof_compare.py.

Renders the LTS Cornell + cone scene three ways (pinhole, the lens
focused on the cone, the lens focused just in front of the camera) and
reports per-region MSE against the pinhole image.  With the Sobol'
sampler the lens point rides its own pair (ops/qmc.LENS_PAIR), so every
other random decision is identical across the three renders: the MSEs
measure the lens geometry, not Monte Carlo noise.

Artifacts: dof_{pinhole,focus_cone,focus_near}.png.
"""

import dataclasses

import numpy as np

from _torch_common import (
    OUT_DIR,
    parse_args,
    report,
    save_image,
    timer,
    to_numpy,
)

from light_transport_tpu_torch.api import render
from light_transport_tpu_torch.scene.cornell import cornell_box_scene

VARIANTS = {
    "pinhole": {},
    "focus_cone": {"aperture": 0.35, "focus_distance": 8.0},
    "focus_near": {"aperture": 0.35, "focus_distance": 2.5},
}


def _region_mse(img, ref):
    """MSE against the pinhole image over the center (the cone) and the
    image border (walls off the focal plane)."""
    d2 = ((np.asarray(img, np.float32) - ref) ** 2).mean(axis=-1)
    h, w = d2.shape
    center = d2[h // 3: 2 * h // 3, w // 3: 2 * w // 3].mean()
    border = np.ones((h, w), bool)
    border[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = False
    return float(center), float(d2[border].mean())


def run(width=150, height=150, spp=32, max_depth=3, seed=0, device="cuda",
        out_dir=OUT_DIR):
    # the camera sits at z = dim + 0.5 = 8; the cone's axis is at the box
    # center, ~8 world units away: focusing there keeps the subject sharp,
    # focusing at 2.5 defocuses everything
    scene, cfg = cornell_box_scene(width=width, height=height, spp=spp,
                                   max_depth=max_depth, device=device)
    cfg = dataclasses.replace(cfg, sampler="sobol")
    images, secs = {}, {}
    for name, over in VARIANTS.items():
        c = dataclasses.replace(cfg, **over)
        with timer() as t:
            images[name] = to_numpy(render(scene, c, seed=seed))
        secs[name] = round(t.seconds, 3)
        save_image(images[name], f"dof_{name}.png", out_dir=out_dir)

    ref = np.asarray(images["pinhole"], np.float32)
    out = {}
    for name in ("focus_cone", "focus_near"):
        c_mse, b_mse = _region_mse(images[name], ref)
        out[f"{name}_center_mse"] = round(c_mse, 6)
        out[f"{name}_border_mse"] = round(b_mse, 6)
    return [report("dof_compare", secs["pinhole"], **out)]


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
