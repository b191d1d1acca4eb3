"""The flagship Cornell-box path trace and control-variates pipeline, the
port of examples/lts_cornell.py.

Renders the Cornell box (red and green walls, glass cone, ceiling area
light) with the NEE path tracer, then the control-variates pass: the
plain image, the CV-corrected image, and 500 fresh samples at four
hand-picked pixels (render_cv and cv_pixel_dive, exact scores by
torch.autograd).
"""

import numpy as np

from _torch_common import (
    OUT_DIR,
    parse_args,
    report,
    save_image,
    timed_twice,
    timer,
    to_numpy,
)

from light_transport_tpu_torch.integrators.control_variates import (
    cv_pixel_dive,
    render_cv,
)
from light_transport_tpu_torch.scene.cornell import cornell_box_scene

PIXELS = ((40, 40), (40, 110), (110, 40), (110, 110))


def run(width=150, height=150, spp=12, max_depth=4, pixels=PIXELS,
        n_samples=500, seed=0, dive_seed=1, device="cuda", out_dir=OUT_DIR):
    scene, cfg = cornell_box_scene(width=width, height=height, spp=spp,
                                   max_depth=max_depth, device=device)

    out, t_first, t_steady = timed_twice(lambda: render_cv(scene, cfg, seed))
    plain = to_numpy(out.image_plain)
    cv = to_numpy(out.image_cv)
    var_plain = to_numpy(out.samples).var(axis=2).mean()
    p1 = save_image(plain, "lts_cornell_plain.png", out_dir=out_dir)
    p2 = save_image(cv, "lts_cornell_cv.png", out_dir=out_dir)
    lines = [report("lts_cornell", t_first,
                    steady_seconds=round(t_steady, 3),
                    mean_plain=float(plain.mean()), mean_cv=float(cv.mean()),
                    sample_variance=float(var_plain), images=[p1, p2])]

    # the reference's extra pass: fresh samples at the chosen pixels
    with timer() as t:
        dive = cv_pixel_dive(scene, cfg, dive_seed, pixels,
                             n_samples=n_samples)
        samples, corrected = to_numpy(dive.samples), to_numpy(dive.corrected)
    for k, (r, c) in enumerate(pixels):
        s, cvs = samples[k], corrected[k]
        print(f"pixel ({r},{c}): plain {s.mean(0).round(4)} "
              f"var {s.var(0).mean():.5f} -> cv var {cvs.var(0).mean():.5f}")
    lines.append(report("lts_cornell_pixel_dive", t.seconds))
    return lines


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
