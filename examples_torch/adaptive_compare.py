"""Adaptive sampling A/B on the glass scene (integrators/adaptive.py), the
port of examples/adaptive_compare.py.

Equal total budget (H*W*spp paths), uniform against variance-driven
allocation, MSE against a high-spp reference.  The glass tumbler
concentrates variance in its specular and refracted pixels, which is
where the adaptive rounds steer the budget; the artifacts include the
per-pixel sample-density map beside the renders.
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

from light_transport_tpu_torch.integrators.adaptive import render_adaptive
from light_transport_tpu_torch.integrators.path_tracer import (
    render_image,
    render_progressive,
)
from light_transport_tpu_torch.models import presets as P


def run(width=96, height=96, spp=16, max_depth=5, rounds=4, ref_passes=48,
        seed=0, ref_seed=999, device="cuda", out_dir=OUT_DIR):
    scene, cfg = P.PRESETS["glass"](device=device)
    cfg = dataclasses.replace(cfg, width=width, height=height, spp=spp,
                              max_depth=max_depth)
    ref = to_numpy(render_progressive(scene, cfg, ref_seed,
                                      n_passes=ref_passes))

    with timer() as t_u:
        img_u = to_numpy(render_image(scene, cfg, seed))
    with timer() as t_a:
        img_a, counts = render_adaptive(scene, cfg, seed, rounds=rounds,
                                        return_counts=True)
        img_a, counts = to_numpy(img_a), to_numpy(counts)

    save_image(img_u, "adaptive_off.png", out_dir=out_dir)
    save_image(img_a, "adaptive_on.png", out_dir=out_dir)
    # sample-density map (log scale: allocation spans orders of magnitude)
    dens = np.log1p(counts.astype(np.float32))
    save_image(np.repeat((dens / dens.max())[..., None], 3, -1),
               "adaptive_density.png", out_dir=out_dir)

    mse_u = float(((img_u - ref) ** 2).mean())
    mse_a = float(((img_a - ref) ** 2).mean())
    return [report("adaptive_compare", t_a.seconds, spp=cfg.spp,
                   uniform_mse=mse_u, adaptive_mse=mse_a,
                   mse_ratio=round(mse_u / mse_a, 3),
                   uniform_seconds=round(t_u.seconds, 3),
                   counts_min=int(counts.min()),
                   counts_max=int(counts.max()))]


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
