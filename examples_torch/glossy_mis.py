"""Glossy BSDF and MIS: the Veach tilted-plate regime, the port of
examples/glossy_mis.py.

A 45-degree tilted glossy (modified-Phong) plate reflects the camera
straight into an overhead area light, so every plate pixel is a
specular highlight.  At equal spp, NEE's light sampling almost never
lands inside the cos^n lobe's footprint: its rare hits are spikes that
clip, leaving a near-black image, while ``emission_mode="mis"`` routes
those pixels through BSDF sampling by the power heuristic.  The plate is
``models/presets.glossy_plate_scene``.

Artifacts: glossy_nee.png, glossy_mis.png, glossy_truth.png and a JSON
line with the RMSEs against the converged truth.
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

from light_transport_tpu_torch.integrators.path_tracer import render_image
from light_transport_tpu_torch.models.presets import glossy_plate_scene


def run(width=96, height=96, spp=16, max_depth=3, shininess=400.0,
        truth_spp=64, truth_seeds=4, truth_seed=100, seed=0, device="cuda",
        out_dir=OUT_DIR):
    scene, cfg = glossy_plate_scene(width=width, height=height, spp=spp,
                                    max_depth=max_depth,
                                    shininess=shininess, device=device)
    # converged display truth: the raw sample mean over many passes,
    # clipped once (the spp -> inf limit of the clip-of-mean display)
    tr = dataclasses.replace(cfg, spp=truth_spp, emission_mode="mis")
    acc = None
    for sd in range(truth_seeds):
        _, s = render_image(scene, tr, truth_seed + sd, return_samples=True)
        m = to_numpy(s).astype(np.float64).mean(axis=2)
        acc = m if acc is None else acc + m
    truth = np.clip(acc / truth_seeds, 0.0, 1.0)
    save_image(truth, "glossy_truth.png", out_dir=out_dir)

    out = {}
    for mode in ("nee", "mis"):
        c = dataclasses.replace(cfg, emission_mode=mode)
        with timer() as t:
            img = to_numpy(render_image(scene, c, seed))
        save_image(img, f"glossy_{mode}.png", out_dir=out_dir)
        out[mode] = {
            "rmse_vs_truth": float(np.sqrt(((img - truth) ** 2).mean())),
            "display_mean": float(img.mean()),
            "seconds": round(t.seconds, 3),
        }
    return [report("glossy_mis",
                   out["nee"]["seconds"] + out["mis"]["seconds"],
                   truth_mean=float(truth.mean()),
                   rmse_ratio=out["nee"]["rmse_vs_truth"]
                   / max(out["mis"]["rmse_vs_truth"], 1e-30), **out)]


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
