"""Sampler A/B: independent uniforms against Owen-scrambled Sobol'
(ops/qmc.py), the port of examples/sampler_compare.py.

Renders the Cornell parity scene at equal spp with both samplers,
measures each image's MSE against a high-spp reference, and shows the
progressive-QMC property: offset passes continue one point set, so
quality keeps compounding across passes.

Artifacts: sampler_uniform.png, sampler_sobol.png and a JSON line with
the MSEs.
"""

import dataclasses

from _torch_common import (
    OUT_DIR,
    parse_args,
    report,
    save_image,
    timer,
    to_numpy,
)

from light_transport_tpu_torch.integrators.path_tracer import (
    render_image,
    render_progressive,
)
from light_transport_tpu_torch.scene.cornell import cornell_box_scene


def run(width=96, height=96, spp=16, max_depth=3, ref_passes=64, seed=0,
        ref_seed=999, device="cuda", out_dir=OUT_DIR):
    scene, cfg = cornell_box_scene(width=width, height=height, spp=spp,
                                   max_depth=max_depth, device=device)
    ref = to_numpy(render_progressive(scene, cfg, ref_seed,
                                      n_passes=ref_passes))

    out = {}
    for sampler in ["uniform", "sobol"]:
        c = dataclasses.replace(cfg, sampler=sampler)
        with timer() as t:
            img = to_numpy(render_image(scene, c, seed))
        out[sampler] = {"mse": float(((img - ref) ** 2).mean()),
                        "seconds": round(t.seconds, 3)}
        save_image(img, f"sampler_{sampler}.png", out_dir=out_dir)

    # progressive Sobol': 4 offset passes of spp/4 each, one continued
    # point set, matching the one-shot Sobol' image up to the per-pass clip
    c = dataclasses.replace(cfg, sampler="sobol", spp=cfg.spp // 4)
    prog = to_numpy(render_progressive(scene, c, seed, n_passes=4))
    out["sobol_progressive_4x"] = {"mse": float(((prog - ref) ** 2).mean())}

    return [report("sampler_compare", out["uniform"]["seconds"],
                   spp=cfg.spp, uniform_mse=out["uniform"]["mse"],
                   sobol_mse=out["sobol"]["mse"],
                   sobol_progressive_mse=out["sobol_progressive_4x"]["mse"],
                   mse_ratio=round(out["uniform"]["mse"]
                                   / out["sobol"]["mse"], 3))]


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
