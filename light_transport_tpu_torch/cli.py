"""Command-line front end.

The counterpart of ``light_transport_tpu.cli``: render the demo scenes
and run photon simulations.  Every command runs on the card unless given
``--device cpu``.

    python -m light_transport_tpu_torch.cli render --preset lts --out img.png
    python -m light_transport_tpu_torch.cli simulate --preset demo
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to build and run on (default cuda; "
                        "cpu runs the plain versions of the kernels)")


def _add_render(sub):
    p = sub.add_parser("render", help="render a camera image")
    p.add_argument("--preset", default="lts",
                   choices=["lts", "glass", "mesh", "point"])
    p.add_argument("--integrator", default="path",
                   choices=["path", "adaptive", "whitted", "bdpt", "cv"])
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int)
    p.add_argument("--max-depth", type=int, dest="max_depth")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampler", choices=["uniform", "sobol"],
                   help="random-input construction for the path tracer "
                        "(sobol = padded Owen-scrambled QMC, ops/qmc.py)")
    p.add_argument("--emission-mode", dest="emission_mode",
                   choices=["first_hit", "always", "nee", "mis"],
                   help="light-hit scoring rule (mis = power-heuristic "
                        "NEE<->BSDF combination; see RenderConfig)")
    p.add_argument("--aperture", type=float,
                   help="thin-lens radius for depth of field (0 = pinhole)")
    p.add_argument("--focus", type=float, dest="focus_distance",
                   help="in-focus plane distance from the camera")
    p.add_argument("--sharded", action="store_true",
                   help="shard lanes over the mesh (parallel.mesh)")
    p.add_argument("--preview", action="store_true",
                   help="also write an HTML index next to --out with the "
                        "image embedded plus scene/config stats and "
                        "variant commands (for a live server run python "
                        "-m light_transport_tpu_torch.gui)")
    p.add_argument("--out", default="render.png")
    _add_device(p)


def _add_simulate(sub):
    p = sub.add_parser("simulate", help="run the photon transport engine")
    p.add_argument("--preset", default="demo",
                   choices=["demo", "multilayer", "full_scale"])
    p.add_argument("--photons", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--checkpoint", help="npz path for resumable runs")
    _add_device(p)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="light_transport_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_render(sub)
    _add_simulate(sub)
    args = parser.parse_args(argv)

    from light_transport_tpu_torch.models import presets as P
    from light_transport_tpu_torch.utils.png import write_png

    if args.cmd == "render":
        scene, cfg = P.PRESETS[args.preset](device=args.device)
        overrides = {
            k: getattr(args, k)
            for k in ("width", "height", "spp", "max_depth", "sampler",
                      "aperture", "focus_distance", "emission_mode")
            if getattr(args, k) is not None
        }
        if args.emission_mode and args.integrator not in (
                "path", "adaptive", "cv"):
            parser.error(
                f"--emission-mode applies to the path-tracer family only "
                f"(got --integrator {args.integrator})")
        if args.sampler == "sobol" and args.integrator not in (
                "path", "adaptive"):
            parser.error(
                f"--sampler sobol applies to the path tracer only "
                f"(got --integrator {args.integrator})")
        if args.aperture and args.integrator not in ("path", "adaptive",
                                                     "cv"):
            parser.error(
                f"--aperture applies to the path/adaptive/cv integrators "
                f"only (got --integrator {args.integrator})")
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if args.sharded and args.integrator not in ("path", "bdpt"):
            parser.error(
                f"--sharded renders with the path tracer or bdpt only "
                f"(got --integrator {args.integrator})")
        t0 = time.time()
        img = render_image(scene, cfg, args.seed, args.integrator,
                           args.sharded).cpu().numpy()
        dt = time.time() - t0
        print(f"rendered {img.shape[1]}x{img.shape[0]} in {dt:.2f}s "
              f"(integrator={args.integrator}, spp={cfg.spp}, "
              f"depth={cfg.max_depth})")
        print(f"wrote {write_png(args.out, img)}")
        if args.preview:
            idx = _write_preview(args.out, img, scene, cfg, args, dt)
            print(f"wrote {idx}")
        return 0

    if args.cmd == "simulate":
        medium, cfg = P.PRESETS[args.preset](device=args.device)
        if args.photons:
            cfg = dataclasses.replace(cfg, n_photons=args.photons)
        if args.checkpoint and args.sharded:
            parser.error("--checkpoint and --sharded are mutually "
                         "exclusive (resumable runs are single-device)")
        t0 = time.time()
        if args.checkpoint:
            from light_transport_tpu_torch.utils.checkpoint import (
                simulate_resumable,
            )

            res = simulate_resumable(medium, cfg, args.seed, args.checkpoint)
        elif args.sharded:
            from light_transport_tpu_torch.parallel.mesh import (
                simulate_sharded,
            )

            res = simulate_sharded(medium, cfg, args.seed)
        else:
            from light_transport_tpu_torch.api import simulate

            res = simulate(medium, cfg, seed=args.seed)
        print(json.dumps(simulate_summary(res, t0)))
        return 0
    return 1


def render_image(scene, cfg, seed: int, integrator: str,
                 sharded: bool = False):
    """The image ``(H, W, 3)`` of one CLI or GUI render: ``cv`` through
    ``control_variates.render_cv(...).image_cv``, ``sharded`` through
    ``parallel.mesh.render_sharded`` (the path tracer) or
    ``render_bdpt_sharded``, everything else through ``api.render``."""
    if integrator == "cv":
        from light_transport_tpu_torch.integrators.control_variates import (
            render_cv,
        )

        return render_cv(scene, cfg, seed).image_cv
    if sharded and integrator == "bdpt":
        from light_transport_tpu_torch.parallel.mesh import (
            render_bdpt_sharded,
        )

        return render_bdpt_sharded(scene, cfg, seed)
    if sharded:
        from light_transport_tpu_torch.parallel.mesh import render_sharded

        return render_sharded(scene, cfg, seed)
    from light_transport_tpu_torch.api import render

    return render(scene, cfg, seed=seed, integrator=integrator)


def simulate_summary(res, t0: float) -> dict:
    """The JSON line of ``simulate`` (JAX's keys) for a run started at
    ``time.time() == t0``; the clock stops after the tallies are read,
    which waits for the device."""
    out = {
        "photons": res.n_launched,
        "seconds": None,
        "R_specular": res.specular_reflectance(),
        "R_diffuse": res.total_reflectance(),
        "A": res.total_absorption(),
        "T": res.total_transmittance(),
        "energy": res.energy_total(),
        "steps": res.n_steps,
    }
    out["seconds"] = time.time() - t0
    return out


def _write_preview(out_path, img, scene, cfg, args, elapsed_s):
    """Self-contained HTML index for ``render --preview``: the image
    (base64-embedded, so the file works anywhere), the stats panel the
    reference's Streamlit app surfaces after a render (elapsed, triangle
    count, app.py:253-256), and ready-to-run variant commands.  The live
    form-driven equivalent is ``python -m light_transport_tpu_torch.gui``."""
    import base64
    import html as _html
    import os

    from light_transport_tpu_torch.utils.png import encode_png

    img_tag = ('<img src="data:image/png;base64,'
               + base64.b64encode(encode_png(img)).decode()
               + '" width="480">')
    stats = {
        "preset": args.preset,
        "integrator": args.integrator,
        "size": f"{cfg.width}x{cfg.height}",
        "spp": cfg.spp,
        "max_depth": cfg.max_depth,
        "seed": args.seed,
        "triangles": int(scene.mesh.v0.shape[0]),
        "elapsed_s": round(elapsed_s, 2),
        "image_mean": round(float(img.mean()), 4),
    }
    rows = "".join(
        f"<tr><th>{_html.escape(str(k))}</th>"
        f"<td>{_html.escape(str(v))}</td></tr>" for k, v in stats.items())
    base = "python -m light_transport_tpu_torch.cli render"
    variants = "".join(
        f"<li><code>{_html.escape(v)}</code></li>" for v in (
            f"{base} --preset {args.preset} --integrator {args.integrator} "
            f"--spp {cfg.spp * 4} --preview",
            f"{base} --preset {args.preset} --integrator bdpt --preview",
            f"{base} --preset {args.preset} --sampler sobol --preview",
            "python -m light_transport_tpu_torch.gui  # live form-driven "
            "panel",
        ))
    page = (
        "<!doctype html><html><head><title>light_transport_tpu_torch "
        "preview</title><style>body{font-family:system-ui,sans-serif;"
        "margin:2rem;max-width:60rem}table{border-collapse:collapse}td,th"
        "{padding:.2rem .8rem;border:1px solid #ddd;text-align:left}img{"
        "image-rendering:pixelated;border:1px solid #888}</style></head>"
        f"<body><h1>light_transport_tpu_torch render</h1>{img_tag}"
        f"<h2>Stats</h2><table>{rows}</table>"
        f"<h2>Variants</h2><ul>{variants}</ul></body></html>")
    idx = os.path.splitext(out_path)[0] + ".html"
    with open(idx, "w") as f:
        f.write(page)
    return idx


if __name__ == "__main__":
    sys.exit(main())
