"""Bidirectional path tracing on the Cornell box, the port of
examples/bdpt_cornell.py.

Camera and light subpaths, all (s, t) connection strategies with
balance-heuristic MIS, including t=1 light-tracing splats onto the film,
which render the caustic under the glass cone that the unidirectional
path tracer hardly ever finds.  Prints the path tracer's and BDPT's image
means side by side (the unbiasedness cross-check of tests/test_bdpt.py).
"""

from _torch_common import (
    OUT_DIR,
    parse_args,
    report,
    save_image,
    timed_twice,
    to_numpy,
)

from light_transport_tpu_torch.integrators.bdpt import render_bdpt
from light_transport_tpu_torch.integrators.path_tracer import render_image
from light_transport_tpu_torch.scene.cornell import cornell_box_scene


def run(width=96, height=96, spp=16, max_depth=4, seed=0, bdpt_seed=1,
        device="cuda", out_dir=OUT_DIR):
    scene, cfg = cornell_box_scene(width=width, height=height, spp=spp,
                                   max_depth=max_depth, device=device)

    img_pt, t_first, t_steady = timed_twice(
        lambda: to_numpy(render_image(scene, cfg, seed)))
    lines = [report("path_tracer", t_first,
                    steady_seconds=round(t_steady, 3),
                    mean=float(img_pt.mean()))]

    img_bd, t_first, t_steady = timed_twice(lambda: to_numpy(
        render_bdpt(scene, cfg, bdpt_seed, light_tracing=True)))
    lines.append(report("bdpt_light_tracing", t_first,
                        steady_seconds=round(t_steady, 3),
                        mean=float(img_bd.mean()),
                        pt_mean=float(img_pt.mean()),
                        abs_mean_diff=float(abs(img_bd.mean()
                                                - img_pt.mean()))))

    save_image(img_pt, "bdpt_cornell_pt.png", out_dir=out_dir)
    save_image(img_bd, "bdpt_cornell_bdpt.png", out_dir=out_dir)
    return lines


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
