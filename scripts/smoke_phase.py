#!/usr/bin/env python3
"""One phase of chip_smoke.py alone on an NVIDIA GPU, with the same checks.

Usage, from the repository root:

    python3 scripts/smoke_phase.py N [big]

N is a phase from 16 to 22 (``chip_smoke.phaseN``):

* 16: the hard-shadow and point-light presets, Whitted through K3 and
  through the cull with K4, and the analytic sphere;
* 17: transmittance shadows, Sobol' with the thin lens, progressive
  Sobol' passes, the watertight test and the adaptive integrator;
* 18: BDPT over the brute force, K3, the cull with K4 and K5, and the
  control variates;
* 19: the sharded BDPT render, the CLI, the OBJ round trip, the GUI server
  and the profiling helpers;
* 20: the glossy BSDF, the emission modes, the surface detectors and every
  examples_torch driver;
* 21: tail compaction on the brute force, over K3, over the cull with K4
  and over K5;
* 22: the split tracer's ``stack_size`` and ``max_iters`` and the Whitted
  queue's ``weight_cutoff``.

It builds the intersector and treelet kernels and the scenes the phase
takes (the glass preset, and the soft-shadow scene where it takes one),
and runs the phase.  With ``big``, for a phase that has a big-mesh part
(``chip_smoke.phaseN_big``: 16, 17, 18 and 21), it then builds the
4,202,118-triangle scene and runs that part.  Any failed check raises.
The last line is the card's name and power limit.
"""

import inspect
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from light_transport_tpu_torch.ops import _build  # noqa: E402

PHASES = range(16, 23)


def main(argv):
    if not argv or not argv[0].isdigit() or int(argv[0]) not in PHASES \
            or set(argv[1:]) - {"big"}:
        print(__doc__, file=sys.stderr)
        return 2
    n = int(argv[0])
    phase = getattr(cs, f"phase{n}")
    big = getattr(cs, f"phase{n}_big", None) if "big" in argv[1:] else None
    t0 = time.perf_counter()
    names = ["intersect_kernel", "treelet_kernel"]
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    cs.log(2, "built " + ", ".join(names), t0)
    t0 = time.perf_counter()
    scenes = [cs.glass_scene(device=cs.DEV)]
    if len(inspect.signature(phase).parameters) > 1:
        scenes.append(cs.soft_shadow_scene())
    cs.log(8, "scenes built", t0)
    wall = phase(*scenes)
    del scenes
    if big is not None:
        scene, cfg, _ = cs.big_mesh_scene()
        wall += big(scene, cfg)
    cs.log(n, f"phase {n} in all {wall:.2f} s")
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
