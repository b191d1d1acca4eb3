#!/usr/bin/env python3
"""Phase 17 of chip_smoke.py alone on an NVIDIA GPU: the path tracer's
transmittance shadows, Sobol' sampler and thin lens, progressive Sobol'
passes, watertight test and adaptive integrator, with the same checks.

Usage, from the repository root:

    python3 scripts/smoke_phase17.py [big]

It builds the intersector and treelet kernels, runs 17a-17e on the glass
preset and the soft-shadow scene, and with ``big`` builds the
4,202,118-triangle scene and renders it with transmittance shadows
(chip_smoke.phase17_big).  Any failed check raises.  The last line is
the card's name and power limit.
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from light_transport_tpu_torch.ops import _build  # noqa: E402


def main():
    t0 = time.perf_counter()
    names = ["intersect_kernel", "treelet_kernel"]
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    cs.log(2, "built " + ", ".join(names), t0)
    glass = cs.glass_scene(device=cs.DEV)
    soft = cs.soft_shadow_scene()
    wall = cs.phase17(glass, soft)
    del glass, soft
    if "big" in sys.argv[1:]:
        scene, cfg, _ = cs.big_mesh_scene()
        wall += cs.phase17_big(scene, cfg)
    cs.log(17, f"phase 17 in all {wall:.2f} s")
    print(cs.smi())


if __name__ == "__main__":
    main()
