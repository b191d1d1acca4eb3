#!/usr/bin/env python3
"""Phase 18 of chip_smoke.py alone on an NVIDIA GPU: BDPT over the brute
force, K3, the cull with K4 and K5, and the control variates, with the
same checks.

Usage, from the repository root:

    python3 scripts/smoke_phase18.py [big]

It builds the intersector and treelet kernels, runs 18a-18d and 18f on
the Cornell box, the point-light scenes, the glass preset and the
soft-shadow scene, and with ``big`` builds the 4,202,118-triangle scene
and renders it by BDPT (chip_smoke.phase18_big).  Any failed check
raises.  The last line is the card's name and power limit.
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
    wall = cs.phase18(glass, soft)
    del glass, soft
    if "big" in sys.argv[1:]:
        scene, cfg, _ = cs.big_mesh_scene()
        wall += cs.phase18_big(scene, cfg)
    cs.log(18, f"phase 18 in all {wall:.2f} s")
    print(cs.smi())


if __name__ == "__main__":
    main()
