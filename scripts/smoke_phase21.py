#!/usr/bin/env python3
"""Phase 21 of chip_smoke.py alone on an NVIDIA GPU: tail compaction
(``RenderConfig.compact_tail``) on the brute force, over K3, over the cull
with K4 and over K5, with the same checks.

Usage, from the repository root:

    python3 scripts/smoke_phase21.py [big]

It builds the intersector and treelet kernels, builds the glass preset and
the soft-shadow scene and runs 21a-21c (chip_smoke.phase21); with ``big``
it builds the 4,202,118-triangle scene and runs 21d
(chip_smoke.phase21_big).  Any failed check raises.  The last line is the
card's name and power limit.
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
    wall = cs.phase21(glass, soft)
    del glass, soft
    if "big" in sys.argv[1:]:
        scene, cfg, _ = cs.big_mesh_scene()
        wall += cs.phase21_big(scene, cfg)
    cs.log(21, f"phase 21 in all {wall:.2f} s")
    print(cs.smi())


if __name__ == "__main__":
    main()
