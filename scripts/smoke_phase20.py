#!/usr/bin/env python3
"""Phase 20 of chip_smoke.py alone on an NVIDIA GPU: the glossy BSDF and
the emission modes over K3 and the cull with K4, the surface detectors,
and every examples_torch driver at the JAX drivers' sizes, with the same
checks.

Usage, from the repository root:

    python3 scripts/smoke_phase20.py

It builds the intersector kernels, builds the glass preset and the
soft-shadow scene, and runs 20a-20c (chip_smoke.phase20).  Any failed
check raises.  The last line is the card's name and power limit.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from light_transport_tpu_torch.ops import _build  # noqa: E402


def main():
    t0 = time.perf_counter()
    _build.build("intersect_kernel")
    cs.log(2, "built intersect_kernel", t0)
    t0 = time.perf_counter()
    glass = cs.glass_scene(device=cs.DEV)
    soft = cs.soft_shadow_scene()
    cs.log(8, "scenes built", t0)
    cs.phase20(glass, soft)
    print(cs.smi())


if __name__ == "__main__":
    main()
