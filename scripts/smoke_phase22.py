#!/usr/bin/env python3
"""Phase 22 of chip_smoke.py alone on an NVIDIA GPU: the split tracer's
``stack_size`` and ``max_iters`` and the Whitted queue's
``weight_cutoff`` on the glass preset over K3, with the same checks.

Usage, from the repository root:

    python3 scripts/smoke_phase22.py

It builds the intersector kernels and the glass preset and runs 22a-22c
(chip_smoke.phase22).  Any failed check raises.  The last line is the
card's name and power limit.
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
    cs.phase22(cs.glass_scene(device=cs.DEV))
    print(cs.smi())


if __name__ == "__main__":
    main()
