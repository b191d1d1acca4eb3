"""Ray-triangle tests K4 issued per live ray of the cluster intersector,
from the program's counters over the profiled frames: the (32-ray warp,
32-triangle group) pairs K4 tested, times 32 x 32, over the rays with a
non-empty interval, nearest-hit and any-hit queries together.  Beside
``isect_tests_per_ray`` (the cull's admitted pairs) it gives the share of
the admitted tests the kernel still issues.  A program that does not
count its groups reads None."""

from ltbench import program_spans

WARP, GROUP_TRIS = 32, 32


def read(record):
    c = program_spans.frame_counts(record)
    if c is None or "groups.nearest" not in c:
        return None
    live = c["live_rays.nearest"] + c["live_rays.any"]
    if not live:
        return None
    return (c["groups.nearest"] + c["groups.any"]) * WARP * GROUP_TRIS / live
