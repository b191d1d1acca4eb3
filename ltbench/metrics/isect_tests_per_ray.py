"""Ray-triangle tests a live ray of the cluster intersector, from the
program's counters over the profiled frames: the (128-ray tile,
512-triangle cluster) pairs the cull admitted, times 128 x 512, over the
rays with a non-empty interval, nearest-hit and any-hit queries together.
A cull or sort that admits fewer pairs lowers it; a faster K4 does not."""

from ltbench import program_spans

RAY_TILE, TRI_TILE = 128, 512


def read(record):
    c = program_spans.frame_counts(record)
    if c is None:
        return None
    live = c["live_rays.nearest"] + c["live_rays.any"]
    if not live:
        return None
    return (c["pairs.nearest"] + c["pairs.any"]) * RAY_TILE * TRI_TILE / live
