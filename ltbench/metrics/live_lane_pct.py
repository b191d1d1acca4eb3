"""The share of the path tracer's lanes that carry a live ray, in %: the
rays with a non-empty interval in the cluster intersector's nearest-hit
queries over the lane width of every bounce, from the program's counters
over the profiled frames."""

from ltbench import program_spans


def read(record):
    c = program_spans.frame_counts(record)
    if c is None or not c["live_rays.nearest"] or not c["bounce_lanes"]:
        return None
    return 100.0 * c["live_rays.nearest"] / c["bounce_lanes"]
