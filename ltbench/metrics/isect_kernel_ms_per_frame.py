"""Device time a frame of the intersector's hand-written kernels, the
``kernels`` of the spans of group ``isect_kernel`` (``intersect_dense``,
``tile_cull``, ``intersect_gather``, ``treelet_walk``,
``treelet_resume``), from the profiler."""


def read(record):
    isect = set(record["isect_kernels"])
    ops = [o for o in record["trace"]["ops"] if o["kernel"] in isect]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / record["frames"]
