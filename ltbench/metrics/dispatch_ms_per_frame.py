"""Device time a frame of the kernels launched inside the dispatch's
spans (``dispatch.scene_intersect``, ``dispatch.scene_occluded``), less
the intersector's hand-written kernels: the coherence sort, gathers,
ray features, key unpacking."""


def read(record):
    isect = set(record["isect_kernels"])
    ops = [o for o in record["trace"]["ops"]
           if o["cat"] == "kernel" and "dispatch" in o["groups"]
           and o["kernel"] not in isect]
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / 1e3 / record["frames"]
