"""CUDA kernel launches a frame, counted in the profiled frames (copies
and fills left out)."""


def read(record):
    ops = record["trace"]["ops"]
    if not ops:
        return None
    return sum(o["cat"] == "kernel" for o in ops) / record["frames"]
